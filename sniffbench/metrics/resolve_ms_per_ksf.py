"""`resolve` span: the host resolve of each subframe's candidates, ms per
1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "resolve")
