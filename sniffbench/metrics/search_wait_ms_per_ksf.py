"""`p3_join` span: the host waiting for the search's fused words
(`_phase3`), ms per 1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "p3_join")
