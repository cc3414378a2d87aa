"""`p2_search` span: the blind search's enqueue on the host (`_phase2`), ms
per 1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "p2_search")
