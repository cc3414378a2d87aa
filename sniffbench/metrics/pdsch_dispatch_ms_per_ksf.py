"""`pdsch_dispatch` span: the batched PDSCH dispatch, ms per 1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "pdsch_dispatch")
