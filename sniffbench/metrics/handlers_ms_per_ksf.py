"""`p3_handlers` span: the MAC/RRC handlers and the PDSCH job building, ms
per 1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "p3_handlers")
