"""`p3_mimo` span: the two-codeword grants' decodes (synchronous), ms per
1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "p3_mimo")
