"""`p4_results` span: the batched PDSCH's one read of its fused result
words (`pf_d2h`, which waits for the batch's device work) and each
block's finish on the host (code-block CRCs, reassembly, the transport
block's CRC), ms per 1000 subframes."""
from sniffbench.metrics import span_ms_per_ksf


def read(rec):
    return span_ms_per_ksf(rec, "p4_results")
