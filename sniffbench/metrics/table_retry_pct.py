"""Share of the batched PDSCH grants decoded again on the 256QAM table
(an RNTI whose MCS table is not known yet failed on the 64QAM one), %."""
from sniffbench.metrics.program_trace import total_pct


def read(rec):
    return total_pct(rec, "pdsch_grant_retried", "pdsch_grant")
