"""Share of the primary decode's code blocks that fail their CRC and are
decoded again at the escalation's iterations, %."""
from sniffbench.metrics.program_trace import total_pct


def read(rec):
    return total_pct(rec, "pdsch_cb_escalated", "pdsch_cb")
