"""Code blocks a launch of the batched PDSCH de-rate-match takes, on
average: the tracer's `pdsch_derm_cb` total over its events (one event a
launch)."""
from sniffbench.metrics.program_trace import counters


def read(rec):
    c = counters(rec)
    if c is None or not c.get("pdsch_derm_cb", {}).get("events"):
        return None
    return c["pdsch_derm_cb"]["total"] / c["pdsch_derm_cb"]["events"]
