"""Code blocks a turbo launch of the two-codeword route decodes, on
average: the tracer's `pdsch_mimo_cb` total over its events (one event a
launch)."""
from sniffbench.metrics.program_trace import counters


def read(rec):
    c = counters(rec)
    if c is None or not c.get("pdsch_mimo_cb", {}).get("events"):
        return None
    return c["pdsch_mimo_cb"]["total"] / c["pdsch_mimo_cb"]["events"]
