"""Grants a launch of the batched PDSCH eq/demap takes, on average: the
tracer's `pdsch_eq_grants` total over its events (one event a launch)."""
from sniffbench.metrics.program_trace import counters


def read(rec):
    c = counters(rec)
    if c is None or not c.get("pdsch_eq_grants", {}).get("events"):
        return None
    return c["pdsch_eq_grants"]["total"] / c["pdsch_eq_grants"]["events"]
