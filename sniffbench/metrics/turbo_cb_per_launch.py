"""Code blocks a launch of the fused turbo kernel decodes, on average:
the tracer's `turbo_cb` total over its events (one event a launch)."""
from sniffbench.metrics.program_trace import counters


def read(rec):
    c = counters(rec)
    if c is None or not c.get("turbo_cb", {}).get("events"):
        return None
    return c["turbo_cb"]["total"] / c["turbo_cb"]["events"]
