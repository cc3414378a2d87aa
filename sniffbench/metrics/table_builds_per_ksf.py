"""Tables and functions the program's factories built (cache misses, the
tracer's `build.*` events) per 1000 subframes."""
from sniffbench.metrics.program_trace import events_per_ksf


def read(rec):
    return events_per_ksf(rec, "build.")
