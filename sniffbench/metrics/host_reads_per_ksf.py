"""Blocking device-to-host reads (the tracer's `host_read.*` events) per
1000 subframes."""
from sniffbench.metrics.program_trace import events_per_ksf


def read(rec):
    return events_per_ksf(rec, "host_read.")
