"""Blocking device-to-host reads a two-codeword decode makes: the events
of the tracer's `host_read.mimo_llr` and `host_read.mimo_bits` over those
of `pdsch_mimo_grant` (one event a decode)."""
from sniffbench.metrics.program_trace import counters

SITES = ("host_read.mimo_llr", "host_read.mimo_bits")


def read(rec):
    c = counters(rec)
    if c is None or not c.get("pdsch_mimo_grant", {}).get("events"):
        return None
    reads = sum(c.get(s, {"events": 0})["events"] for s in SITES)
    return reads / c["pdsch_mimo_grant"]["events"]
