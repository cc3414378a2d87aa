"""What the program's own tracer (`ltesniffer_tpu_torch/sniffer/prof.py`)
holds over the traced window, for the readers of its batches and counters.

The harness resets the tracer where the span window starts
(`spans_from_here`) and reads the metrics after the window, so the
tracer's batches and counters cover exactly the `span_sf` subframes of
the window.  A record without `span_sf` (an untraced run, the contract's
empty record) and a program whose tracer has no batches or counters give
None.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

PROF = "ltesniffer_tpu_torch.sniffer.prof"


def _tracer(rec: dict, what: str):
    """The tracer's `what` function, or None."""
    if not rec.get("span_sf"):
        return None
    prof = sys.modules.get(PROF)      # the harness imported the program
    return getattr(prof, what, None)


def counters(rec: dict) -> Optional[dict]:
    """{name: {"total", "events"}} over the window, or None."""
    fn = _tracer(rec, "counters")
    return fn() if fn is not None else None


def events_per_ksf(rec: dict, prefix: str) -> Optional[float]:
    """The events of every counter named `<prefix>...`, per 1000
    subframes of the window."""
    c = counters(rec)
    if c is None:
        return None
    n = sum(v["events"] for k, v in c.items() if k.startswith(prefix))
    return n / (rec["span_sf"] / 1e3)


def total_pct(rec: dict, part: str, whole: str) -> Optional[float]:
    """100 x the total of counter `part` over that of `whole` (a part
    with no event is 0)."""
    c = counters(rec)
    if c is None or not c.get(whole, {}).get("total"):
        return None
    return 100.0 * c.get(part, {"total": 0})["total"] / c[whole]["total"]


def batch_latency_ms(rec: dict) -> Optional[np.ndarray]:
    """`t_out - t_in` of each batch that entered and left in the window,
    in ms, or None."""
    fn = _tracer(rec, "batches")
    if fn is None:
        return None
    b = fn()
    done = b["t_out"] > 0
    if not done.any():
        return None
    return (b["t_out"][done] - b["t_in"][done]) * 1e-6
