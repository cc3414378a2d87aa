"""One reader per metric, found by the metric's name in `BENCHMARK.json`:
`read(rec)` takes the run's record and returns the number, or None where
the run holds nothing to read (the harness then leaves the metric out).

The record: `setup_s`, `window_sf`, `window_wall_s` (every run);
the traced run adds `spans` ({stage: seconds} of the program's stage
profiler over the window after the profiled calls) and `span_sf` (its
subframes), `kernels` ({kernel name: [device seconds, launches]}),
`busy_s`, `window_s`, `profiled_sf` and `profiled_tbs` (the TBS of every
transport block sent in the profiled calls), `config` and `n_iter`.
"""
from __future__ import annotations

from typing import Optional


def span_ms_per_ksf(rec: dict, stage: str) -> Optional[float]:
    """A stage span's seconds in milliseconds per 1000 subframes."""
    spans, n = rec.get("spans"), rec.get("span_sf")
    if not spans or not n or stage not in spans:
        return None
    return spans[stage] * 1e3 / (n / 1e3)
