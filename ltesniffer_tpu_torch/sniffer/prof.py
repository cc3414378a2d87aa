"""The port's tracer: nested host spans, per-batch times and counters (the
reference's `lib/src/prof/` Stopwatch / PrintLifetime analog,
`Lifetime.cc:27-48`, `Stopwatch.cc:24-40`, grown into a tracer).

Usage:
    from ltesniffer_tpu_torch.sniffer import prof
    with prof.span("pdcch"):      # nested spans know their parent
        ...
    prof.count("host_read.p3_join")
    prof.report()     # {span: {"s": total, "n": calls, "self": s less
                      #         the child spans', "parents": {name: calls}}}
    prof.batches()    # the newest batches' ids, subframes and times
    prof.counters()   # {name: {"total": sum of n, "events": calls}}
    prof.reset()      # clears spans, batches and counters together

Always on, in one thread.  A span costs two clock reads and a few list
operations; the per-name totals, the batch ring and the counters are
allocated once, so a capture of any length holds the tracer's memory
fixed (the ring keeps the newest `RING` batches).  While a torch.profiler
session is active, each span also opens a profiler range `span:<name>`
whose one input is the current batch id (seen with `record_shapes=True`),
so the profiler's trace carries the program's spans, nested, on its own
clock.

Batches: the core calls `batch_start(id, n_sf)` as a batch's phase 1
starts (its time `t_in`), `batch(id)` as each later phase starts,
`batch_dci(id)` when its phase 3 ends (its DCIs are out, `t_dci`) and
`batch_out(id)` when its phase 5 ends (its transport blocks and pcap
records are out, `t_out`).  Times are `time.perf_counter_ns()`.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

RING = 65536                    # batches kept: 5 int64 arrays, 2.5 MiB
_now = time.perf_counter_ns
_rf_enter = torch.autograd._record_function_with_args_enter
_rf_exit = torch.autograd._record_function_with_args_exit
_tp = torch.autograd.profiler   # `_is_profiler_enabled`: a session is on

# the open spans, innermost last: the span, its start, the time its child
# spans took so far, and its profiler range (None outside a session)
_open: list = []
_t0: list = []
_child: list = []
_range: list = []
_spans: Dict[str, "_Span"] = {}
_batch = -1                     # the batch the open spans belong to


class _Span:
    """One span name's totals; `span(name)` hands out the same object for
    every use of the name, and the open spans' state lives on the stack,
    so a name may nest within itself."""
    __slots__ = ("name", "label", "ns", "n", "self_ns", "parents")

    def __init__(self, name: str):
        self.name = name
        self.label = "span:" + name
        self.clear()

    def clear(self):
        self.ns = self.n = self.self_ns = 0
        self.parents: Dict[Optional[_Span], int] = {}

    def __enter__(self):
        _range.append(_rf_enter(self.label, _batch)
                      if _tp._is_profiler_enabled else None)
        _open.append(self)
        _child.append(0)
        _t0.append(_now())
        return self

    def __exit__(self, *exc):
        dt = _now() - _t0.pop()
        child = _child.pop()
        _open.pop()
        rf = _range.pop()
        if rf is not None:
            _rf_exit(rf)
        self.ns += dt
        self.n += 1
        self.self_ns += dt - child
        if _child:
            _child[-1] += dt
        parent = _open[-1] if _open else None
        self.parents[parent] = self.parents.get(parent, 0) + 1
        return False


def span(name: str) -> _Span:
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


def report() -> Dict[str, dict]:
    """Every span used since the last reset, the longest first: seconds,
    calls, self seconds (less the time of its child spans) and the calls
    under each parent (None: at the top)."""
    out = {}
    for s in sorted(_spans.values(), key=lambda s: -s.ns):
        if s.n:
            out[s.name] = {"s": round(s.ns * 1e-9, 4), "n": s.n,
                           "self": round(s.self_ns * 1e-9, 4),
                           "parents": {p.name if p else None: k
                                       for p, k in s.parents.items()}}
    return out


# --- batches -------------------------------------------------------------
_ids = np.zeros(RING, np.int64)
_sfs = np.zeros(RING, np.int64)
_t_in = np.zeros(RING, np.int64)
_t_dci = np.zeros(RING, np.int64)
_t_out = np.zeros(RING, np.int64)
_n_batches = 0                  # batches started since the reset
IN_FLIGHT = 16                  # the newest slots a mark looks through


def batch_start(bid: int, n_sf: int):
    """Batch `bid` of `n_sf` subframes enters: its phase 1 starts now."""
    global _n_batches, _batch
    i = _n_batches % RING
    _ids[i], _sfs[i], _t_in[i] = bid, n_sf, _now()
    _t_dci[i] = _t_out[i] = 0
    _n_batches += 1
    _batch = bid


def batch(bid: int):
    """The spans opened from now on belong to batch `bid`."""
    global _batch
    _batch = bid


def _slot(bid: int) -> int:
    for k in range(1, min(_n_batches, IN_FLIGHT) + 1):
        i = (_n_batches - k) % RING
        if _ids[i] == bid:
            return i
    return -1


def batch_dci(bid: int):
    """Batch `bid`'s phase 3 ended: its DCIs are handed out."""
    i = _slot(bid)
    if i >= 0:
        _t_dci[i] = _now()


def batch_out(bid: int):
    """Batch `bid`'s phase 5 ended: all its records are out."""
    i = _slot(bid)
    if i >= 0:
        _t_out[i] = _now()


def batches() -> Dict[str, np.ndarray]:
    """The batches started since the reset (the newest `RING`), oldest
    first: `id`, `n_sf`, `t_in`, `t_dci`, `t_out` (ns; 0 where the batch
    has not reached that point)."""
    n = min(_n_batches, RING)
    order = (np.arange(_n_batches - n, _n_batches) % RING)
    return {"id": _ids[order], "n_sf": _sfs[order], "t_in": _t_in[order],
            "t_dci": _t_dci[order], "t_out": _t_out[order]}


# --- counters ------------------------------------------------------------
_counts: Dict[str, list] = {}
_factories: Dict[str, list] = {}    # name -> [lru-cached function, misses
                                    # at the last reset]


def count(name: str, n: int = 1):
    """One event of `name`, adding `n` to its total."""
    c = _counts.get(name)
    if c is None:
        c = _counts[name] = [0, 0]
    c[0] += n
    c[1] += 1


def host_read(site: str, t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`, counted as one event of `host_read.<site>`: the port's
    blocking device-to-host reads all go through here."""
    count("host_read." + site)
    return t.cpu()


def factory(maxsize: Optional[int]):
    """`functools.lru_cache(maxsize)` whose misses count as events of
    `build.<module>.<function>` in `counters()`: read from `cache_info()`,
    so a hit costs what any lru_cache hit costs."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        name = f"build.{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"
        _factories[name] = [cached, cached.cache_info().misses]
        return cached
    return wrap


def counters() -> Dict[str, dict]:
    """Every counter with an event since the reset, the factories' builds
    among them."""
    out = {k: {"total": v[0], "events": v[1]} for k, v in _counts.items()}
    for name, (fn, base) in _factories.items():
        m = fn.cache_info().misses
        n = m - base if m >= base else m     # cache_clear() zeroes misses
        if n:
            c = out.setdefault(name, {"total": 0, "events": 0})
            c["total"] += n
            c["events"] += n
    return out


def reset():
    """Clear spans, batches and counters (spans open now still close)."""
    global _n_batches
    for s in _spans.values():
        s.clear()
    _n_batches = 0
    _counts.clear()
    for f in _factories.values():
        f[1] = f[0].cache_info().misses


def pretty() -> str:
    lines = [f"{k:24s} {v['s']:9.3f} s  self {v['self']:9.3f} s  x{v['n']}"
             for k, v in report().items()]
    return "\n".join(lines)
