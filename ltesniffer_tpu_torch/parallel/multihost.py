"""Multi-host scaling: contiguous time-blocks with boundary tracker replay.

The port's copy of `ltesniffer_tpu/parallel/multihost.py` (numpy only;
the tests hold both merges equal on the same stream).  Each block's core
is made by the caller's factory and runs on the caller's device.

BASELINE config 5: N hosts each ingest a contiguous block of the subframe
stream and run the full sniffer pipeline over their local chips; the
per-host outputs merge into the single-host result.  The cross-block
couplings are the L5 trackers (RNTI histograms — 200 ms window,
`RNTIManager.h:47-49`; MCS tables; HARQ — 8 ms recurrence; UL grants —
t+4/t+6, SURVEY.md §5 sequence-axis notes).

Design: **boundary replay, not state streaming.**  Host k>0 prepends the
last `overlap_sf` subframes of block k-1 to its own block and replays them
through its (fresh) tracker state with outputs discarded; by the time its
own block starts, the short-horizon tracker state (histogram window, HARQ
recurrence, pending UL grants, MCS tables of currently-active RNTIs) is
reconstructed.  The merge then keeps exactly the records each host *owns*
(its block interval) and orders them by absolute TTI.  This keeps hosts
fully parallel — no serialized state handoff — at the cost of `overlap_sf`
duplicated subframes of compute per boundary (2% at the default 200 ms
overlap on a 10 s block).

Reconstruction horizon: tracker state older than the overlap is not
replayed.  With the default `overlap_sf=200` (= the RNTI histogram window)
every histogram-validated acceptance matches the 1-host run; the 10 s
active-set lifetime (`RNTIManager.h:42`) means an RNTI *activated* by RAR
more than `overlap_sf` before the boundary and silent since would drop to
histogram re-validation on the next block — extend `overlap_sf` (up to
10 s) when exact parity across such silences matters.  The divergence is
BOUNDED and ONE-SIDED: at most `histogram_threshold` of the silent RNTI's
earliest post-boundary records are missed, never added (measured in
`tests/test_multihost.py::
test_multihost_rar_silence_past_overlap_divergence_bound`, and for this
copy in `tests/test_torch_multihost.py`).

Absolute time: each block's core is seeded with `sfn0`/`sf_idx0` derived
from the block's absolute subframe offset, so per-record (sfn, sf_idx)
labels — and therefore the merge order and ownership filter — agree across
hosts without any cross-host clock.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from ltesniffer_tpu_torch.phy.params import CellConfig

DEFAULT_OVERLAP_SF = 200   # = RNTI histogram window (`RNTI_HISTORY_DEPTH`)


@dataclasses.dataclass
class TimeBlock:
    """One host's work assignment."""
    host: int
    samples: np.ndarray       # overlap + owned samples
    warmup_sf: int            # leading subframes to replay, outputs dropped
    own_start_sf: int         # absolute subframe index of first owned sf
    own_count_sf: int         # owned subframes
    sfn0: int                 # seed SFN for the block's first subframe
    sf_idx0: int              # seed sf_idx for the block's first subframe


def split_blocks(samples: np.ndarray, n_hosts: int, cell: CellConfig,
                 overlap_sf: int = DEFAULT_OVERLAP_SF,
                 sfn0: int = 0, sf_idx0: int = 0) -> List[TimeBlock]:
    """Carve a subframe-aligned stream into N contiguous owned intervals,
    each preceded by its replay overlap (host 0 has none)."""
    n = cell.sf_len
    total = len(samples) // n
    bounds = [round(i * total / n_hosts) for i in range(n_hosts + 1)]
    blocks = []
    for h in range(n_hosts):
        own0, own1 = bounds[h], bounds[h + 1]
        rep0 = max(0, own0 - overlap_sf)
        abs0 = sfn0 * 10 + sf_idx0 + rep0
        blocks.append(TimeBlock(
            host=h,
            samples=samples[rep0 * n: own1 * n],
            warmup_sf=own0 - rep0,
            own_start_sf=own0,
            own_count_sf=own1 - own0,
            sfn0=(abs0 // 10) % 1024,
            sf_idx0=abs0 % 10,
        ))
    return blocks


def run_block(core_factory: Callable, block: TimeBlock):
    """Run one host's block through a fresh core (the per-host process
    analog).  Returns the core after processing; ownership filtering
    happens in `merge_accepted`."""
    core = core_factory(block)
    core.sfn = block.sfn0
    core.run_samples(block.samples, sf_idx0=block.sf_idx0)
    return core


def _abs_sf(sfn: int, sf_idx: int, sfn0: int = 0) -> int:
    return ((sfn - sfn0) % 1024) * 10 + sf_idx


def owned(block: TimeBlock, sfn: int, sf_idx: int, sfn0: int = 0) -> bool:
    t = _abs_sf(sfn, sf_idx, sfn0)
    return block.own_start_sf <= t < block.own_start_sf + block.own_count_sf


def merge_accepted(per_host_results: Sequence[List],
                   blocks: Sequence[TimeBlock], sfn0: int = 0,
                   key=lambda r: (r.dci.sfn, r.dci.sf_idx)) -> List:
    """Merge per-host result lists into the single-host result.

    Boundary tracker replay already ran inside each host (the overlap
    subframes were processed through its trackers); here the replay
    duplicates are dropped — each record is kept iff the producing host
    owns its absolute subframe — and the survivors are ordered by absolute
    TTI.  `key` extracts (sfn, sf_idx) from a result record."""
    out = []
    for results, block in zip(per_host_results, blocks):
        for r in results:
            sfn, sf_idx = key(r)
            if owned(block, sfn, sf_idx, sfn0):
                out.append((_abs_sf(sfn, sf_idx, sfn0), r))
    out.sort(key=lambda t: t[0])
    return [r for _, r in out]


def merge_pcap_records(per_host_recs: Sequence[List[dict]],
                       blocks: Sequence[TimeBlock],
                       sfn0: int = 0) -> List[dict]:
    """Same ownership merge for pcap record dicts (rnti/sfn/sf_idx/...)."""
    out = []
    for recs, block in zip(per_host_recs, blocks):
        for r in recs:
            if owned(block, r["sfn"], r["sf_idx"], sfn0):
                out.append((_abs_sf(r["sfn"], r["sf_idx"], sfn0), r))
    out.sort(key=lambda t: t[0])
    return [r for _, r in out]
