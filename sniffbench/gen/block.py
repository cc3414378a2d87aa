"""Build a cell's input block: the schedule in this process, the
subframes on a pool of worker processes (spawned, so no state is shared),
each worker packing its subframes into 8-bit IQ words as an SDR front-end
delivers them (per-subframe AGC)."""
from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np

from . import mix as mix_mod, tx


def _encode_range(config: dict, mix: dict, seed: int, j0: int, plans,
                  h_static):
    frames, truth = [], []
    for k, grants in enumerate(plans):
        iq, t = mix_mod.encode_subframe(config, mix, j0 + k, grants, seed,
                                        h_static)
        frames.append(iq)
        truth.append(t)
    words, scales = tx.to_i8_packed(np.stack(frames).astype(np.complex64))
    return words, scales, truth


def build(config: dict, mix: dict, seed: int, workers: int = 1,
          n_sf: Optional[int] = None):
    """-> ((T, RX, sf_len / 2) '<i4' packed IQ words, (T,) float32 scales,
    per-subframe truth).  `n_sf` builds only the block's first subframes
    (the tests); the schedule is the whole block's either way."""
    plans = mix_mod.schedule(config, mix)
    if n_sf is not None:
        plans = plans[:n_sf]
    h = mix_mod.static_channel(config, mix, seed)
    T = len(plans)
    workers = max(1, min(workers, T))
    bounds = np.linspace(0, T, workers + 1).astype(int)
    jobs = [(config, mix, seed, int(a), plans[a:b], h)
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    if workers == 1:
        parts = [_encode_range(*j) for j in jobs]
    else:
        # an executor, not a Pool: a worker that dies raises here instead
        # of being replaced while the caller waits forever
        with ProcessPoolExecutor(workers, mp_context=mp.get_context(
                "spawn")) as ex:
            parts = list(ex.map(_encode_range, *zip(*jobs)))
    words = np.concatenate([p[0] for p in parts])
    scales = np.concatenate([p[1] for p in parts])
    truth: List[dict] = [t for p in parts for t in p[2]]
    return words, scales, truth
