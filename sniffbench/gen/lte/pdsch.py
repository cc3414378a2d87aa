"""PDSCH resource mapping + transport channel math (36.211 6.3/6.4, 36.212 5.1.4.1.2).

Host-side (NumPy) static/per-grant computations shared by the test TX and the
RX pipeline: data-RE index builders (CRS/control/PBCH/PSS/SSS exclusion),
per-code-block rate-matching output sizes, scrambling c_init.

Parity surface: srsRAN pdsch/ra_dl usage by the reference
(`src/src/DL_Sniffer_PDSCH.cc:881-1291`, SURVEY.md §2.1).
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np

from . import sequences
from .params import CellConfig, N_SYM_SF


def scrambling_cinit(rnti: int, q: int, sf_idx: int, n_id_cell: int) -> int:
    """36.211 6.3.1: c_init = rnti*2^14 + q*2^13 + ns/2*2^9 + N_ID."""
    return (rnti << 14) + (q << 13) + (sf_idx << 9) + n_id_cell


@functools.lru_cache(maxsize=64)
def reserved_re_mask(cell: CellConfig, sf_idx: int, cfi: int) -> np.ndarray:
    """(14, n_sc) bool: REs NOT usable by PDSCH (control, CRS, PBCH, PSS/SSS).

    CRS positions are reserved on *all* configured ports in every symbol that
    carries CRS for any port.
    """
    n_sc = cell.n_sc
    mask = np.zeros((N_SYM_SF, n_sc), dtype=bool)
    mask[:cfi, :] = True
    crs_mask, _ = sequences.crs_grid(cell.n_id_cell, sf_idx, cell.n_prb,
                                     cell.nof_ports)
    mask |= crs_mask.any(axis=0)
    center = n_sc // 2
    six_rb = slice(center - 36, center + 36)
    if sf_idx in (0, 5):
        mask[5, six_rb] = True   # SSS (center 6 RBs reserved)
        mask[6, six_rb] = True   # PSS
    if sf_idx == 0:
        # PBCH: slot 1 symbols 0..3 -> subframe symbols 7..10, center 6 RB
        for l in range(7, 11):
            mask[l, six_rb] = True
    return mask


_GRANT_RE_CACHE: dict = {}


def grant_re_indices(cell: CellConfig, sf_idx: int, cfi: int,
                     prb_mask: np.ndarray,
                     prb_mask_slot1: np.ndarray | None = None) -> np.ndarray:
    """Flat (l * n_sc + k) indices of the grant's PDSCH REs in mapping order
    (k ascending within symbol, symbols ascending), slot-aware.

    Memoized on (cell, sf_idx, cfi, mask bytes): a loaded cell re-issues
    the same allocations every frame and this sits on the per-grant hot
    path.  Callers must not mutate the returned array."""
    key = (cell, sf_idx, cfi, np.asarray(prb_mask, bool).tobytes(),
           None if prb_mask_slot1 is None
           else np.asarray(prb_mask_slot1, bool).tobytes())
    hit = _GRANT_RE_CACHE.get(key)
    if hit is not None:
        return hit
    if len(_GRANT_RE_CACHE) > 8192:
        _GRANT_RE_CACHE.clear()
    out = _grant_re_indices_impl(cell, sf_idx, cfi, prb_mask, prb_mask_slot1)
    _GRANT_RE_CACHE[key] = out
    return out


def _grant_re_indices_impl(cell, sf_idx, cfi, prb_mask, prb_mask_slot1):
    n_sc = cell.n_sc
    if prb_mask_slot1 is None:
        prb_mask_slot1 = prb_mask
    res = reserved_re_mask(cell, sf_idx, cfi)
    sc_mask0 = np.repeat(np.asarray(prb_mask, bool), 12)
    sc_mask1 = np.repeat(np.asarray(prb_mask_slot1, bool), 12)
    out = []
    for l in range(cfi, N_SYM_SF):
        sc = sc_mask0 if l < 7 else sc_mask1
        ks = np.nonzero(sc & ~res[l])[0]
        out.append(l * n_sc + ks)
    return np.concatenate(out)


def cb_rate_match_sizes(G: int, C: int, qm: int, n_layers_cw: int = 1) -> List[int]:
    """Per-code-block output sizes E_j (36.212 5.1.4.1.2)."""
    gp = G // (n_layers_cw * qm)
    gamma = gp % C
    es = []
    for j in range(C):
        if j <= C - 1 - gamma:
            es.append(n_layers_cw * qm * (gp // C))
        else:
            es.append(n_layers_cw * qm * (-(-gp // C)))
    return es

