"""Control-region resource mapping: REGs, PCFICH, PHICH, PDCCH (36.211 6.7-6.9).

Produces *static index maps* for a given cell config + CFI: every RX-side
extraction becomes a gather with a precomputed index tensor, every TX-side
(test encoder) mapping a scatter.  This is what lets the whole PDCCH path be
one jitted batched gather/compute pipeline instead of srsRAN's per-subframe
pointer walks (`SURVEY.md` §2.1 pdcch row).

PHICH REG placement is RECONSTRUCTED from 36.211 6.9.3 structure (group m,
quadruplet i spread over thirds of the non-PCFICH REGs of symbol 0, offset by
the cell id); PCFICH/PDCCH/REG layouts are EXACT.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from . import conv
from .params import CellConfig, N_SC_RB


@dataclasses.dataclass(frozen=True)
class Reg:
    l: int                 # OFDM symbol
    k0: int                # first subcarrier of the REG span
    res: Tuple[int, ...]   # the 4 data subcarriers


def regs_in_symbol(cell: CellConfig, l: int) -> List[Reg]:
    """All REGs of one control symbol, increasing frequency."""
    vshift3 = cell.n_id_cell % 3
    out = []
    crs_here = (l == 0) or (l == 1 and cell.nof_ports == 4)
    for rb in range(cell.n_prb):
        base = rb * N_SC_RB
        if crs_here:
            # two REGs of 6 subcarriers; CRS every 3 starting at vshift3
            for half in range(2):
                k0 = base + 6 * half
                res = tuple(k for k in range(k0, k0 + 6) if (k % 3) != vshift3)
                out.append(Reg(l=l, k0=k0, res=res))
        else:
            for third in range(3):
                k0 = base + 4 * third
                out.append(Reg(l=l, k0=k0, res=tuple(range(k0, k0 + 4))))
    return out


@functools.lru_cache(maxsize=32)
def control_region(cell: CellConfig, cfi: int):
    """Full REG bookkeeping for one (cell, cfi).

    Returns dict with:
      pcfich_regs:  list[Reg] (4)
      phich_regs:   list[Reg] (3 * n_groups)
      pdcch_regs:   list[Reg] in PDCCH mapping order (k-major, l-minor)
      pdcch_re_idx: (n_pdcch_regs, 4) int array of flat (l * n_sc + k) indices
    """
    n_sc = cell.n_sc
    sym_regs = [regs_in_symbol(cell, l) for l in range(cfi)]

    # --- PCFICH: 4 REGs in symbol 0 (36.211 6.7.4) ------------------------
    kbar = (N_SC_RB // 2) * (cell.n_id_cell % (2 * cell.n_prb))
    pcfich_k0 = [(kbar + (i * cell.n_prb // 2) * (N_SC_RB // 2)) % n_sc
                 for i in range(4)]
    reg_by_k0_l0 = {r.k0: r for r in sym_regs[0]}
    pcfich_regs = []
    for k in pcfich_k0:
        # k aligns with a REG start (both are multiples of 6)
        pcfich_regs.append(reg_by_k0_l0[k])

    # --- PHICH: 3 REGs per group in symbol 0, normal duration -------------
    taken = {(r.l, r.k0) for r in pcfich_regs}
    avail0 = [r for r in sym_regs[0] if (r.l, r.k0) not in taken]
    n0 = len(avail0)
    phich_regs = []
    for m in range(cell.nof_phich_groups):
        for i in range(3):
            idx = (cell.n_id_cell + m + (i * n0) // 3) % n0
            # linear probe past collisions with earlier groups
            tries = 0
            while (0, avail0[idx].k0) in taken and tries < n0:
                idx = (idx + 1) % n0
                tries += 1
            r = avail0[idx]
            taken.add((r.l, r.k0))
            phich_regs.append(r)

    # --- PDCCH: every remaining REG, k-major then l (36.211 6.8.5) --------
    remaining = []
    for l in range(cfi):
        for r in sym_regs[l]:
            if (r.l, r.k0) not in taken:
                remaining.append(r)
    remaining.sort(key=lambda r: (r.k0, r.l))
    pdcch_re_idx = np.array([[r.l * n_sc + k for k in r.res] for r in remaining],
                            dtype=np.int64)
    return {
        "pcfich_regs": pcfich_regs,
        "phich_regs": phich_regs,
        "pdcch_regs": remaining,
        "pdcch_re_idx": pdcch_re_idx,
        "nof_pdcch_regs": len(remaining),
    }


@functools.lru_cache(maxsize=32)
def pdcch_interleave_maps(cell: CellConfig, cfi: int):
    """Quadruplet permutation between CCE order and the REG mapping order.

    TX: z(i) quadruplets sub-block interleaved (32-column conv permutation on
    quadruplets, NULLs dropped) then cyclically shifted by N_cell_ID.
    Returns (tx_map, rx_map): tx_map[j] = source quadruplet index feeding REG
    j in mapping order; rx_map inverts it (rx_map[i] = REG position of
    quadruplet i in CCE order).
    """
    reg = control_region(cell, cfi)
    m_quad = reg["nof_pdcch_regs"]
    perm, _ = conv.subblock_interleave_indices(m_quad)
    inter = perm[perm >= 0]                    # NULLs dropped, len m_quad
    shift = cell.n_id_cell % m_quad
    tx_map = np.roll(inter, -shift)            # w_bar(j) = w((j + shift) cyclic)
    rx_map = np.zeros(m_quad, dtype=np.int64)
    rx_map[tx_map] = np.arange(m_quad)
    return tx_map, rx_map


# ---------------------------------------------------------------------------
# PCFICH codewords (36.212 5.3.4)
# ---------------------------------------------------------------------------
_CFI_CODEWORDS = {
    1: [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1,
        0, 1, 1, 0, 1, 1, 0, 1],
    2: [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1,
        1, 0, 1, 1, 0, 1, 1, 0],
    3: [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0,
        1, 1, 0, 1, 1, 0, 1, 1],
}


def cfi_codeword(cfi: int) -> np.ndarray:
    return np.array(_CFI_CODEWORDS[cfi], dtype=np.uint8)


def pcfich_scrambling(cell: CellConfig, sf_idx: int) -> np.ndarray:
    """36.211 6.7.1: c_init = (ns/2 + 1) * (2 N_ID + 1) * 2^9 + N_ID."""
    from . import sequences
    ns = 2 * sf_idx
    c_init = (ns // 2 + 1) * (2 * cell.n_id_cell + 1) * 512 + cell.n_id_cell
    return sequences.gold_sequence(c_init, 32)


def pdcch_scrambling(cell: CellConfig, sf_idx: int, length: int) -> np.ndarray:
    """36.211 6.8.2: c_init = ns/2 * 2^9 + N_ID."""
    from . import sequences
    c_init = (sf_idx << 9) + cell.n_id_cell
    return sequences.gold_sequence(c_init, length)
