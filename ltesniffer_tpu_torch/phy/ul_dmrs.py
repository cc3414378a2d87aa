"""PUSCH demodulation reference signals (36.211 5.5).

Zadoff-Chu base sequences with group/sequence hopping and cyclic shifts,
as configured by SIB2 (the reference pulls this from `ULSchedule::set_SIB2`,
`src/src/ULSchedule.cc:105-158`, and estimates with
`srsran_chest_ul_estimate_pusch`).

Sequences for >=3 PRB are ZC math; the 1-2 PRB special base sequences use
the published phi(n) tables (36.211 Tables 5.5.1.2-1/2, `tables_data`).
"""
from __future__ import annotations

import functools

import numpy as np

from . import sequences as seq_mod
from . import tables_data as _data

N_SC_RB = 12

# 3-bit DCI0 field -> n_DMRS2 (36.211 Table 5.5.2.1.1-1)
N_DMRS2_TABLE = (0, 6, 3, 4, 2, 8, 10, 9)
# SIB2 cyclicShift -> n_DMRS1 (Table 5.5.2.1.1-2)
N_DMRS1_TABLE = (0, 2, 3, 4, 6, 8, 9, 10)


def _largest_prime_below(n: int) -> int:
    def is_prime(k):
        if k < 2:
            return False
        i = 2
        while i * i <= k:
            if k % i == 0:
                return False
            i += 1
        return True
    p = n - 1
    while not is_prime(p):
        p -= 1
    return p


def _phi_table(n_rb: int) -> np.ndarray:
    """Published 30 x (12*n_rb) phi tables for 1-2 PRB base sequences."""
    return _data.DMRS_PHI_1PRB if n_rb == 1 else _data.DMRS_PHI_2PRB


@functools.lru_cache(maxsize=256)
def base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """r_{u,v}(n) of length m_sc (= 12 * n_prb)."""
    n_rb = m_sc // N_SC_RB
    if n_rb <= 2:
        phi = _phi_table(n_rb)[u]
        return np.exp(1j * phi * np.pi / 4.0).astype(np.complex64)
    n_zc = _largest_prime_below(m_sc + 1)
    qbar = n_zc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * int((-1) ** np.floor(2 * qbar))
    m = np.arange(n_zc)
    x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
    return x[np.arange(m_sc) % n_zc].astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _hopping_state(n_id_cell: int, delta_ss: int, group_hopping: bool):
    f_ss = (n_id_cell + delta_ss) % 30
    if not group_hopping:
        fgh = np.zeros(20, dtype=np.int64)
    else:
        c = seq_mod.gold_sequence(n_id_cell // 30, 8 * 20)
        fgh = np.array([
            sum(int(c[8 * ns + i]) << i for i in range(8)) % 30
            for ns in range(20)], dtype=np.int64)
    return f_ss, fgh


def group_number(ns: int, n_id_cell: int, delta_ss: int = 0,
                 group_hopping: bool = False) -> int:
    """u for slot ns (36.211 5.5.1.3)."""
    f_ss, fgh = _hopping_state(n_id_cell, delta_ss, group_hopping)
    return int((fgh[ns % 20] + f_ss) % 30)


@functools.lru_cache(maxsize=64)
def _n_pn_table(n_id_cell: int, delta_ss: int) -> np.ndarray:
    """n_PN(ns) per slot (36.211 5.5.2.1.1)."""
    f_ss = (n_id_cell + delta_ss) % 30
    c_init = (n_id_cell // 30) * 32 + f_ss
    c = seq_mod.gold_sequence(c_init, 8 * 20)
    return np.array([
        sum(int(c[8 * ns + i]) << i for i in range(8)) % 12
        for ns in range(20)], dtype=np.int64)


def pusch_dmrs(n_prb: int, ns: int, n_id_cell: int,
               cyclic_shift_cfg: int = 0, dci_dmrs_field: int = 0,
               delta_ss: int = 0, group_hopping: bool = False,
               seq_hopping: bool = False) -> np.ndarray:
    """The DMRS sequence for one slot's pilot symbol; length 12*n_prb."""
    m_sc = N_SC_RB * n_prb
    u = group_number(ns, n_id_cell, delta_ss, group_hopping)
    v = 0  # sequence hopping only for >=6 PRB; keep v=0 unless enabled
    base = base_sequence(u, v, m_sc)
    n_pn = _n_pn_table(n_id_cell, delta_ss)[ns % 20]
    n_cs = (N_DMRS1_TABLE[cyclic_shift_cfg]
            + N_DMRS2_TABLE[dci_dmrs_field] + int(n_pn)) % 12
    alpha = 2.0 * np.pi * n_cs / 12.0
    n = np.arange(m_sc)
    return (np.exp(1j * alpha * n) * base).astype(np.complex64)
