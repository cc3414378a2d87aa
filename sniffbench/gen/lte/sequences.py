"""LTE sequence generators (36.211): Gold PN, Zadoff-Chu, PSS, SSS, CRS, DMRS.

Vectorized NumPy generators (block-vectorized LFSRs, no per-bit
Python loops); the port's device-side Gold generator is left out of
this copy.

Replaces the srsRAN sequence/refsignal surface used by the reference
(`SURVEY.md` §2.1: chest CRS, PSS/SSS sync, scrambling).
"""
from __future__ import annotations

import functools

import numpy as np

NC = 1600


def _lfsr_fibonacci(taps_fn, init31: np.ndarray, total: int) -> np.ndarray:
    """Generate `total` bits of an order-31 LFSR given first 31 bits.

    Block-vectorized: generates up to 28 new bits per NumPy op (the smallest
    tap distance is 3, so 28 outputs only depend on already-known values).
    """
    seq = np.empty(total, dtype=np.uint8)
    n = min(31, total)
    seq[:n] = init31[:n]
    i = 31
    while i < total:
        m = min(28, total - i)
        seq[i:i + m] = taps_fn(seq, i - 31, m)
        i += m
    return seq


def _x1_taps(seq, base, m):
    return seq[base + 3:base + 3 + m] ^ seq[base:base + m]


def _x2_taps(seq, base, m):
    return (seq[base + 3:base + 3 + m] ^ seq[base + 2:base + 2 + m]
            ^ seq[base + 1:base + 1 + m] ^ seq[base:base + m])


@functools.lru_cache(maxsize=8)
def _x1_stream(total: int) -> np.ndarray:
    init = np.zeros(31, dtype=np.uint8)
    init[0] = 1
    return _lfsr_fibonacci(_x1_taps, init, total)


def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """36.211 7.2 pseudo-random (Gold) sequence c(n), n = 0..length-1."""
    total = NC + length
    x1 = _x1_stream(total)
    init2 = np.array([(c_init >> i) & 1 for i in range(31)], dtype=np.uint8)
    x2 = _lfsr_fibonacci(_x2_taps, init2, total)
    return x1[NC:NC + length] ^ x2[NC:NC + length]


# --------------------------------------------------------------------------
# Zadoff-Chu / PSS (36.211 6.11.1)
# --------------------------------------------------------------------------
_PSS_ROOTS = {0: 25, 1: 29, 2: 34}


def pss_sequence(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 complex."""
    u = _PSS_ROOTS[n_id_2]
    n = np.arange(62)
    d = np.empty(62, dtype=np.complex64)
    n1 = n[:31]
    d[:31] = np.exp(-1j * np.pi * u * n1 * (n1 + 1) / 63.0)
    n2 = n[31:]
    d[31:] = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return d


# --------------------------------------------------------------------------
# SSS (36.211 6.11.2)
# --------------------------------------------------------------------------
def _m_seq31(poly_taps) -> np.ndarray:
    """Length-31 m-sequence x with x(0..4) = [0,0,0,0,1] and given recurrence."""
    x = np.zeros(31, dtype=np.uint8)
    x[4] = 1
    for i in range(26):
        x[i + 5] = poly_taps(x, i)
    return 1 - 2 * x.astype(np.int8)  # s~(i) = 1 - 2 x(i)


_S_TILDE = _m_seq31(lambda x, i: x[i + 2] ^ x[i])
_C_TILDE = _m_seq31(lambda x, i: x[i + 3] ^ x[i])
_Z_TILDE = _m_seq31(lambda x, i: x[i + 4] ^ x[i + 2] ^ x[i + 1] ^ x[i])


def sss_m0_m1(n_id_1: int):
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


def sss_sequence(n_id_1: int, n_id_2: int, subframe5: bool) -> np.ndarray:
    """Frequency-domain SSS d(n), length 62 real (+-1), for sf0 or sf5."""
    m0, m1 = sss_m0_m1(n_id_1)
    n = np.arange(31)
    s0 = _S_TILDE[(n + m0) % 31]
    s1 = _S_TILDE[(n + m1) % 31]
    c0 = _C_TILDE[(n + n_id_2) % 31]
    c1 = _C_TILDE[(n + n_id_2 + 3) % 31]
    z1_m0 = _Z_TILDE[(n + (m0 % 8)) % 31]
    z1_m1 = _Z_TILDE[(n + (m1 % 8)) % 31]
    d = np.empty(62, dtype=np.float32)
    if not subframe5:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d


# --------------------------------------------------------------------------
# Cell-specific reference signals (36.211 6.10.1)
# --------------------------------------------------------------------------
def crs_sequence(n_id_cell: int, ns: int, l: int, n_prb: int,
                 n_prb_max: int = 110) -> np.ndarray:
    """CRS r_{l,ns}(m') for the center ``n_prb`` RBs; length 2*n_prb complex."""
    c_init = 1024 * (7 * (ns + 1) + l + 1) * (2 * n_id_cell + 1) + 2 * n_id_cell + 1
    c = gold_sequence(c_init, 4 * n_prb_max)
    m = np.arange(2 * n_prb) + (n_prb_max - n_prb)
    re = 1.0 - 2.0 * c[2 * m].astype(np.float32)
    im = 1.0 - 2.0 * c[2 * m + 1].astype(np.float32)
    return ((re + 1j * im) / np.sqrt(2.0)).astype(np.complex64)


def crs_v(port: int, l_in_slot: int) -> int:
    """Frequency shift v per 36.211 6.10.1.2."""
    if port == 0:
        return 0 if l_in_slot == 0 else 3
    if port == 1:
        return 3 if l_in_slot == 0 else 0
    ns_mod2 = 0  # caller adds 3*(ns%2) for ports 2/3
    if port == 2:
        return 3 * ns_mod2
    return 3 + 3 * ns_mod2


def crs_re_positions(cell_n_id: int, port: int, l_sf: int, n_prb: int):
    """Subcarrier indices of CRS REs for symbol ``l_sf`` (0..13) of a subframe.

    Returns (k_indices, seq) with seq the CRS values at those REs.
    """
    ns = (l_sf // 7)  # slot within subframe: caller adds 2*sf_idx for absolute
    l_in_slot = l_sf % 7
    vshift = cell_n_id % 6
    if port < 2:
        v = crs_v(port, l_in_slot)
    elif port == 2:
        v = 3 * (ns % 2)
    else:
        v = 3 + 3 * (ns % 2)
    k = 6 * np.arange(2 * n_prb) + (v + vshift) % 6
    return k


def crs_grid(n_id_cell: int, sf_idx: int, n_prb: int, nof_ports: int):
    """Full CRS layout for one subframe.

    Returns (mask, values): mask (ports, 14, n_sc) bool; values complex64 with
    the reference symbol at CRS REs, 0 elsewhere.
    """
    n_sc = 12 * n_prb
    mask = np.zeros((nof_ports, 14, n_sc), dtype=bool)
    vals = np.zeros((nof_ports, 14, n_sc), dtype=np.complex64)
    for port in range(nof_ports):
        symbols = (0, 4, 7, 11) if port < 2 else (1, 8)
        for l_sf in symbols:
            slot = 2 * sf_idx + l_sf // 7
            l_in_slot = l_sf % 7
            seq = crs_sequence(n_id_cell, slot, l_in_slot, n_prb)
            k = crs_re_positions(n_id_cell, port, l_sf, n_prb)
            mask[port, l_sf, k] = True
            vals[port, l_sf, k] = seq
    return mask, vals
