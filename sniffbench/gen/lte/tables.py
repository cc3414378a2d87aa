"""3GPP 36.212/36.213 table math: MCS, TBS, turbo interleaver sizes.

Data lives in `tables_data` (published spec constants — see its provenance
docstring); this module provides the lookup/derivation API.

Reference parity surface: srsRAN `ra_dl/ra_ul` + `srsran_dl_fill_ra_mcs`
usage in `lib/src/phy/falcon_phch/dl_sniffer_pdsch.c:14-92` and
`ul_sniffer_pusch.c:91-135` (SURVEY.md §2.1).
"""
from __future__ import annotations

import functools

import numpy as np

from . import tables_data as _data

# Extended I_TBS row indices for the special 256QAM rows
ITBS_32A = 34
ITBS_33A = 35

# ---------------------------------------------------------------------------
# Modulation and TBS index tables
# ---------------------------------------------------------------------------

def dl_mcs_to_qm_itbs(i_mcs: int, use_256qam: bool = False):
    """36.213 Table 7.1.7.1-1 (and 7.1.7.1-1A for 256QAM). Returns (Q_m, I_TBS).

    I_TBS == -1 means reserved (mcs 29-31 retransmission-only entries).
    """
    if not use_256qam:
        if i_mcs <= 9:
            return 2, i_mcs
        if i_mcs <= 16:
            return 4, i_mcs - 1
        if i_mcs <= 28:
            return 6, i_mcs - 2
        return (2, 4, 6)[i_mcs - 29], -1
    # 256QAM alternative table (7.1.7.1-1A)
    alt = [(2, 0), (2, 2), (2, 4), (2, 6), (2, 8),
           (4, 10), (4, 11), (4, 12), (4, 13), (4, 14), (4, 15), (4, 16),
           (6, 17), (6, 18), (6, 19), (6, 20), (6, 21), (6, 22), (6, 23), (6, 24),
           (8, 25), (8, 27), (8, 28), (8, 29), (8, 30), (8, 31), (8, 32), (8, 33),
           (2, -1), (4, -1), (6, -1), (8, -1)]
    return alt[i_mcs]


# 1-PRB TBS column, I_TBS 0..26 (36.213 Table 7.1.7.2.1-1 col N_PRB=1)
TBS_1PRB = np.array([r[0] for r in _data._TBS_ROWS_0_26], dtype=np.int64)

N_PRB_MAX = 110
N_ITBS = 36  # 0..26 + 27..33 (256QAM) + 32A + 33A


@functools.lru_cache(maxsize=1)
def turbo_k_sizes() -> np.ndarray:
    """The 188 turbo code-block sizes K (36.212 Table 5.1.3-3)."""
    ks = list(range(40, 513, 8)) + list(range(528, 1025, 16)) + \
        list(range(1056, 2049, 32)) + list(range(2112, 6145, 64))
    return np.array(ks, dtype=np.int64)


@functools.lru_cache(maxsize=1)
def allowed_tbs_set() -> np.ndarray:
    """TBS values admitting zero-filler code-block segmentation.

    Single code block: TBS + 24 == K for some turbo size K <= 6144.
    C >= 2 blocks:     TBS + 24 + 24*C == C*K with ceil((TBS+24)/6120) == C.
    Every published TBS table entry satisfies this (verified in tests).
    """
    ks = turbo_k_sizes()
    out = set((ks - 24).tolist())
    for c in range(2, 40):  # up to ~240000 bits (2-layer translated values)
        for k in ks:
            b = c * k          # B' = B + 24*C
            tbs = b - 24 * c - 24
            if tbs <= 0:
                continue
            if -(-(tbs + 24) // 6120) == c:   # segmentation really yields C blocks
                out.add(tbs)
    return np.array(sorted(v for v in out if v <= 250000), dtype=np.int64)


@functools.lru_cache(maxsize=1)
def spec_tbs_ladder() -> np.ndarray:
    """The TBS values the spec tables actually use (much sparser than the
    zero-filler `allowed_tbs_set`): the distinct values of the published
    rows 0-26, row 32A, plus the 256QAM row-33 headroom value 105528."""
    vals = set(int(v) for v in np.asarray(_data._TBS_ROWS_0_26).ravel())
    vals |= set(int(v) for v in _data.TBS_32A)
    vals.add(105528)
    return np.array(sorted(vals), dtype=np.int64)


def _snap_ladder(target: float) -> int:
    ladder = spec_tbs_ladder()
    j = int(np.searchsorted(ladder, target))
    if j == 0:
        return int(ladder[0])
    if j >= len(ladder):
        return int(ladder[-1])
    lo, hi = int(ladder[j - 1]), int(ladder[j])
    return lo if target - lo <= hi - target else hi


@functools.lru_cache(maxsize=1)
def _tbs_rows_27_33() -> np.ndarray:
    """256QAM extension rows 27..33 (anchored interpolation; see
    tables_data docstring). Anchors: row 26 and row 32A exact,
    TBS(33,100) = 97896 published."""
    row26 = np.array(_data._TBS_ROWS_0_26[26], dtype=np.float64)
    row32a = np.array(_data.TBS_32A, dtype=np.float64)
    # row 26 saturates at 75376 for large n; un-saturate it for interpolation
    # by extending its linear trend so interpolated rows keep climbing.
    ref26 = row26.copy()
    sat = ref26 >= 75376
    if sat.any():
        first = int(np.argmax(sat))
        slope = ref26[first - 1] / first
        ref26[sat] = slope * (np.arange(110)[sat] + 1)
    rows = np.zeros((7, 110), dtype=np.int64)
    # positions of rows 27..33 on the 26 -> 32A -> 33 SE ladder
    for idx, i in enumerate(range(27, 34)):
        if i <= 32:
            frac = (i - 26) / 6.5          # 32A sits at "32.5"
            target = ref26 * (row32a / ref26) ** frac
        else:
            target = row32a * (97896.0 / 93800.0)
        rows[idx] = [_snap_ladder(t) for t in target]
    # pin the published anchor and cap at the 256QAM ceiling
    rows[6, 99] = 97896
    rows = np.minimum(rows, 105528)
    # monotone along n and i, and below 32A for rows 27..32
    for r in range(7):
        np.maximum.accumulate(rows[r], out=rows[r])
    for r in range(1, 7):
        rows[r] = np.maximum(rows[r], rows[r - 1])
    rows[:6] = np.minimum(rows[:6], np.array(_data.TBS_32A, dtype=np.int64))
    return rows


@functools.lru_cache(maxsize=1)
def tbs_table() -> np.ndarray:
    """Full TBS matrix (N_ITBS, 110): rows 0..26 published, 27..33
    anchored-interpolated 256QAM rows, row 34 = 32A (published),
    row 35 = 33A (one ladder step above row 33)."""
    t = np.zeros((N_ITBS, N_PRB_MAX), dtype=np.int64)
    t[:27] = np.array(_data._TBS_ROWS_0_26, dtype=np.int64)
    t[27:34] = _tbs_rows_27_33()
    t[ITBS_32A] = np.array(_data.TBS_32A, dtype=np.int64)
    allowed = allowed_tbs_set()
    row33 = t[33]
    idx = np.searchsorted(allowed, row33, side="right")
    t[ITBS_33A] = allowed[np.minimum(idx, len(allowed) - 1)]
    np.maximum.accumulate(t[ITBS_33A], out=t[ITBS_33A])
    return t


def tbs_lookup(i_tbs: int, n_prb: int) -> int:
    if i_tbs < 0 or n_prb < 1:
        return 0
    return int(tbs_table()[i_tbs, min(n_prb, N_PRB_MAX) - 1])


# 36.213 Table 7.1.7.2.2-1, large-baseline pairs (baselines that never occur
# at N_PRB <= 55, so main-table doubling cannot derive them). Anchors such as
# 75376 -> 149776 (the LTE Cat-5 per-codeword peak) are published values.
_TBS_2LAYER_LARGE = {
    42368: 84760, 43816: 87936, 45352: 90816, 46888: 93800, 48936: 97896,
    51024: 101840, 52752: 105528, 55056: 110136, 57336: 115040,
    59256: 118560, 61664: 123392, 63776: 127392, 66592: 133208,
    68808: 137792, 71112: 142248, 73712: 146856, 75376: 149776,
}


def rbg_size(n_prb: int) -> int:
    """Type-0 resource block group size P (36.213 Table 7.1.6.1-1)."""
    if n_prb <= 10:
        return 1
    if n_prb <= 26:
        return 2
    if n_prb <= 63:
        return 3
    return 4


def n_gap1(n_prb: int) -> int:
    """36.211 Table 6.2.3.2-1 gap-1 values."""
    if n_prb <= 10:
        return -(-n_prb // 2)
    if n_prb == 11:
        return 4
    if n_prb <= 19:
        return 8
    if n_prb <= 26:
        return 12
    if n_prb <= 44:
        return 18
    if n_prb <= 49:
        return 27
    if n_prb <= 63:
        return 27
    if n_prb <= 79:
        return 32
    return 48


# ---------------------------------------------------------------------------
# Turbo QPP interleaver coefficients (36.212 Table 5.1.3-3)
# ---------------------------------------------------------------------------

def qpp_interleave_indices(k: int) -> np.ndarray:
    f1, f2 = _data.QPP_F1_F2[k]
    x = np.arange(k, dtype=np.int64)
    return (f1 * x + f2 * x * x) % k
