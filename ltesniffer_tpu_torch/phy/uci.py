"""PUSCH UCI multiplexing positions (36.212 5.2.2.6-5.2.2.8), simplified.

The reference configures UCI (ACK/RI/CQI offsets from the UE-specific DB +
cqi_request) and lets srsRAN demux it inside `srsran_pusch_decode`
(`UL_Sniffer_PUSCH.cc:429-450`).  For the sniffer's purposes the data path
needs two things:

* RI symbols are *inserted* into the channel-interleaver matrix (displacing
  data) at columns {1, 4, 7, 10}, filled bottom-up in the column order
  [1, 10, 7, 4];
* HARQ-ACK symbols *puncture* data at columns {2, 3, 8, 9} (order
  [2, 9, 8, 3], bottom-up) — their LLRs are unreliable for data and zeroed.

Q' (symbol counts) are computed from whatever (n_prb, tbs) the caller
passes; the core passes the TB's INITIAL grant dimensions (tracked per
RNTI by `trackers.UlGrantHistory`), matching 36.212 5.2.2.6's use of the
initial PUSCH allocation for adaptive retransmissions.
"""
from __future__ import annotations

import numpy as np

RI_COLS = (1, 10, 7, 4)
ACK_COLS = (2, 9, 8, 3)
N_COLS = 12

# 36.213 Table 8.6.3-1: I_offset^HARQ-ACK -> beta_offset^HARQ-ACK
BETA_ACK = (2.000, 2.500, 3.125, 4.000, 5.000, 6.250, 8.000, 10.000,
            12.625, 15.875, 20.000, 31.000, 50.000, 80.000, 126.000, 0.0)
# 36.213 Table 8.6.3-2: I_offset^RI -> beta_offset^RI
BETA_RI = (1.250, 1.625, 2.000, 2.500, 3.125, 4.000, 5.000, 6.250,
           8.000, 10.000, 12.625, 15.875, 20.000, 0.0, 0.0, 0.0)
# 36.213 Table 8.6.3-3: I_offset^CQI -> beta_offset^CQI (indices 0-1 reserved)
BETA_CQI = (0.0, 0.0, 1.125, 1.250, 1.375, 1.625, 1.750, 2.000,
            2.250, 2.500, 2.875, 3.125, 3.500, 4.000, 5.000, 6.250)


N_SYMB_PUSCH = 12      # 2*(N_symb_UL - 1), normal CP, no SRS subtraction


def uci_symbol_counts(nof_ack: int, ri_len: int, i_offset_ack: int,
                      i_offset_ri: int, n_prb_initial: int,
                      tbs_initial: int, n_prb_current: int = 0):
    """(n_ri_syms, n_ack_syms) for a PUSCH grant — EXACT 36.212 5.2.2.6:

      Q' = min(ceil(O * M_sc^init * N_symb^init * beta / sum_r K_r),
               4 * M_sc^current)

    with M_sc^init / sum K_r from the TB's INITIAL grant (an adaptive
    retransmission keeps the first allocation's dims) and the 4*M_sc cap
    from the CURRENT grant.  The reference feeds nof_acks (matched from
    the subframe's DL DCIs, `SubframeWorker.cc:319-337`) and the
    UE-config beta offsets into srsRAN's identical computation
    (`UL_Sniffer_PUSCH.cc:429-450`)."""
    if nof_ack <= 0 and ri_len <= 0:
        return 0, 0
    if n_prb_current <= 0:
        n_prb_current = n_prb_initial
    sum_kr = _sum_kr(tbs_initial)
    m_init = 12 * n_prb_initial
    cap = 4 * 12 * n_prb_current
    n_ack = q_prime(nof_ack, BETA_ACK[i_offset_ack & 15], m_init,
                    sum_kr, cap)
    n_ri = q_prime(ri_len, BETA_RI[i_offset_ri & 15], m_init, sum_kr, cap)
    return n_ri, n_ack


def _sum_kr(tbs: int) -> int:
    from ltesniffer_tpu_torch.phy import turbo as turbo_mod
    return int(np.sum(turbo_mod.segment_sizes(tbs).K)) if tbs > 0 else 1


def q_prime(o_bits: int, beta: float, m_sc_initial: int, sum_kr: int,
            cap: int) -> int:
    """Exact Q' (modulation symbols) for HARQ-ACK / RI, 36.212 5.2.2.6."""
    if o_bits <= 0:
        return 0
    q = -(-o_bits * m_sc_initial * N_SYMB_PUSCH * beta // max(sum_kr, 1))
    return int(min(q, cap))


def cqi_hl_subband_size(n_prb: int) -> int:
    """Higher-layer-configured subband size k (36.213 Table 7.2.1-3;
    reference `ul_cqi_hl_get_subband_size`, dl_sniffer_pdsch.c:277-291)."""
    if n_prb < 7:
        return 0
    if n_prb <= 26:
        return 4
    if n_prb <= 63:
        return 6
    return 8


def cqi_hl_subband_count(n_prb: int) -> int:
    """N = ceil(n_prb / k) (`ul_sniffer_cqi_hl_get_no_subbands`,
    dl_sniffer_pdsch.c:294-302)."""
    k = cqi_hl_subband_size(n_prb)
    return -(-n_prb // k) if k else 0


def aperiodic_cqi_bits(n_prb_dl: int, wideband_only: bool = False) -> int:
    """Aperiodic CQI payload O (rank 1, no PMI): the reference configures
    subband-HL CQI on every cqi_request (`UL_Sniffer_PUSCH.cc:437-444`) —
    4-bit wideband CQI + 2-bit differential per subband (36.213 7.2.1
    mode 3-0); wideband-only (mode 2-0 style) is 4 bits."""
    if wideband_only:
        return 4
    return 4 + 2 * cqi_hl_subband_count(n_prb_dl)


def cqi_q_prime(o_cqi: int, i_offset_cqi: int, n_prb_initial: int,
                tbs_initial: int, n_ri_syms: int = 0,
                n_prb_current: int = 0) -> int:
    """Q'_CQI (modulation symbols) — EXACT 36.212 5.2.2.6:

      Q' = min(ceil((O + L) * M_sc^init * N_symb^init * beta / sum_r K_r),
               M_sc^current * N_symb^current - Q'_RI)

    L = 8-bit CRC only when the payload exceeds 11 bits."""
    if o_cqi <= 0:
        return 0
    if n_prb_current <= 0:
        n_prb_current = n_prb_initial
    L = 8 if o_cqi >= 12 else 0
    sum_kr = _sum_kr(tbs_initial)
    beta = BETA_CQI[i_offset_cqi & 15]
    q = -(-(o_cqi + L) * 12 * n_prb_initial * N_SYMB_PUSCH * beta
          // max(sum_kr, 1))
    return int(min(q, 12 * n_prb_current * N_SYMB_PUSCH - n_ri_syms))


def uci_positions(m_sc: int, qm: int, n_ri_syms: int, n_ack_syms: int):
    """Returns (ri_cells, ack_cells): flat indices into the (R', 12) group
    matrix (row-major), bottom-up placement per the spec column orders."""
    rp = m_sc  # rows = M_sc (12 data symbols * m_sc / 12 columns)
    def cells(cols, n):
        out = []
        i = 0
        while len(out) < n:
            col = cols[i % 4]
            row = rp - 1 - (i // 4)
            if row < 0:
                break
            out.append(row * N_COLS + col)
            i += 1
        return out
    return cells(RI_COLS, n_ri_syms), cells(ACK_COLS, n_ack_syms)


def data_group_map(m_sc: int, n_ri_syms: int):
    """Group index mapping with RI holes.

    Returns (data_cells,): the flat (row-major) matrix cells that carry data
    groups, in write order — data fills row-major skipping RI cells.
    Length = 12*m_sc - n_ri_syms.
    """
    rp = m_sc
    total = rp * N_COLS
    ri, _ = uci_positions(m_sc, 0, n_ri_syms, 0)
    ri_set = set(ri)
    return np.array([c for c in range(total) if c not in ri_set],
                    dtype=np.int64)
