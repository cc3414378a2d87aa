"""Test-side LTE downlink transmitter (NumPy).

Synthesizes eNodeB subframes — CRS, PSS/SSS, PCFICH, PDCCH (and later PDSCH)
— so the sniffer pipeline can be validated end-to-end without recorded IQ,
formalizing the verification strategy the reference lacks (SURVEY.md §4).

This module is intentionally an *independent* implementation path from the RX
kernels: it maps bits to the grid directly from the spec text, while the RX
side inverts precomputed index maps; agreement between the two is the test.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ltesniffer_tpu_torch.phy import conv, crc, dci as dci_mod, grid as grid_mod
from ltesniffer_tpu_torch.phy import modulation, sequences
from ltesniffer_tpu_torch.phy.params import CellConfig, N_SYM_SF
from ltesniffer_tpu_torch.kernels import ofdm


@dataclasses.dataclass
class TxDci:
    dci: dci_mod.Dci
    L: int         # aggregation level exponent l (0..3) -> 2^l CCEs
    ncce: int


def _sfbc_precode(x: np.ndarray):
    """36.211 6.3.4.3 2-port SFBC: symbols x (even length) -> (2, len) per-port."""
    x0, x1 = x[0::2], x[1::2]
    p0 = np.empty_like(x)
    p1 = np.empty_like(x)
    p0[0::2], p0[1::2] = x0, x1
    p1[0::2], p1[1::2] = -np.conj(x1), np.conj(x0)
    return np.stack([p0, p1]) / np.sqrt(2.0)


def _sfbc4_precode(x: np.ndarray):
    """36.211 6.3.4.3.2 4-port SFBC-FSTD: groups of 4 symbols; pair
    (x0, x1) Alamouti on ports (0, 2) over REs (4i, 4i+1); (x2, x3) on
    ports (1, 3) over REs (4i+2, 4i+3)."""
    assert len(x) % 4 == 0
    out = np.zeros((4, len(x)), dtype=x.dtype)
    x0, x1, x2, x3 = x[0::4], x[1::4], x[2::4], x[3::4]
    out[0, 0::4], out[0, 1::4] = x0, x1
    out[2, 0::4], out[2, 1::4] = -np.conj(x1), np.conj(x0)
    out[1, 2::4], out[1, 3::4] = x2, x3
    out[3, 2::4], out[3, 3::4] = -np.conj(x3), np.conj(x2)
    return out / np.sqrt(2.0)


def _txdiv_precode(x: np.ndarray, ports: int):
    if ports >= 4:
        return _sfbc4_precode(x)
    if ports >= 2:
        return _sfbc_precode(x)
    return x[None, :]


def build_control_subframe(cell: CellConfig, sf_idx: int, cfi: int,
                           tx_dcis: Sequence[TxDci]) -> np.ndarray:
    """Build per-port TX resource grids (ports, 14, n_sc) for one subframe."""
    n_sc = cell.n_sc
    ports = cell.nof_ports
    g = np.zeros((ports, N_SYM_SF, n_sc), dtype=np.complex64)

    # --- CRS ---------------------------------------------------------------
    mask, vals = sequences.crs_grid(cell.n_id_cell, sf_idx, cell.n_prb, ports)
    for p in range(ports):
        g[p][mask[p]] = vals[p][mask[p]]

    # --- PSS / SSS (subframes 0 and 5, last two symbols of slot 0) ---------
    if sf_idx in (0, 5):
        center = n_sc // 2
        kidx = np.arange(-31, 31) + center  # 62 subcarriers around DC
        pss = sequences.pss_sequence(cell.n_id_2)
        sss = sequences.sss_sequence(cell.n_id_1, cell.n_id_2, sf_idx == 5)
        g[0, 6, kidx] += pss
        g[0, 5, kidx] += sss.astype(np.complex64)

    # --- PCFICH ------------------------------------------------------------
    reg = grid_mod.control_region(cell, cfi)
    cw = grid_mod.cfi_codeword(cfi) ^ grid_mod.pcfich_scrambling(cell, sf_idx)
    syms = modulation.modulate(cw, 2)          # 16 QPSK symbols
    per_port = _txdiv_precode(syms, ports)
    for qi, r in enumerate(reg["pcfich_regs"]):
        for j, k in enumerate(r.res):
            for p in range(per_port.shape[0]):
                g[p, r.l, k] = per_port[p, 4 * qi + j]

    # --- PDCCH -------------------------------------------------------------
    m_quad = reg["nof_pdcch_regs"]
    total_bits = 8 * m_quad          # incl. NIL tail (REGs beyond 9*nof_cce)
    bits = np.zeros(total_bits, dtype=np.uint8)
    active = np.zeros(total_bits, dtype=bool)
    for t in tx_dcis:
        payload = dci_mod.pack(t.dci, cell)
        coded = crc.attach_crc(payload, crc.CRC16, mask=t.dci.rnti)
        e = conv.rate_match(conv.conv_encode_tb(coded), 72 * (1 << t.L))
        a, b = 72 * t.ncce, 72 * t.ncce + len(e)
        bits[a:b] = e
        active[a:b] = True
    scr = grid_mod.pdcch_scrambling(cell, sf_idx, total_bits)
    bits = bits ^ scr
    syms = modulation.modulate(bits, 2)
    syms = np.where(active[0::2] | active[1::2], syms, 0.0)  # NIL CCEs: no power
    per_port = _txdiv_precode(syms, ports)
    # zero power stays zero under SFBC pairing (groups are CCE-aligned)
    tx_map, _ = grid_mod.pdcch_interleave_maps(cell, cfi)
    for j, r in enumerate(reg["pdcch_regs"]):
        q = tx_map[j]          # quadruplet index in CCE order
        for jj, k in enumerate(r.res):
            for p in range(per_port.shape[0]):
                g[p, r.l, k] = per_port[p, 4 * q + jj]
    return g


def apply_channel(tx_grids: np.ndarray, h: np.ndarray, noise_std: float,
                  rng: np.random.Generator) -> np.ndarray:
    """tx_grids (P, 14, n_sc) x h (RX, P, 14, n_sc) + AWGN -> (RX, 14, n_sc)."""
    rx = np.einsum("rpls,pls->rls", h, tx_grids)
    noise = (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return (rx + noise_std / np.sqrt(2.0) * noise).astype(np.complex64)


def flat_channel(cell: CellConfig, nof_rx: int, rng: np.random.Generator,
                 selective: bool = True) -> np.ndarray:
    """Random mildly frequency-selective channel (RX, P, 14, n_sc)."""
    P = cell.nof_ports
    n_sc = cell.n_sc
    if not selective:
        h0 = (rng.standard_normal((nof_rx, P)) + 1j * rng.standard_normal((nof_rx, P))) / np.sqrt(2.0)
        h = np.broadcast_to(h0[:, :, None, None], (nof_rx, P, N_SYM_SF, n_sc))
        return h.astype(np.complex64)
    # two-tap channel -> smooth frequency ripple
    taps = (rng.standard_normal((nof_rx, P, 2)) + 1j * rng.standard_normal((nof_rx, P, 2)))
    taps = taps / np.sqrt(4.0)
    k = np.arange(n_sc) / n_sc
    h = taps[..., 0:1] + taps[..., 1:2] * np.exp(-2j * np.pi * 3 * k)[None, None, :]
    h = np.broadcast_to(h[:, :, None, :], (nof_rx, P, N_SYM_SF, n_sc))
    return h.astype(np.complex64)


def subframe_iq(cell: CellConfig, rx_grids: np.ndarray) -> np.ndarray:
    """(RX, 14, n_sc) grids -> (RX, sf_len) time-domain samples."""
    return np.stack([ofdm.modulate_np(gr, cell) for gr in rx_grids])


# ---------------------------------------------------------------------------
# PDSCH transmitter (test side)
# ---------------------------------------------------------------------------
def encode_pdsch_bits(tb_bits: np.ndarray, qm: int, G: int, rv: int = 0):
    """Transport block -> G rate-matched, concatenated coded bits."""
    from ltesniffer_tpu_torch.phy import turbo as turbo_mod
    from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod
    seg, blocks = turbo_mod.segment(tb_bits)
    es = pdsch_mod.cb_rate_match_sizes(G, seg.C, qm)
    out = []
    for blk, e in zip(blocks, es):
        d = turbo_mod.turbo_encode(blk)
        out.append(turbo_mod.rate_match_turbo(d, e, rv=rv))
    return np.concatenate(out), seg


def add_pdsch(g: np.ndarray, cell: CellConfig, sf_idx: int, cfi: int,
              rnti: int, prb_mask: np.ndarray, qm: int, tb_bits: np.ndarray,
              rv: int = 0, prb_mask_slot1: np.ndarray | None = None,
              amplitude: float = 1.0):
    """Encode and map one PDSCH transport block onto per-port grids ``g``.

    TM1 (1 port) or TM2/SFBC (2 ports).  ``amplitude`` scales the PDSCH
    REs relative to CRS — the eNB's rho_A = 10^(p_a/20) power offset.
    Returns G (bit capacity used).
    """
    from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod
    from ltesniffer_tpu_torch.phy import sequences as seq_mod
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask,
                                        prb_mask_slot1)
    n_re = len(re_idx)
    G = n_re * qm
    coded, _seg = encode_pdsch_bits(tb_bits, qm, G, rv)
    c_init = pdsch_mod.scrambling_cinit(rnti, 0, sf_idx, cell.n_id_cell)
    scr = seq_mod.gold_sequence(c_init, G)
    bits = coded ^ scr
    syms = modulation.modulate(bits, qm) * np.complex64(amplitude)
    per_port = _txdiv_precode(syms, cell.nof_ports)
    flat = g.reshape(g.shape[0], -1)
    for p in range(per_port.shape[0]):
        flat[p, re_idx] = per_port[p]
    return G


def add_pbch(g: np.ndarray, cell: CellConfig, sfn: int):
    """Map the PBCH segment for this radio frame onto a subframe-0 grid."""
    from ltesniffer_tpu_torch.sniffer import pbch_rx
    mib = pbch_rx.pack_mib(cell.n_prb, cell.phich_resources,
                           cell.phich_length, sfn)
    full = pbch_rx.encode_pbch(cell.n_id_cell, mib, cell.nof_ports)
    f = sfn % 4
    seg = full[480 * f: 480 * (f + 1)]
    syms = modulation.modulate(seg, 2)           # 240 QPSK symbols
    per_port = _txdiv_precode(syms, cell.nof_ports)
    re_idx = pbch_rx.pbch_re_indices(cell)
    flat = g.reshape(g.shape[0], -1)
    for p in range(per_port.shape[0]):
        flat[p, re_idx] = per_port[p]


def add_pdsch_mimo(g: np.ndarray, cell: CellConfig, sf_idx: int, cfi: int,
                   rnti: int, prb_mask: np.ndarray, qms, tbs_bits,
                   tm: int, pmi: int = 0, rvs=(0, 0)):
    """Spatial-multiplexed PDSCH: 2 codewords -> 2 layers -> 2 or 4 ports.

    tm: 3 (open-loop CDD) or 4 (closed-loop, ``pmi`` codebook index).
    qms/tbs_bits/rvs: per-codeword modulation order, TB bits, rv.
    4 ports: the rank-2 subset (36.211 Table 6.3.4.2.3-2 householder
    codebook; TM3 cycles codebook indices 12..15 every 2 REs)."""
    from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod
    from ltesniffer_tpu_torch.phy import sequences as seq_mod
    from ltesniffer_tpu_torch.kernels import mimo as mimo_mod
    assert cell.nof_ports in (2, 4)
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask)
    n_re = len(re_idx)
    layers = []
    for q, (qm, tb, rv) in enumerate(zip(qms, tbs_bits, rvs)):
        G = n_re * qm
        coded, _ = encode_pdsch_bits(tb, qm, G, rv)
        c_init = pdsch_mod.scrambling_cinit(rnti, q, sf_idx, cell.n_id_cell)
        bits = coded ^ seq_mod.gold_sequence(c_init, G)
        layers.append(modulation.modulate(bits, qm))
    x = np.stack(layers)                       # (2, n_re)
    n_ports = cell.nof_ports
    if tm == 4:
        W = (mimo_mod.pmi_matrix_2layer_4tx(pmi) if n_ports == 4
             else mimo_mod.pmi_matrix_2layer(pmi))   # (ports, layers)
        ports = W @ x
    else:  # TM3 large-delay CDD
        U = mimo_mod._U_CDD
        s = 1.0 - 2.0 * (np.arange(n_re) % 2)
        ux = U @ x                             # (2, n_re)
        ux[1] *= s                             # D(i)
        if n_ports == 4:
            ports = np.zeros((4, n_re), np.complex64)
            ks = (np.arange(n_re) // 2) % 4
            for k in range(4):
                Wk = mimo_mod.pmi_matrix_2layer_4tx(12 + k)
                sel = ks == k
                ports[:, sel] = Wk @ ux[:, sel]
        else:
            ports = mimo_mod._W_CDD @ ux
    flat = g.reshape(g.shape[0], -1)
    for p in range(n_ports):
        flat[p, re_idx] = ports[p]


# ---------------------------------------------------------------------------
# Uplink (PUSCH) transmitter — test side
# ---------------------------------------------------------------------------
def ul_channel_interleave(bits: np.ndarray, qm: int) -> np.ndarray:
    """PUSCH channel interleaver, no UCI (36.212 5.2.2.8): Qm-bit groups
    written row-wise into (R', 12), read column-wise."""
    groups = bits.reshape(-1, qm)
    Hp = len(groups)
    Rp = Hp // 12
    mat = groups.reshape(Rp, 12, qm)
    return np.transpose(mat, (1, 0, 2)).reshape(-1)


def build_ul_subframe(cell: CellConfig, sf_idx: int, grants,
                      cyclic_shift_cfg: int = 0) -> np.ndarray:
    """Build a (1, 14, n_sc) UL TX grid with PUSCH transmissions.

    grants: list of dicts with rnti, prb_start, n_prb, qm, tb_bits, rv,
    dmrs_field (3-bit DCI0 cyclic shift), and optionally n_ri_syms /
    n_ack_syms (UCI symbol groups: RI displaces data, ACK punctures).
    """
    from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod
    from ltesniffer_tpu_torch.phy import sequences as seq_mod
    from ltesniffer_tpu_torch.phy import ul_dmrs, uci
    from ltesniffer_tpu_torch.kernels import scfdma
    g = np.zeros((1, N_SYM_SF, cell.n_sc), dtype=np.complex64)
    rng_uci = np.random.default_rng(1234)
    for gr in grants:
        m_sc = 12 * gr["n_prb"]
        k0 = 12 * gr["prb_start"]
        qm = gr["qm"]
        n_ri = gr.get("n_ri_syms", 0)
        n_ack = gr.get("n_ack_syms", 0)
        n_cqi = gr.get("n_cqi_syms", 0)
        G = (12 * m_sc - n_ri - n_cqi) * qm
        coded, _ = encode_pdsch_bits(gr["tb_bits"], qm, G, gr.get("rv", 0))
        if n_ri or n_ack or n_cqi:
            cells = uci.data_group_map(m_sc, n_ri)
            ri_cells, ack_cells = uci.uci_positions(m_sc, qm, n_ri, n_ack)
            mat = np.zeros((m_sc * 12, qm), dtype=np.uint8)
            # CQI coded bits head the multiplexed stream (36.212 5.2.2.8)
            for c in cells[:n_cqi]:
                mat[c] = rng_uci.integers(0, 2, qm)
            mat[cells[n_cqi:]] = coded.reshape(-1, qm)
            for c in ri_cells:      # RI symbols (content irrelevant to data)
                mat[c] = rng_uci.integers(0, 2, qm)
            for c in ack_cells:     # ACK punctures the data at these cells
                mat[c] = rng_uci.integers(0, 2, qm)
            grp = mat.reshape(m_sc, 12, qm)
            inter = np.transpose(grp, (1, 0, 2)).reshape(-1)
            G = 12 * m_sc * qm
        else:
            inter = ul_channel_interleave(coded, qm)
        c_init = pdsch_mod.scrambling_cinit(gr["rnti"], 0, sf_idx,
                                            cell.n_id_cell)
        bits = inter ^ seq_mod.gold_sequence(c_init, G)
        syms = modulation.modulate(bits, qm)
        spread = scfdma.dft_precode_np(syms, m_sc).reshape(12, m_sc)
        for ci, l in enumerate(scfdma.DATA_SYMS):
            g[0, l, k0:k0 + m_sc] = spread[ci]
        for slot_i, l in enumerate(scfdma.DMRS_SYM):
            ns = 2 * sf_idx + slot_i
            g[0, l, k0:k0 + m_sc] = ul_dmrs.pusch_dmrs(
                gr["n_prb"], ns, cell.n_id_cell, cyclic_shift_cfg,
                gr.get("dmrs_field", 0))
    return g


def ul_subframe_iq(cell: CellConfig, rx_grid: np.ndarray) -> np.ndarray:
    """(RX, 14, n_sc) UL grids -> (RX, sf_len) SC-FDMA time samples."""
    from ltesniffer_tpu_torch.kernels import scfdma
    return np.stack([scfdma.modulate_ul_np(gr, cell) for gr in rx_grid])
