"""The downlink transmitter (NumPy): control region, PBCH, PDSCH (one
codeword with transmit diversity, or two codewords with TM3 / TM4 spatial
multiplexing), the radio channel, OFDM and the 8-bit IQ packing an SDR
front-end delivers.

A frozen copy of the port's `testing/encoder.py` (with the pieces of
`sniffer/pbch_rx.py`, `kernels/mimo.py`, `kernels/ofdm.py`,
`kernels/cplx.py` and `mac_rrc/mac.py` that it uses), so that the
benchmark's input stays put when the port's test helpers change.  It maps
bits to the grid from the spec text, independently of the receiver.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from .lte import conv, crc, dci as dci_mod, grid as grid_mod
from .lte import modulation, pdsch as pdsch_mod, sequences, turbo
from .lte.params import CellConfig, N_SYM_SF, cp_lengths


@dataclasses.dataclass
class TxDci:
    dci: dci_mod.Dci
    L: int         # aggregation level exponent l (0..3) -> 2^l CCEs
    ncce: int


def _sfbc_precode(x: np.ndarray):
    """36.211 6.3.4.3 2-port SFBC: symbols x (even length) -> (2, len)."""
    x0, x1 = x[0::2], x[1::2]
    p0 = np.empty_like(x)
    p1 = np.empty_like(x)
    p0[0::2], p0[1::2] = x0, x1
    p1[0::2], p1[1::2] = -np.conj(x1), np.conj(x0)
    return np.stack([p0, p1]) / np.sqrt(2.0)


def _sfbc4_precode(x: np.ndarray):
    """36.211 6.3.4.3.2 4-port SFBC-FSTD."""
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
    """Per-port TX resource grids (ports, 14, n_sc) for one subframe: CRS,
    PSS / SSS, PCFICH and the PDCCH carrying `tx_dcis`."""
    n_sc = cell.n_sc
    ports = cell.nof_ports
    g = np.zeros((ports, N_SYM_SF, n_sc), dtype=np.complex64)
    mask, vals = sequences.crs_grid(cell.n_id_cell, sf_idx, cell.n_prb, ports)
    for p in range(ports):
        g[p][mask[p]] = vals[p][mask[p]]
    if sf_idx in (0, 5):
        center = n_sc // 2
        kidx = np.arange(-31, 31) + center
        pss = sequences.pss_sequence(cell.n_id_2)
        sss = sequences.sss_sequence(cell.n_id_1, cell.n_id_2, sf_idx == 5)
        g[0, 6, kidx] += pss
        g[0, 5, kidx] += sss.astype(np.complex64)
    reg = grid_mod.control_region(cell, cfi)
    cw = grid_mod.cfi_codeword(cfi) ^ grid_mod.pcfich_scrambling(cell, sf_idx)
    per_port = _txdiv_precode(modulation.modulate(cw, 2), ports)
    for qi, r in enumerate(reg["pcfich_regs"]):
        for j, k in enumerate(r.res):
            for p in range(per_port.shape[0]):
                g[p, r.l, k] = per_port[p, 4 * qi + j]
    m_quad = reg["nof_pdcch_regs"]
    total_bits = 8 * m_quad
    bits = np.zeros(total_bits, dtype=np.uint8)
    active = np.zeros(total_bits, dtype=bool)
    for t in tx_dcis:
        payload = dci_mod.pack(t.dci, cell)
        coded = crc.attach_crc(payload, crc.CRC16, mask=t.dci.rnti)
        e = conv.rate_match(conv.conv_encode_tb(coded), 72 * (1 << t.L))
        a, b = 72 * t.ncce, 72 * t.ncce + len(e)
        bits[a:b] = e
        active[a:b] = True
    bits = bits ^ grid_mod.pdcch_scrambling(cell, sf_idx, total_bits)
    syms = modulation.modulate(bits, 2)
    syms = np.where(active[0::2] | active[1::2], syms, 0.0)  # NIL: no power
    per_port = _txdiv_precode(syms, ports)
    tx_map, _ = grid_mod.pdcch_interleave_maps(cell, cfi)
    for j, r in enumerate(reg["pdcch_regs"]):
        q = tx_map[j]
        for jj, k in enumerate(r.res):
            for p in range(per_port.shape[0]):
                g[p, r.l, k] = per_port[p, 4 * q + jj]
    return g


def apply_channel(tx_grids: np.ndarray, h: np.ndarray, noise_std: float,
                  rng: np.random.Generator) -> np.ndarray:
    """tx_grids (P, 14, n_sc) x h (RX, P, 14, n_sc) + AWGN -> (RX, 14, n_sc)."""
    rx = np.einsum("rpls,pls->rls", h, tx_grids)
    noise = (rng.standard_normal(rx.shape)
             + 1j * rng.standard_normal(rx.shape))
    return (rx + noise_std / np.sqrt(2.0) * noise).astype(np.complex64)


def flat_channel(cell: CellConfig, nof_rx: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Random mildly frequency-selective two-tap channel (RX, P, 14, n_sc)."""
    P = cell.nof_ports
    taps = (rng.standard_normal((nof_rx, P, 2))
            + 1j * rng.standard_normal((nof_rx, P, 2))) / np.sqrt(4.0)
    k = np.arange(cell.n_sc) / cell.n_sc
    h = taps[..., 0:1] + taps[..., 1:2] * np.exp(
        -2j * np.pi * 3 * k)[None, None, :]
    h = np.broadcast_to(h[:, :, None, :], (nof_rx, P, N_SYM_SF, cell.n_sc))
    return h.astype(np.complex64)


# --- OFDM (36.211 6.12) ------------------------------------------------
@functools.lru_cache(maxsize=8)
def _symbol_starts(n_fft: int):
    starts, off = [], 0
    for _slot in range(2):
        for cp in cp_lengths(n_fft):
            off += cp
            starts.append(off)
            off += n_fft
    return tuple(starts)


@functools.lru_cache(maxsize=8)
def _subcarrier_bins(n_fft: int, n_sc: int) -> np.ndarray:
    k = np.arange(n_sc)
    f = np.where(k < n_sc // 2, k - n_sc // 2, k - n_sc // 2 + 1)
    return np.where(f < 0, f + n_fft, f).astype(np.int64)


def ofdm_modulate(grid: np.ndarray, cell: CellConfig) -> np.ndarray:
    """Resource grid (14, n_sc) -> time samples (sf_len,), normal CP."""
    n_fft = cell.n_fft
    bins = _subcarrier_bins(n_fft, cell.n_sc)
    out = np.zeros(cell.sf_len, dtype=np.complex64)
    starts = _symbol_starts(n_fft)
    cps = cp_lengths(n_fft) * 2
    for i in range(N_SYM_SF):
        spec = np.zeros(n_fft, dtype=np.complex64)
        spec[bins] = grid[i]
        td = np.fft.ifft(spec) * np.sqrt(n_fft)
        s, cp = starts[i], cps[i]
        out[s:s + n_fft] = td
        out[s - cp:s] = td[-cp:]
    return out


def subframe_iq(cell: CellConfig, rx_grids: np.ndarray) -> np.ndarray:
    """(RX, 14, n_sc) grids -> (RX, sf_len) time-domain samples."""
    return np.stack([ofdm_modulate(gr, cell) for gr in rx_grids])


def to_i8_packed(x: np.ndarray):
    """complex64 frames (B, RX, n) -> ((B, RX, n/2) '<i4' words of packed
    int8 IQ, (B,) float32 per-subframe scales): an 8-bit front-end with a
    per-subframe AGC (peak at 126)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    ri = x.view(np.float32).reshape(*x.shape, 2)
    B = ri.shape[0]
    flat = ri.reshape(B, -1)
    peak = np.maximum(flat.max(axis=1), -flat.min(axis=1))
    peak[peak == 0] = 1.0
    scales = (peak / 126.0).astype(np.float32)
    q = np.multiply(ri, (1.0 / scales)[:, None, None, None], dtype=np.float32)
    np.rint(q, out=q)
    packed = (np.ascontiguousarray(q.astype(np.int8))
              .reshape(B, ri.shape[1], -1).view(np.dtype("<i4")))
    return packed, scales


# --- PDSCH ---------------------------------------------------------------
def encode_pdsch_bits(tb_bits: np.ndarray, qm: int, G: int, rv: int = 0):
    """Transport block -> G rate-matched, concatenated coded bits."""
    seg, blocks = turbo.segment(tb_bits)
    es = pdsch_mod.cb_rate_match_sizes(G, seg.C, qm)
    out = [turbo.rate_match_turbo(turbo.turbo_encode(blk), e, rv=rv)
           for blk, e in zip(blocks, es)]
    return np.concatenate(out), seg


def add_pdsch(g: np.ndarray, cell: CellConfig, sf_idx: int, cfi: int,
              rnti: int, prb_mask: np.ndarray, qm: int, tb_bits: np.ndarray,
              rv: int = 0):
    """Encode and map one PDSCH transport block (TM1 / TM2 SFBC)."""
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask)
    G = len(re_idx) * qm
    coded, _seg = encode_pdsch_bits(tb_bits, qm, G, rv)
    c_init = pdsch_mod.scrambling_cinit(rnti, 0, sf_idx, cell.n_id_cell)
    bits = coded ^ sequences.gold_sequence(c_init, G)
    per_port = _txdiv_precode(modulation.modulate(bits, qm), cell.nof_ports)
    flat = g.reshape(g.shape[0], -1)
    for p in range(per_port.shape[0]):
        flat[p, re_idx] = per_port[p]
    return G


# 36.211 Table 6.3.4.2.3-1: 2-port codebook, 2 layers
_CB_2LAYER = np.stack([
    np.eye(2, dtype=np.complex64) / np.sqrt(2.0),
    np.array([[1, 1], [1, -1]], dtype=np.complex64) / 2.0,
    np.array([[1, 1], [1j, -1j]], dtype=np.complex64) / 2.0,
])
# large-delay CDD fixed matrices (2 ports, 36.211 6.3.4.2.2)
_U_CDD = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2.0)
_W_CDD = np.eye(2, dtype=np.complex64) / np.sqrt(2.0)


def add_pdsch_mimo(g: np.ndarray, cell: CellConfig, sf_idx: int, cfi: int,
                   rnti: int, prb_mask: np.ndarray, qms, tbs_bits,
                   tm: int, pmi: int = 0, rvs=(0, 0)):
    """Spatial-multiplexed PDSCH on 2 ports: 2 codewords -> 2 layers.
    tm 3 (open-loop large-delay CDD) or 4 (closed loop, codebook `pmi`)."""
    if cell.nof_ports != 2:
        raise ValueError("the transmitter's TM3 / TM4 takes 2 ports")
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask)
    n_re = len(re_idx)
    layers = []
    for q, (qm, tb, rv) in enumerate(zip(qms, tbs_bits, rvs)):
        G = n_re * qm
        coded, _ = encode_pdsch_bits(tb, qm, G, rv)
        c_init = pdsch_mod.scrambling_cinit(rnti, q, sf_idx, cell.n_id_cell)
        bits = coded ^ sequences.gold_sequence(c_init, G)
        layers.append(modulation.modulate(bits, qm))
    x = np.stack(layers)
    if tm == 4:
        ports = _CB_2LAYER[pmi] @ x
    else:
        s = 1.0 - 2.0 * (np.arange(n_re) % 2)
        ux = _U_CDD @ x
        ux[1] *= s                             # D(i)
        ports = _W_CDD @ ux
    flat = g.reshape(g.shape[0], -1)
    for p in range(2):
        flat[p, re_idx] = ports[p]


# --- PBCH (36.211 6.6, 36.212 5.3.1, 36.331 MasterInformationBlock) -----
PBCH_SYMS = (7, 8, 9, 10)
E_TOTAL = 1920
_ANT_MASK = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}
_BW_TABLE = (6, 15, 25, 50, 75, 100)
_NG_TABLE = (1 / 6, 1 / 2, 1.0, 2.0)


def pbch_re_indices(cell: CellConfig) -> np.ndarray:
    """Flat (l * n_sc + k) indices of the 240 PBCH REs."""
    center = cell.n_sc // 2
    vshift3 = cell.n_id_cell % 3
    out = []
    for i, l in enumerate(PBCH_SYMS):
        ks = np.arange(center - 36, center + 36)
        if i < 2:
            ks = ks[(ks % 3) != vshift3]
        out.append(l * cell.n_sc + ks)
    return np.concatenate(out).astype(np.int32)


def pack_mib(n_prb: int, phich_ng: float, phich_len: int,
             sfn: int) -> np.ndarray:
    bw = _BW_TABLE.index(n_prb)
    ng = _NG_TABLE.index(phich_ng)
    bits = [(bw >> (2 - i)) & 1 for i in range(3)]
    bits.append(phich_len & 1)
    bits += [(ng >> (1 - i)) & 1 for i in range(2)]
    msb = (sfn >> 2) & 0xFF
    bits += [(msb >> (7 - i)) & 1 for i in range(8)]
    bits += [0] * 10
    return np.array(bits, dtype=np.uint8)


def add_pbch(g: np.ndarray, cell: CellConfig, sfn: int):
    """Map this radio frame's PBCH segment onto a subframe-0 grid."""
    mib = pack_mib(cell.n_prb, cell.phich_resources, cell.phich_length, sfn)
    coded = crc.attach_crc(mib, crc.CRC16, mask=_ANT_MASK[cell.nof_ports])
    e = conv.rate_match(conv.conv_encode_tb(coded), E_TOTAL)
    full = e ^ sequences.gold_sequence(cell.n_id_cell, E_TOTAL)
    f = sfn % 4
    seg = full[480 * f: 480 * (f + 1)]
    per_port = _txdiv_precode(modulation.modulate(seg, 2), cell.nof_ports)
    flat = g.reshape(g.shape[0], -1)
    idx = pbch_re_indices(cell)
    for p in range(per_port.shape[0]):
        flat[p, idx] = per_port[p]


def mac_pdu_one_sdu(lcid: int, payload: bytes) -> bytes:
    """A DL-SCH MAC PDU of one SDU with the implicit-length subheader
    (36.321 6.1.2): E = 0, the LCID, then the SDU."""
    return bytes([lcid & 0x1F]) + payload
