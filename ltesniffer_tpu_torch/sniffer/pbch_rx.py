"""PBCH / MIB decode (36.211 6.6, 36.212 5.3.1).

Decodes the MIB (bandwidth, PHICH config, SFN MSBs) plus the implicit
antenna-port count (CRC mask) and 40 ms frame phase (scrambling segment).
All 8 (frame-phase x port) hypotheses are decoded in one batched Viterbi
call.  Counterpart of `ltesniffer_tpu/sniffer/pbch_rx.py`; replaces
`srsran_ue_mib_decode` (`src/src/LTESniffer_Core.cc:386`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import conv, crc, sequences
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import chest, demapper, viterbi
from ltesniffer_tpu_torch.kernels.cplx import const
from . import prof

PBCH_SYMS = (7, 8, 9, 10)      # subframe-0 symbols (slot 1, l=0..3)
E_FRAME = 480                  # coded bits per radio frame
E_TOTAL = 1920
D_MIB = 40                     # 24 MIB + 16 CRC

_ANT_MASK = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}  # 0101.. pattern for 4 ports
_BW_TABLE = (6, 15, 25, 50, 75, 100)
_NG_TABLE = (1 / 6, 1 / 2, 1.0, 2.0)


def pbch_re_indices(cell: CellConfig) -> np.ndarray:
    """Flat (l*n_sc + k) indices of the 240 PBCH REs (center 72 sc, minus
    4-port CRS positions in the first two symbols)."""
    n_sc = cell.n_sc
    center = n_sc // 2
    vshift3 = cell.n_id_cell % 3
    out = []
    for i, l in enumerate(PBCH_SYMS):
        ks = np.arange(center - 36, center + 36)
        if i < 2:
            ks = ks[(ks % 3) != vshift3]
        out.append(l * n_sc + ks)
    return np.concatenate(out).astype(np.int32)


def pack_mib(n_prb: int, phich_ng: float, phich_len: int, sfn: int) -> np.ndarray:
    """MIB -> 24 bits (36.331 MasterInformationBlock, spare zeroed)."""
    bw = _BW_TABLE.index(n_prb)
    ng = _NG_TABLE.index(phich_ng)
    bits = []
    bits += [(bw >> (2 - i)) & 1 for i in range(3)]
    bits.append(phich_len & 1)
    bits += [(ng >> (1 - i)) & 1 for i in range(2)]
    msb = (sfn >> 2) & 0xFF
    bits += [(msb >> (7 - i)) & 1 for i in range(8)]
    bits += [0] * 10
    return np.array(bits, dtype=np.uint8)


def unpack_mib(bits: np.ndarray):
    b = [int(x) for x in bits]
    bw = (b[0] << 2) | (b[1] << 1) | b[2]
    phich_len = b[3]
    ng = (b[4] << 1) | b[5]
    msb = 0
    for i in range(8):
        msb = (msb << 1) | b[6 + i]
    if bw >= len(_BW_TABLE):
        return None
    return {"n_prb": _BW_TABLE[bw], "phich_length": phich_len,
            "phich_ng": _NG_TABLE[ng], "sfn_msb": msb}


def encode_pbch(cell_n_id: int, mib_bits: np.ndarray, nof_ports: int) -> np.ndarray:
    """MIB -> full 1920-bit scrambled PBCH sequence (test TX side)."""
    coded = crc.attach_crc(mib_bits, crc.CRC16, mask=_ANT_MASK[nof_ports])
    e = conv.rate_match(conv.conv_encode_tb(coded), E_TOTAL)
    scr = sequences.gold_sequence(cell_n_id, E_TOTAL)
    return e ^ scr


@dataclasses.dataclass
class MibResult:
    ok: bool
    nof_ports: int = 0
    frame_phase: int = 0     # 0..3 within the 40 ms PBCH period
    sfn: int = 0             # full SFN (msb*4 + frame_phase)
    n_prb: int = 0
    phich_ng: float = 1.0
    phich_length: int = 0


@prof.factory(16)
def _make_decoder(cell: CellConfig):
    re_idx = pbch_re_indices(cell).astype(np.int64)
    scr = (1.0 - 2.0 * sequences.gold_sequence(cell.n_id_cell, E_TOTAL)
           ).astype(np.float32)
    maps = conv.rate_match_maps(D_MIB, E_TOTAL)
    W = np.zeros((E_TOTAL, 3 * D_MIB), dtype=np.float32)
    W[np.arange(E_TOTAL), maps["e_to_d"]] = 1.0

    def run(grids, h, noise_var):
        """One subframe-0: returns decoded bits (4*n_hyp, 40) for the
        (equalizer hypothesis x frame_phase) rows."""
        dev = grids.device
        idx = const(re_idx, dev)
        y = grids.reshape(grids.shape[0], -1, 2)[None][:, :, idx, :]
        hh = h.reshape(h.shape[0], h.shape[1], -1, 2)[None][:, :, :, idx, :]
        nv = noise_var.reshape(1)
        x1 = chest.equalize_port0(y, hh[:, :, 0], nv)[0]             # (240,2)
        x2 = chest.equalize_sfbc(y, hh[:, :, :2], nv)[0] if h.shape[1] >= 2 \
            else x1
        hyps = [x1, x2]
        if h.shape[1] >= 4:       # 4-port SFBC-FSTD hypothesis
            hyps.append(chest.equalize_sfbc4(y, hh[:, :, :4], nv)[0])
        scr_t = const(scr, dev)
        W_t = const(W, dev)
        rows = []
        for x in hyps:
            llr = demapper.qpsk_llr(x)                               # (480,)
            for f in range(4):
                full = torch.zeros(E_TOTAL, dtype=torch.float32, device=dev)
                full[f * E_FRAME:(f + 1) * E_FRAME] = llr
                full = full * scr_t
                rows.append(torch.einsum("e,ek->k", full, W_t))
        d = torch.stack(rows).reshape(4 * len(hyps), 3, D_MIB)
        return viterbi.viterbi_decode_tb(d)

    return run


def _host(bits, site: str) -> np.ndarray:
    return (prof.host_read(site, bits).numpy()
            if isinstance(bits, torch.Tensor) else np.asarray(bits))


def decode_mib(grids_b, h_b, noise_var_b, cell: CellConfig) -> MibResult:
    """Try to decode the MIB from one subframe-0 grid.

    grids_b: (RX, 14, n_sc, 2); h_b: (RX, P, 14, n_sc, 2); noise_var_b: a
    0-dim tensor — one subframe of the frontend's batch, on its device.
    The only device->host transfer is the decoded-bit matrix."""
    return resolve_mib_bits(_host(_make_decoder(cell)(grids_b, h_b,
                                                      noise_var_b),
                                  "decode_mib"))


def decode_mib_at(grids_B, h_B, noise_var_B, i: int,
                  cell: CellConfig) -> MibResult:
    """decode_mib on batch position ``i``."""
    return resolve_mib_bits(_host(dispatch_mib_at(grids_B, h_B,
                                                  noise_var_B, i, cell),
                                  "decode_mib_at"))


def dispatch_mib_at(grids_B, h_B, noise_var_B, i: int, cell: CellConfig):
    """Async half of `decode_mib_at`: queue the device decode and return the
    device tensor of decoded bits.  Resolve later with
    `resolve_mib_bits(bits.cpu().numpy())`."""
    return _make_decoder(cell)(grids_B[i], h_B[i], noise_var_B[i])


def resolve_mib_bits(bits: np.ndarray) -> MibResult:
    """Host half of the MIB decode: CRC-mask hypothesis resolution over the
    (4*n_hyp, 40) decoded rows (equalizer hypothesis x frame-phase)."""
    n_hyp = bits.shape[0] // 4
    for hi in range(bits.shape[0]):
        port_hyp = (1, 2, 4)[hi // 4]
        f = hi % 4
        row = bits[hi]
        rem = crc.crc_bits(row[:24], crc.CRC16) ^ row[24:]
        mask_val = crc.bits_to_int(rem)
        # the CRC mask must agree with the equalizer hypothesis; with no
        # dedicated 4-port hypothesis row, the 2-port combiner still
        # detects a 4-port cell via the 0x5555 mask (ports 0/1 carry
        # every pair-A symbol)
        allowed = {1: (1,), 2: ((2, 4) if n_hyp < 3 else (2,)),
                   4: (4,)}[port_hyp]
        for ports in allowed:
            m = _ANT_MASK[ports]
            if mask_val == m:
                mib = unpack_mib(row[:24])
                if mib is None:
                    continue
                return MibResult(
                    ok=True, nof_ports=ports, frame_phase=f,
                    sfn=(mib["sfn_msb"] << 2) | f, n_prb=mib["n_prb"],
                    phich_ng=mib["phich_ng"], phich_length=mib["phich_length"])
    return MibResult(ok=False)
