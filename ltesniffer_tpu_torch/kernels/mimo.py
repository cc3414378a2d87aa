"""MIMO precoding/equalization for TM3 (open-loop CDD) and TM4 (closed-loop
spatial multiplexing), 2 or 4 ports x 2 layers (36.211 6.3.4.2) —
float-pair torch ops.

Counterpart of `ltesniffer_tpu/kernels/mimo.py` (plain XLA there, torch ops
here: einsums and elementwise float math on the grids' device).  Replaces
the srsRAN MMSE MIMO decode path the reference configures
(`src/src/SubframeWorker.cc:362-374`) and the sniffer-side MIMO config from
DCI (`lib/src/phy/falcon_phch/dl_sniffer_pdsch.c:134-276`).

All equalizers are closed-form 2x2 MMSE solves vectorized over (batch, RE).
The codebooks and the precoding-info tables are numpy constants, shared
with the test-side encoder.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import cplx

# 36.211 Table 6.3.4.2.3-2: 2-port codebook, 1 layer
_CB_1LAYER = np.array([
    [1, 1], [1, -1], [1, 1j], [1, -1j]], dtype=np.complex64) / np.sqrt(2.0)
# 2 layers: index 0: I/sqrt(2); 1: [[1,1],[1,-1]]/2; 2: [[1,1],[j,-j]]/2
_CB_2LAYER = np.stack([
    np.eye(2, dtype=np.complex64) / np.sqrt(2.0),
    np.array([[1, 1], [1, -1]], dtype=np.complex64) / 2.0,
    np.array([[1, 1], [1j, -1j]], dtype=np.complex64) / 2.0,
])

# large-delay CDD fixed matrices (2 ports)
_U_CDD = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2.0)
_W_CDD = np.eye(2, dtype=np.complex64) / np.sqrt(2.0)


def pmi_matrix_1layer(pmi: int) -> np.ndarray:
    return _CB_1LAYER[pmi]


def pmi_matrix_2layer(pmi: int) -> np.ndarray:
    return _CB_2LAYER[pmi]


def decode_pinfo_2tx(pinfo: int, two_tb: bool):
    """DCI format 2 precoding info, 2 TX ports (36.212 Table 5.3.3.1.5-4)."""
    if two_tb:
        return 2, {0: 0, 1: 1, 2: 2}.get(pinfo, 0)
    if pinfo == 0:
        return 0, None
    return 1, pinfo - 1


# ---------------------------------------------------------------------------
# 4 TX ports (36.211 6.3.4.2.3): householder codebook W_n = I - 2 u_n u_n^H
# / (u_n^H u_n), Table 6.3.4.2.3-2.  The RANK-2 subset is implemented (a
# 2-RX sniffer can separate at most 2 layers — the deployed common case;
# rank-3/4 grants are reported as unsupported MIMO config, the reference's
# W_MIMO path).
# ---------------------------------------------------------------------------
_SQ2 = 1.0 / np.sqrt(2.0)
_U4 = np.array([
    [1, -1, -1, -1],
    [1, -1j, 1, 1j],
    [1, 1, -1, 1],
    [1, 1j, 1, -1j],
    [1, (-1 - 1j) * _SQ2, -1j, (1 - 1j) * _SQ2],
    [1, (1 - 1j) * _SQ2, 1j, (-1 - 1j) * _SQ2],
    [1, (1 + 1j) * _SQ2, -1j, (-1 + 1j) * _SQ2],
    [1, (-1 + 1j) * _SQ2, 1j, (1 + 1j) * _SQ2],
    [1, -1, 1, 1],
    [1, -1j, -1, -1j],
    [1, 1, 1, -1],
    [1, 1j, -1, 1j],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, 1, 1, 1],
], dtype=np.complex64)
# 2-layer column selections (1-based in the spec; 0-based here)
_COLS2_4TX = [(0, 3), (0, 1), (0, 1), (0, 1), (0, 3), (0, 3), (0, 2),
              (0, 2), (0, 1), (0, 3), (0, 2), (0, 2), (0, 1), (0, 2),
              (0, 2), (0, 1)]


def pmi_matrix_2layer_4tx(pmi: int) -> np.ndarray:
    """(4 ports, 2 layers) precoder for codebook index pmi."""
    u = _U4[pmi][:, None]
    w = np.eye(4, dtype=np.complex64) - 2.0 * (u @ u.conj().T) / float(
        np.real(u.conj().T @ u)[0, 0])
    return (w[:, list(_COLS2_4TX[pmi])] / np.sqrt(2.0)).astype(np.complex64)


def decode_pinfo_4tx(pinfo: int, two_tb: bool):
    """DCI format 2 precoding info, 4 TX ports (36.212 Table 5.3.3.1.5-5).

    Returns (n_layers, tpmi) — n_layers > 2 marks configurations beyond
    the rank-2 receiver (caller counts them as wrong-MIMO).  The
    reference's classification is kept as it is, pinfo 16 and 33
    included, so both packages count the same grants."""
    if two_tb:
        if pinfo < 16:
            return 2, pinfo
        if pinfo < 33:            # 17..32: 3 layers (16 = reserved-ish)
            return 3, max(0, pinfo - 17)
        return 4, max(0, pinfo - 33)
    if pinfo == 0:
        return 0, None            # transmit diversity
    return 1, pinfo - 1


_W_CACHE: dict = {}


def _w_ri(w: np.ndarray, device):
    """Real and imaginary float32 parts of a constant complex matrix, on
    the device (uploaded once per matrix value and device)."""
    key = (w.shape, w.tobytes(), str(device))
    hit = _W_CACHE.get(key)
    if hit is None:
        hit = _W_CACHE[key] = (
            torch.from_numpy(np.real(w).astype(np.float32)).to(device),
            torch.from_numpy(np.imag(w).astype(np.float32)).to(device))
    return hit


def _apply_const_matrix(h, w: np.ndarray):
    """h (B, RX, P, M, 2) x constant complex W (P, L) -> (B, RX, L, M, 2)."""
    wr, wi = _w_ri(np.asarray(w, np.complex64), h.device)
    hr, hi = h[..., 0], h[..., 1]
    out_r = (torch.einsum("brpm,pl->brlm", hr, wr)
             - torch.einsum("brpm,pl->brlm", hi, wi))
    out_i = (torch.einsum("brpm,pl->brlm", hr, wi)
             + torch.einsum("brpm,pl->brlm", hi, wr))
    return torch.stack([out_r, out_i], dim=-1)


def effective_channel_tm4(h, pmi: int, n_layers: int):
    """h: (B, RX, P, M, 2) port channels -> (B, RX, L, M, 2) layer
    channels (P = 2 or 4 TX ports; 4-port path is the rank-2 subset)."""
    if h.shape[2] == 4:
        return _apply_const_matrix(h, pmi_matrix_2layer_4tx(pmi))
    if n_layers == 1:
        w = pmi_matrix_1layer(pmi)[:, None]      # (2 ports, 1 layer)
        return _apply_const_matrix(h, w)
    return _apply_const_matrix(h, pmi_matrix_2layer(pmi))


@functools.lru_cache(maxsize=None)
def _alt_sign(M: int) -> np.ndarray:
    """(M,) float32 (-1)^i."""
    return (1.0 - 2.0 * (np.arange(M) % 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cycle_masks(M: int) -> tuple:
    """Four (M,) float32 masks: RE i uses codebook index 12 + (i // 2) % 4."""
    ks = (np.arange(M) // 2) % 4
    return tuple((ks == k).astype(np.float32) for k in range(4))


def _cdd_2layer_tail(hw, M: int):
    """Apply D(i) U for 2 layers to per-RE 'virtual port' channels hw
    (B, RX, 2, M, 2): column l of (D(i) U) = [U[0,l]; U[1,l]*(-1)^i]."""
    sign = cplx.const(_alt_sign(M), hw.device)
    c0 = np.diag([1.0, 0.0]).astype(np.complex64) @ _U_CDD
    c1 = np.diag([0.0, 1.0]).astype(np.complex64) @ _U_CDD
    he0 = _apply_const_matrix(hw, c0)
    he1 = _apply_const_matrix(hw, c1)
    return he0 + he1 * sign[None, None, None, :, None]


def effective_channel_tm3(h):
    """Open-loop CDD effective channel (36.211 6.3.4.2.2), 2 layers.

    2 TX ports: W = I/sqrt(2), D(i) = diag(1, (-1)^i).
    4 TX ports: the precoder CYCLES through codebook indices 12..15
    (2-layer columns) every 2 REs; the D(i) U tail is identical."""
    M = h.shape[-2]
    if h.shape[2] == 4:
        hws = [_apply_const_matrix(h, pmi_matrix_2layer_4tx(12 + k))
               for k in range(4)]
        masks = [cplx.const(m, h.device) for m in _cycle_masks(M)]
        hw = sum(hw_k * m[None, None, None, :, None]
                 for hw_k, m in zip(hws, masks))
        return _cdd_2layer_tail(hw, M)
    hw = _apply_const_matrix(h, _W_CDD)
    return _cdd_2layer_tail(hw, M)


def mmse_2layer(y, he, noise_var):
    """Per-RE 2x2 MMSE: y (B, RX, M, 2), he (B, RX, 2, M, 2) -> (B, 2, M, 2)."""
    h0 = he[:, :, 0]
    h1 = he[:, :, 1]
    a = torch.sum(cplx.cabs2(h0), dim=1) + noise_var[:, None]    # (B, M)
    d = torch.sum(cplx.cabs2(h1), dim=1) + noise_var[:, None]
    b = torch.sum(cplx.cmul_conj(h1, h0), dim=1)                 # conj(h0)*h1
    det = a * d - cplx.cabs2(b)
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    z0 = torch.sum(cplx.cmul_conj(y, h0), dim=1)                 # (B, M, 2)
    z1 = torch.sum(cplx.cmul_conj(y, h1), dim=1)
    x0 = cplx.cscale(cplx.cscale(z0, d) - cplx.cmul(b, z1), inv_det)
    x1 = cplx.cscale(cplx.cscale(z1, a) - cplx.cmul(cplx.conj(b), z0),
                     inv_det)
    return torch.stack([x0, x1], dim=1)


def mmse_1layer(y, he, noise_var):
    """MRC/MMSE single layer: y (B, RX, M, 2) x he (B, RX, 1, M, 2)."""
    h0 = he[:, :, 0]
    num = torch.sum(cplx.cmul_conj(y, h0), dim=1)
    den = torch.sum(cplx.cabs2(h0), dim=1) + noise_var[:, None]
    return cplx.cdiv_real(num, den)[:, None]
