"""CRS-based channel estimation + control-channel equalization (batched JAX).

Replaces srsRAN `chest_dl` (LS at CRS + filtering + interpolation, noise/SNR
estimates) as configured by the reference (`src/src/SubframeWorker.cc:376-399`:
Gaussian filter, interpolation, SNR/CFO estimates).

Float-pair (re/im) tensors throughout (see kernels/cplx.py), as in the JAX
reference package (`ltesniffer_tpu/kernels/chest.py`); interpolation is two constant-matrix
contractions (freq: (n_sc x 2*n_prb) per port, time: (14 x 4)), so the whole
estimator is a pair of small matmuls per batch — no sequential filtering.
CRS values per (sf_idx, port, symbol) are precomputed host-side into a
(10, P, 4, 2*n_prb, 2) float constant and gathered by the sf_idx tensor.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import sequences
from ltesniffer_tpu_torch.phy.params import CellConfig
from . import cplx
from .cplx import const

CRS_SYMS = (0, 4, 7, 11)   # ports 0/1, normal CP
CRS_SYMS_P23 = (1, 8)      # ports 2/3 (duplicated to keep a (P,4) layout)


def _port_syms(port: int):
    """Per-port CRS symbol slots: ports 2/3 only transmit in symbols 1 and
    8, duplicated into 4 slots so every port shares the (4, n2) layout."""
    return CRS_SYMS if port < 2 else (1, 8, 1, 8)


@functools.lru_cache(maxsize=16)
def crs_constants(cell: CellConfig):
    """Static CRS tables: symbol slots (P, 4), k positions (P, 4, n2) and
    float-pair values (10, P, 4, n2, 2)."""
    P = min(cell.nof_ports, 4)
    n2 = 2 * cell.n_prb
    syms = np.zeros((P, 4), dtype=np.int64)
    k_pos = np.zeros((P, 4, n2), dtype=np.int64)
    values = np.zeros((10, P, 4, n2), dtype=np.complex64)
    for port in range(P):
        for si, l_sf in enumerate(_port_syms(port)):
            syms[port, si] = l_sf
            k = sequences.crs_re_positions(cell.n_id_cell, port, l_sf, cell.n_prb)
            k_pos[port, si] = k
            for sf in range(10):
                slot = 2 * sf + l_sf // 7
                values[sf, port, si] = sequences.crs_sequence(
                    cell.n_id_cell, slot, l_sf % 7, cell.n_prb)
    return syms, k_pos, cplx.to_ri(values)


@functools.lru_cache(maxsize=16)
def _crs_sym_index(cell: CellConfig) -> np.ndarray:
    """crs_constants' symbol slots, flat (P * 4,): the gather index of
    `estimate`, cached beside them so its device copy is uploaded once."""
    return crs_constants(cell)[0].reshape(-1)


@functools.lru_cache(maxsize=16)
def interp_matrices(cell: CellConfig):
    """(W_freq: (P, 4, n_sc, 2*n_prb), W_time: (P, 14, 4)) linear interp.

    Frequency weights are built per CRS symbol: the pilot subcarrier offset
    differs between CRS symbols (port-0 pilots sit at v=0 on l=0,7 but v=3
    on l=4,11), so sharing symbol-0 positions would evaluate a selective
    channel 3 subcarriers off — a ~10% estimate error on a fast ripple.
    Time weights are per PORT: ports 2/3 only pilot in symbols 1 and 8
    (their duplicated slots get half weight each)."""
    P = min(cell.nof_ports, 4)
    n_sc, n2 = cell.n_sc, 2 * cell.n_prb
    _syms, k_pos, _ = crs_constants(cell)
    wf = np.zeros((P, 4, n_sc, n2), dtype=np.float32)
    for p in range(P):
        for si in range(4):
            pos = k_pos[p, si].astype(np.float64)
            for k in range(n_sc):
                j = np.searchsorted(pos, k)
                if j == 0:
                    i0, i1 = 0, 1
                elif j >= n2:
                    i0, i1 = n2 - 2, n2 - 1
                else:
                    i0, i1 = j - 1, j
                denom = pos[i1] - pos[i0]
                t = (k - pos[i0]) / denom
                wf[p, si, k, i0] = 1.0 - t
                wf[p, si, k, i1] = t
    wt = np.zeros((P, 14, 4), dtype=np.float32)
    for p in range(P):
        if p < 2:
            ts = np.asarray(CRS_SYMS, dtype=np.float64)
            for l in range(14):
                j = np.searchsorted(ts, l)
                if j == 0:
                    i0, i1 = 0, 1
                elif j >= 4:
                    i0, i1 = 2, 3
                else:
                    i0, i1 = j - 1, j
                t = (l - ts[i0]) / (ts[i1] - ts[i0])
                wt[p, l, i0] = 1.0 - t
                wt[p, l, i1] = t
        else:
            # slots are (1, 8, 1, 8): interpolate between symbols 1 and 8,
            # splitting each weight across the duplicated slots
            for l in range(14):
                t = np.clip((l - 1.0) / 7.0, 0.0, 1.0)
                wt[p, l, 0] = wt[p, l, 2] = (1.0 - t) / 2.0
                wt[p, l, 1] = wt[p, l, 3] = t / 2.0
    return wf, wt


def _smooth_freq(h):
    """3-tap smoothing along the pilot axis (-2; last axis is re/im)."""
    pad = torch.cat([h[..., :1, :], h, h[..., -1:, :]], dim=-2)
    return (0.25 * pad[..., :-2, :] + 0.5 * pad[..., 1:-1, :]
            + 0.25 * pad[..., 2:, :])


def estimate(grid, sf_idx, cell: CellConfig):
    """LS + interpolated channel estimate (float-pair tensors).

    Args:
      grid:   (B, RX, 14, n_sc, 2) float32 resource grids.
      sf_idx: (B,) int64 subframe indices 0..9 (tensor on grid's device).
    Returns dict:
      h:         (B, RX, P, 14, n_sc, 2) float32
      noise_var / rsrp / snr_db / cfo: (B,) float32
    """
    dev = grid.device
    syms, k_pos, values_ri = crs_constants(cell)
    wf, wt = interp_matrices(cell)
    vals = const(values_ri, dev)[sf_idx]                # (B, P, 4, n2, 2)
    B, RX = grid.shape[0], grid.shape[1]
    P = syms.shape[0]

    # per-port CRS symbol gather (ports 2/3 pilot in symbols 1/8)
    g_sym = grid[:, :, const(_crs_sym_index(cell), dev)]
    g_sym = g_sym.reshape(B, RX, P, 4, grid.shape[3], 2)  # (B, RX, P, 4, sc, 2)
    kp = const(k_pos, dev)                              # (P, 4, n2)
    pil = torch.gather(
        g_sym, 4, kp[None, None, :, :, :, None].expand(
            B, RX, P, 4, kp.shape[-1], 2))
    h_ls = cplx.cmul_conj(pil, vals[:, None])           # (B, RX, P, 4, n2, 2)

    h_sm = _smooth_freq(h_ls)
    resid = h_ls - h_sm
    noise_var = torch.mean(cplx.cabs2(resid), dim=(1, 2, 3, 4)) / 0.375
    rsrp = torch.mean(cplx.cabs2(h_sm), dim=(1, 2, 3, 4))
    snr_db = 10.0 * torch.log10(torch.clamp(rsrp, min=1e-12)
                                / torch.clamp(noise_var, min=1e-12))

    # fine CFO from CRS phase rotation across half a subframe (symbols 0->7,
    # 4->11, i.e. 0.5 ms): eps_subcarriers = angle / (2*pi*7.5).  This is the
    # estimate the reference feeds back into sync (`SubframeWorker.cc:203`).
    # Ports 0/1 only: ports 2/3's duplicated slots carry no 0.5 ms pairs.
    h01 = h_sm[:, :, :2]
    c1 = cplx.cmul_conj(h01[:, :, :, 2], h01[:, :, :, 0])   # (B,RX,2,n2,2)
    c2 = cplx.cmul_conj(h01[:, :, :, 3], h01[:, :, :, 1])
    csum = torch.sum((c1 + c2).reshape(B, -1, 2), dim=1)
    cfo_sc = torch.atan2(csum[:, 1], csum[:, 0]) / (2.0 * np.pi * 7.5)

    # interpolate: freq (per CRS symbol) then time (pair axis rides along)
    h_f = torch.einsum("brptsc,ptks->brptkc", h_sm, const(wf, dev))
    h = torch.einsum("brptkc,plt->brplkc", h_f, const(wt, dev))
    return {"h": h, "noise_var": noise_var, "rsrp": rsrp, "snr_db": snr_db,
            "cfo": cfo_sc}


def equalize_sfbc(y, h, noise_var):
    """Alamouti SFBC combining over adjacent RE pairs (36.211 6.3.4.3).

    y: (B, RX, 2M, 2); h: (B, RX, P=2, 2M, 2) -> x_hat (B, 2M, 2).
    """
    y0, y1 = y[..., 0::2, :], y[..., 1::2, :]
    h0 = h[:, :, 0]
    h1 = h[:, :, 1]
    h00, h01 = h0[..., 0::2, :], h0[..., 1::2, :]
    h10, h11 = h1[..., 0::2, :], h1[..., 1::2, :]
    x0 = torch.sum(cplx.cmul_conj(y0, h00) + cplx.cmul_conj(h11, y1), dim=1)
    x1 = torch.sum(cplx.cmul_conj(y1, h01) - cplx.cmul_conj(h10, y0), dim=1)
    norm = (torch.sum(cplx.cabs2(h00) + cplx.cabs2(h10), dim=1)
            + noise_var[:, None])
    x0 = cplx.cdiv_real(x0, norm)
    x1 = cplx.cdiv_real(x1, norm)
    out = torch.stack([x0, x1], dim=-2)                 # (B, M, 2pair, 2ri)
    out = out.reshape(y.shape[0], -1, 2)
    return out * float(np.float32(np.sqrt(2.0)))


def equalize_sfbc4(y, h, noise_var):
    """SFBC-FSTD combining for 4 antenna ports (36.211 6.3.4.3.2).

    Symbols group in fours: (x0, x1) Alamouti on ports (0, 2) over REs
    (4i, 4i+1); (x2, x3) Alamouti on ports (1, 3) over REs (4i+2, 4i+3).
    y: (B, RX, 4M, 2); h: (B, RX, 4, 4M, 2) -> x_hat (B, 4M, 2).
    """
    def _pair(y_j, y_j1, ha_j, ha_j1, hb_j, hb_j1):
        # same algebra as `equalize_sfbc` with ports (A, B) on REs (j, j+1)
        xa = torch.sum(cplx.cmul_conj(y_j, ha_j)
                       + cplx.cmul_conj(hb_j1, y_j1), dim=1)
        xb = torch.sum(cplx.cmul_conj(y_j1, ha_j1)
                       - cplx.cmul_conj(hb_j, y_j), dim=1)
        norm = (torch.sum(cplx.cabs2(ha_j) + cplx.cabs2(hb_j), dim=1)
                + noise_var[:, None])
        return cplx.cdiv_real(xa, norm), cplx.cdiv_real(xb, norm)

    yg = [y[..., i::4, :] for i in range(4)]
    hp = [h[:, :, p] for p in range(4)]
    x0, x1 = _pair(yg[0], yg[1],
                   hp[0][..., 0::4, :], hp[0][..., 1::4, :],
                   hp[2][..., 0::4, :], hp[2][..., 1::4, :])
    x2, x3 = _pair(yg[2], yg[3],
                   hp[1][..., 2::4, :], hp[1][..., 3::4, :],
                   hp[3][..., 2::4, :], hp[3][..., 3::4, :])
    out = torch.stack([x0, x1, x2, x3], dim=-2)     # (B, M, 4group, 2ri)
    out = out.reshape(y.shape[0], -1, 2)
    return out * float(np.float32(np.sqrt(2.0)))


def equalize_ports(y, h, noise_var, nof_ports: int):
    """Transmit-diversity equalizer for 1 / 2 / 4 ports."""
    if nof_ports >= 4:
        return equalize_sfbc4(y, h, noise_var)
    if nof_ports == 2:
        return equalize_sfbc(y, h, noise_var)
    return equalize_port0(y, h[:, :, 0] if h.dim() == 5 else h, noise_var)


def equalize_port0(y, h, noise_var):
    """Single-port MMSE: y (B, RX, M, 2), h (B, RX, M, 2) -> (B, M, 2)."""
    num = torch.sum(cplx.cmul_conj(y, h), dim=1)
    den = torch.sum(cplx.cabs2(h), dim=1) + noise_var[:, None]
    return cplx.cdiv_real(num, den)
