"""Batched subframe frontend: OFDM demod + CRS chest + PCFICH (CFI) detect.

Splitting the frontend from the PDCCH search lets demod/chest run exactly
once per subframe while the search reads the detected CFI as data.
Counterpart of `ltesniffer_tpu/sniffer/frontend.py`; replaces
`srsran_ue_dl_decode_fft_estimate`'s FFT/chest/PCFICH stage
(`src/src/DCISearch.cc:562`, SURVEY.md §2.1 ue_dl row).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import grid as grid_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import chest, demapper, ofdm
from ltesniffer_tpu_torch.kernels.cplx import const, to_ri


class Frontend:
    """Per-cell frontend; every entry returns a dict of tensors on the
    input's device: grids, h, noise_var, snr_db, rsrp, cfo, cfi (B,) int64,
    cfi_corr (B, 3) and the fused per-subframe scalars (B, 4)."""

    def __init__(self, cell: CellConfig):
        self.cell = cell
        # PCFICH REs: constant positions (symbol 0)
        reg = grid_mod.control_region(cell, 1)
        self.re_idx = np.array([[r.l * cell.n_sc + k for k in r.res]
                                for r in reg["pcfich_regs"]],
                               dtype=np.int64).reshape(-1)          # (16,)
        self.scr = np.stack([
            1.0 - 2.0 * grid_mod.pcfich_scrambling(cell, sf)
            for sf in range(10)]).astype(np.float32)                # (10, 32)
        self.cw = np.ascontiguousarray(
            grid_mod.cfi_codewords_matrix(), dtype=np.float32)     # (3, 32)

    def run_ri(self, samples_ri, sf_idx):
        """(B, RX, sf_len, 2) float32 samples, (B,) int64 sf_idx."""
        cell = self.cell
        dev = samples_ri.device
        grids = ofdm.demodulate_ri(samples_ri, cell)    # (B,RX,14,n_sc,2)
        B = grids.shape[0]
        ch = chest.estimate(grids, sf_idx, cell)
        h = ch["h"]
        gflat = grids.reshape(B, grids.shape[1], -1, 2)
        hflat = h.reshape(B, h.shape[1], h.shape[2], -1, 2)
        re_idx = const(self.re_idx, dev)
        y = gflat[:, :, re_idx, :]
        hh = hflat[:, :, :, re_idx, :]
        x = chest.equalize_ports(y, hh, ch["noise_var"], cell.nof_ports)
        llr = demapper.qpsk_llr(x) * const(self.scr, dev)[sf_idx]  # (B, 32)
        corr = torch.einsum("bj,cj->bc", llr, const(self.cw, dev))  # (B, 3)
        cfi = 1 + torch.argmax(corr, dim=-1)
        # fused per-subframe scalars: one host read serves the whole
        # host-side control flow
        scalars = torch.stack([cfi.to(torch.float32), ch["snr_db"],
                               ch["cfo"], ch["rsrp"]], dim=-1)    # (B, 4)
        return {"grids": grids, "h": h, "noise_var": ch["noise_var"],
                "snr_db": ch["snr_db"], "rsrp": ch["rsrp"],
                "cfo": ch["cfo"], "cfi": cfi, "cfi_corr": corr,
                "scalars": scalars}

    def _derotate(self, x, cfo: float):
        """Residual-CFO de-rotation of (B, RX, n, 2) samples."""
        n = x.shape[-2]
        c32 = float(np.float32(-2.0 * np.pi / self.cell.n_fft))
        ramp = torch.arange(n, dtype=torch.float32, device=x.device)
        theta = torch.tensor(cfo, dtype=torch.float32,
                             device=x.device) * c32 * ramp
        c, s = torch.cos(theta), torch.sin(theta)
        xr, xi = x[..., 0], x[..., 1]
        return torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1)

    def run(self, samples: np.ndarray, sf_idx, device):
        """Unquantized ingest: (B, RX, n) numpy complex64 samples, copied to
        `device` as float pairs; no de-rotation (the float32 path of the
        core mixes its CFO correction on the host)."""
        x = torch.from_numpy(to_ri(samples)).to(device)
        return self.run_ri(x, sf_idx)

    def run_i16(self, samples_i16, sf_idx, scale, cfo: float):
        """Quantized-IQ ingest: (B, RX, n, 2) int16 + a global float32
        scale (0-dim tensor), with the residual-CFO de-rotation applied on
        the device (the reference's host-side `srsran_cfo_correct`)."""
        x = samples_i16.to(torch.float32) * scale
        return self.run_ri(self._derotate(x, cfo), sf_idx)

    def _unpack_i8(self, p8, scales, cfo: float):
        """(B, RX, n) int8 IQ bytes (re, im interleaved) + per-subframe
        scales (B,) -> (B, RX, n/2, 2) float32, de-rotated."""
        B = p8.shape[0]
        x = (p8.to(torch.float32).reshape(B, p8.shape[1], -1, 2)
             * scales[:, None, None, None])
        return self._derotate(x, cfo)

    def run_i8c64(self, chunk64, sf_idx, scales, cfo: float):
        """Packed-int8 ingest from the int64 carrier (`cplx.view_i64`):
        (B, RX, n/4) int64, each holding 8 int8 IQ bytes.  Both the card
        and the host are little-endian, so the int8 view of the carrier
        is the byte order `cplx.to_i8_packed` wrote (byte k of word w at
        bits 8k), and the view sign-extends each byte."""
        p8 = chunk64.contiguous().view(torch.int8)      # (B, RX, 2n) bytes
        return self.run_ri(self._unpack_i8(p8, scales, cfo), sf_idx)


@functools.lru_cache(maxsize=16)
def make_frontend(cell: CellConfig) -> Frontend:
    return Frontend(cell)
