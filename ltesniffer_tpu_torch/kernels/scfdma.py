"""SC-FDMA (de)modulation + DFT transform (de)precoding (36.211 5.6), torch.

Counterpart of `ltesniffer_tpu/kernels/scfdma.py`, in the float-pair
layout of `kernels/cplx.py`: the half-subcarrier shift is a cos/sin pair
multiply, the CP strip one constant-index gather, and the symbol DFT and
the per-grant transform deprecoding are float32 matmuls against cached
matrices (TF32 off, see `sniffer.core.LTESnifferCore`).  These are plain
large matrix products, which the JAX package also leaves to XLA.

TX helpers (test encoder) stay NumPy complex.
Replaces `srsran_enb_ul_fft` + the PUSCH transform precoding inside
`srsran_pusch_decode` (`src/src/UL_Sniffer_PUSCH.cc:392,262`).
"""
from __future__ import annotations

import functools

import numpy as np

from ltesniffer_tpu_torch.phy import params
from ltesniffer_tpu_torch.phy.params import CellConfig
from . import cplx, ofdm
from .cplx import const

DMRS_SYM = (3, 10)     # pilot symbol per slot (normal CP), subframe indexing
DATA_SYMS = (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13)


@functools.lru_cache(maxsize=8)
def _half_shift_ri(n_fft: int, sf_len: int):
    n = np.arange(sf_len)
    ang = -np.pi * n / n_fft
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _half_shift_pairs(n_fft: int, sf_len: int) -> np.ndarray:
    cr, si = _half_shift_ri(n_fft, sf_len)
    return np.stack([cr, si], axis=-1)                  # (sf_len, 2)


@functools.lru_cache(maxsize=8)
def ul_subcarrier_bins(n_fft: int, n_sc: int) -> np.ndarray:
    """UL mapping: n_sc contiguous subcarriers centered (no DC gap)."""
    f = np.arange(n_sc) - n_sc // 2
    return np.where(f < 0, f + n_fft, f).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _ul_dft_mats(n_fft: int, n_sc: int):
    bins = ul_subcarrier_bins(n_fft, n_sc)
    # float64 products rounded once to float32, as the reference's arrays
    # become float32 on the device
    w_re, w_im = cplx.dft_matrices(n_fft, bins, sign=-1.0,
                                   scale=1.0 / np.sqrt(n_fft))
    return w_re.astype(np.float32), w_im.astype(np.float32)


def demodulate_ul_ri(samples_ri, cell: CellConfig):
    """(..., sf_len, 2) -> (..., 14, n_sc, 2), half-subcarrier shift removed."""
    dev = samples_ri.device
    x = cplx.cmul(samples_ri,
                  const(_half_shift_pairs(cell.n_fft, cell.sf_len), dev))
    sym = x[..., const(ofdm._symbol_index(cell.n_fft), dev), :]
    w_re, w_im = _ul_dft_mats(cell.n_fft, cell.n_sc)
    return cplx.cmatmul(sym, const(w_re, dev), const(w_im, dev))


def modulate_ul_np(grid: np.ndarray, cell: CellConfig) -> np.ndarray:
    """(14, n_sc) -> (sf_len,) time samples (test TX side, NumPy complex)."""
    n_fft, n_sc = cell.n_fft, cell.n_sc
    bins = ul_subcarrier_bins(n_fft, n_sc)
    out = np.zeros(cell.sf_len, dtype=np.complex64)
    starts = ofdm.symbol_starts(n_fft)
    cps = params.cp_lengths(n_fft) * 2
    for i in range(params.N_SYM_SF):
        spec = np.zeros(n_fft, dtype=np.complex64)
        spec[bins] = grid[i]
        td = np.fft.ifft(spec) * np.sqrt(n_fft)
        s = starts[i]
        out[s:s + n_fft] = td
        out[s - cps[i]:s] = td[-cps[i]:]
    # TX applies +7.5 kHz: multiply by conj of the RX shift exp(-j*pi*n/N)
    cr, si = _half_shift_ri(n_fft, cell.sf_len)
    return out * (cr - 1j * si)


def dft_precode_np(x: np.ndarray, m_sc: int) -> np.ndarray:
    """(n_sym * m_sc,) modulation symbols -> DFT-spread symbols (TX)."""
    blocks = x.reshape(-1, m_sc)
    return (np.fft.fft(blocks, axis=-1) / np.sqrt(m_sc)).reshape(-1)


@functools.lru_cache(maxsize=64)
def _idft_mats(m_sc: int):
    w_re, w_im = cplx.dft_matrices(m_sc, np.arange(m_sc), sign=+1.0,
                                   scale=1.0 / np.sqrt(m_sc))
    return w_re.astype(np.float32), w_im.astype(np.float32)


def dft_deprecode_ri(x, m_sc: int):
    """(..., n_sym, m_sc, 2) equalized symbols -> despread (IDFT matmul)."""
    w_re, w_im = _idft_mats(m_sc)
    return cplx.cmatmul(x, const(w_re, x.device), const(w_im, x.device))
