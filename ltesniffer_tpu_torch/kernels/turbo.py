"""Batched max-log-MAP turbo decoder, parallel-window lane layout.

Counterpart of `ltesniffer_tpu/kernels/turbo.py:_make_decoder_pallas`: the
K-step trellis is cut into NW = K/W windows of W steps, which run in
parallel.  Window-boundary metrics (alpha at each window end, beta at each
window start) carry over to the next turbo iteration (next-iteration
initialisation); the tail-terminated beta_K enters the last window of each
block.

`make_decoder` is the main path's decoder: on a CUDA tensor it launches
the fused whole-decode kernel (`kernels/turbo_decode.py`, one launch per
call); on a CPU tensor it runs the lane decoder below with the plain BCJR
twin, the fused kernel's plain version.

`make_decoder_lanes` is that lane decoder: every (code block x window) pair
is one lane of a (W, L) window-major layout, one BCJR pass
(`kernels/bcjr.py`; on the card the per-pass CUDA kernel) runs all lanes,
and the QPP interleave and de-interleave between half-iterations are flat
gathers with constant indices in that layout.  On the card it is the
earlier design, kept as the fused kernel's yardstick; the main path does
not call it there.

LLR sign convention: positive => bit 0 (matches demappers/Viterbi).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import tables, turbo as turbo_host
from . import bcjr as bcjr_mod, turbo_decode
from .cplx import const

NEG = -1e9


@functools.lru_cache(maxsize=1)
def _trellis():
    t = turbo_host.rsc_tables()
    ns = t["next_state"]                                # (8, 2)
    par = t["parity"]
    sgn_z = (1.0 - 2.0 * par).astype(np.float32)       # (8, 2)
    return dict(ns=ns.astype(np.int64), sgn_z=sgn_z,
                sgn_x=np.array([1.0, -1.0], np.float32))


def _beta_init_from_tail(tail_sys, tail_par):
    """(B, 3) tail sys/par llrs -> beta at position K, shape (B, 8)."""
    t = _trellis()
    dev = tail_sys.device
    ns = const(t["ns"], dev)
    sgn_z = const(t["sgn_z"], dev)
    sgn_x = const(t["sgn_x"], dev)
    B = tail_sys.shape[0]
    beta = torch.full((B, 8), NEG, dtype=torch.float32, device=dev)
    beta[:, 0] = 0.0
    # walk backward: beta_k(s) = max_x gamma_k(s,x) + beta_{k+1}(ns)
    for k in (2, 1, 0):
        g = 0.5 * (tail_sys[:, k, None, None] * sgn_x
                   + tail_par[:, k, None, None] * sgn_z)   # (B, 8, 2)
        cand = g + beta[:, ns]                             # (B, 8, 2)
        beta = torch.max(cand, dim=-1).values
    return beta


@functools.lru_cache(maxsize=128)
def _lane_consts(K: int, B: int):
    """Constant index maps for the window-major lane layout: (8 states,
    (code block x window) lanes); QPP permutes and window-boundary shifts
    are single constant-index gathers.  L pads B*NW up to a multiple of
    128 lanes, as the reference driver does."""
    pi = tables.qpp_interleave_indices(K).astype(np.int64)
    de = np.zeros(K, dtype=np.int64)
    de[pi] = np.arange(K, dtype=np.int64)
    W = turbo_decode.window_len(K)
    NW = K // W
    L0 = B * NW
    L = -(-L0 // 128) * 128
    lane_b = np.arange(L) // NW          # code block of each lane
    lane_w = np.arange(L) % NW           # window of each lane
    lane_b[L0:] = 0
    lane_w[L0:] = 0

    def perm_w(p):
        # window-layout flat gather index for apr_dst[k] = ext_src[p[k]]:
        # dst lane (b, w) step t reads src position p[w*W + t] of block b
        idx = np.arange(W * L, dtype=np.int64).reshape(W, L)
        src = p.reshape(NW, W).T                       # (W, NW)
        blk = (np.arange(B) * NW)[None, :, None]       # (1, B, 1)
        val = ((src % W) * L)[:, None, :] + blk + (src // W)[:, None, :]
        idx[:, :L0] = val.reshape(W, L0)
        return idx.reshape(-1)

    # alpha shift: window w inherits a_end of window w-1 (same block)
    sia = np.where(lane_w > 0, np.arange(L) - 1, np.arange(L))
    mask_a = (lane_w > 0).astype(np.float32)[None, :]
    const_a = np.where(mask_a > 0, 0.0, NEG) * np.ones((8, 1), np.float32)
    const_a[0] = 0.0                                   # known state 0
    const_a[:, L0:] = 0.0
    mask_a[:, L0:] = 0.0
    # beta shift: window w inherits b_start of window w+1; last window
    # gets the tail-terminated beta_K (data-dependent, masked in)
    # (padding lanes clamp to the last lane, as an XLA gather does)
    sib = np.minimum(np.where(lane_w < NW - 1, np.arange(L) + 1,
                              np.arange(L)), L - 1)
    is_last = (lane_w == NW - 1)
    is_last[L0:] = False
    mask_b = (~is_last).astype(np.float32)[None, :]
    return dict(L0=L0, L=L, W=W, NW=NW, pi=pi, de=de,
                pi_w=perm_w(pi), de_w=perm_w(de),
                sia=sia.astype(np.int64), mask_a=mask_a,
                const_a=const_a.astype(np.float32),
                sib=sib.astype(np.int64), mask_b=mask_b,
                is_last=is_last[None, :], lane_b=lane_b.astype(np.int64))


def _tails(d0, d1, d2, K):
    t1_sys = torch.stack([d0[:, K], d2[:, K], d1[:, K + 1]], dim=1)
    t1_par = torch.stack([d1[:, K], d0[:, K + 1], d2[:, K + 1]], dim=1)
    t2_sys = torch.stack([d0[:, K + 2], d2[:, K + 2], d1[:, K + 3]], dim=1)
    t2_par = torch.stack([d1[:, K + 2], d0[:, K + 3], d2[:, K + 3]], dim=1)
    return t1_sys, t1_par, t2_sys, t2_par


@functools.lru_cache(maxsize=64)
def make_decoder(K: int, n_iter: int = 8):
    """Turbo decoder for code-block size K.

    fn(d_llrs (B, 3, K+4) f32) -> (bits (B, K) uint8, llr (B, K) f32), on
    d_llrs' device: one launch of the fused CUDA kernel for a CUDA tensor,
    the lane decoder over the plain BCJR twin for a CPU tensor.
    """
    lanes = make_decoder_lanes(K, n_iter)

    def decode(d_llrs):
        d_llrs = d_llrs.to(torch.float32)
        if d_llrs.device.type == "cuda":
            return turbo_decode.turbo_decode_cuda(d_llrs.contiguous(), K,
                                                  n_iter)
        if d_llrs.device.type != "cpu":
            raise ValueError(f"turbo: unsupported device {d_llrs.device}")
        return lanes(d_llrs)

    return decode


@functools.lru_cache(maxsize=64)
def make_decoder_lanes(K: int, n_iter: int = 8, bcjr=bcjr_mod.bcjr):
    """The lane decoder: fn(d_llrs (B, 3, K+4) f32) -> (bits, llr) as
    `make_decoder`, with every BCJR pass through `bcjr` (by default
    `kernels/bcjr.py:bcjr`: the per-pass CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors; `bcjr_mod.bcjr_plain` on any device is the
    fused kernel's plain version).
    """
    W = turbo_decode.window_len(K)
    NW = K // W

    def decode(d_llrs):
        d_llrs = d_llrs.to(torch.float32)
        dev = d_llrs.device
        d0 = d_llrs[:, 0, :]
        d1 = d_llrs[:, 1, :]
        d2 = d_llrs[:, 2, :]
        l_sys = d0[:, :K]
        t1_sys, t1_par, t2_sys, t2_par = _tails(d0, d1, d2, K)
        B = l_sys.shape[0]
        c = _lane_consts(K, B)
        L0, L = c["L0"], c["L"]
        pad = L - L0
        pi = const(c["pi"], dev)
        de = const(c["de"], dev)
        pi_w = const(c["pi_w"], dev)
        de_w = const(c["de_w"], dev)
        sia = const(c["sia"], dev)
        sib = const(c["sib"], dev)
        lane_b = const(c["lane_b"], dev)
        mask_a = const(c["mask_a"], dev)
        const_a = const(c["const_a"], dev)
        mask_b = const(c["mask_b"], dev)
        is_last = const(c["is_last"], dev)

        def to_w(x):      # (B, K) -> (W, L) window-major lanes
            xw = x.reshape(B, NW, W).permute(2, 0, 1).reshape(W, L0)
            return torch.nn.functional.pad(xw, (0, pad)).contiguous()

        # layout conversions happen ONCE; the loop runs in window layout
        l_sys_w = to_w(l_sys)
        l_sys_iw = to_w(l_sys[:, pi])
        lp1w = to_w(d1[:, :K])
        lp2w = to_w(d2[:, :K])
        # tail-terminated beta_K scattered into the last-window lanes
        bK1 = _beta_init_from_tail(t1_sys, t1_par).T       # (8, B)
        bK2 = _beta_init_from_tail(t2_sys, t2_par).T
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        betaK1_full = torch.where(is_last, bK1[:, lane_b], zero)
        betaK2_full = torch.where(is_last, bK2[:, lane_b], zero)

        def shift_a(a_end):
            return (a_end[:, sia] * mask_a + const_a).contiguous()

        def shift_b(b_start, betaK_full):
            return (b_start[:, sib] * mask_b + betaK_full).contiguous()

        zero_b = torch.zeros((8, L), dtype=torch.float32, device=dev)
        apr1 = torch.zeros((W, L), dtype=torch.float32, device=dev)
        a1, b1 = shift_a(zero_b), shift_b(zero_b, betaK1_full)
        a2, b2 = shift_a(zero_b), shift_b(zero_b, betaK2_full)
        ext2 = apr2 = apr1
        for _ in range(n_iter):
            ext1, a1e, b1s = bcjr(apr1, l_sys_w, lp1w, a1, b1)
            apr2 = ext1.reshape(-1)[pi_w].reshape(W, L)
            ext2, a2e, b2s = bcjr(apr2, l_sys_iw, lp2w, a2, b2)
            apr1 = ext2.reshape(-1)[de_w].reshape(W, L)
            a1, b1 = shift_a(a1e), shift_b(b1s, betaK1_full)
            a2, b2 = shift_a(a2e), shift_b(b2s, betaK2_full)
        llr2w = ext2 + apr2 + l_sys_iw                     # full LLR, dec-2
        llr2 = llr2w[:, :L0].reshape(W, B, NW).permute(1, 2, 0).reshape(B, K)
        llr_final = llr2[:, de]
        bits = (llr_final < 0).to(torch.uint8)
        return bits, llr_final

    return decode
