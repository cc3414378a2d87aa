"""Turbo coding host path (36.212 5.1.2 / 5.1.3.2 / 5.1.4.1).

Code-block segmentation, the 8-state RSC constituent encoders with QPP
interleaving, and turbo rate matching (sub-block interleavers, circular
buffer, rv offsets, NULL-filler handling).  NumPy: used by the test-side
transmitter and to precompute the index maps the batched JAX decoder
(`ltesniffer_tpu_torch.kernels.turbo`) consumes.

Replaces srsRAN's sch/rm_turbo/tc encoder surface (SURVEY.md §2.1 ue_dl row).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from . import crc, tables

Z_MAX = 6144          # max code block size
SEG_CRC = 24

C_SB = 32
# 36.212 Table 5.1.4-1: turbo sub-block inter-column permutation
PERM_TURBO = np.array([
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31], dtype=np.int64)


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Segmentation:
    C: int                     # number of code blocks
    K: List[int]               # per-block interleaver sizes
    F: int                     # filler bits (start of first block)
    B: int                     # input length incl. TB CRC


def segment_sizes(tbs: int) -> Segmentation:
    B = tbs + 24
    ks = tables.turbo_k_sizes()
    if B <= Z_MAX:
        K = int(ks[np.searchsorted(ks, B)])
        return Segmentation(C=1, K=[K], F=K - B, B=B)
    C = int(-(-B // (Z_MAX - SEG_CRC)))
    Bp = B + C * SEG_CRC
    k_plus = int(ks[np.searchsorted(ks, -(-Bp // C))])
    i = np.searchsorted(ks, k_plus)
    k_minus = int(ks[i - 1])
    dk = k_plus - k_minus
    c_minus = (C * k_plus - Bp) // dk
    c_plus = C - c_minus
    F = c_plus * k_plus + c_minus * k_minus - Bp
    Ks = [k_minus] * c_minus + [k_plus] * c_plus
    return Segmentation(C=C, K=Ks, F=F, B=B)


def segment(tb_bits: np.ndarray) -> Tuple[Segmentation, List[np.ndarray]]:
    """Transport block bits (without CRC) -> code blocks with CRCs + fillers.

    Filler bits are marked with value 2 (NULL) so rate matching can skip them.
    """
    tb = crc.attach_crc(np.asarray(tb_bits, np.uint8), crc.CRC24A)
    seg = segment_sizes(len(tb_bits))
    blocks = []
    pos = 0
    for ci, K in enumerate(seg.K):
        blk = np.zeros(K, dtype=np.uint8)
        start = 0
        if ci == 0 and seg.F:
            blk[:seg.F] = 2     # NULL fillers
            start = seg.F
        payload = K - start - (SEG_CRC if seg.C > 1 else 0)
        blk[start:start + payload] = tb[pos:pos + payload]
        pos += payload
        if seg.C > 1:
            # CRC24B over the block bits (fillers count as 0)
            data = np.where(blk[:K - SEG_CRC] == 2, 0, blk[:K - SEG_CRC])
            blk[K - SEG_CRC:] = crc.crc_bits(data, crc.CRC24B)
        blocks.append(blk)
    return seg, blocks


# ---------------------------------------------------------------------------
# RSC constituent encoder / trellis tables
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def rsc_tables():
    """8-state RSC (g0=13, g1=15 octal) transition tables.

    For state s=(s1,s2,s3) packed as s1*4+s2*2+s3 and input bit x:
      a = x ^ s2 ^ s3 (internal), z = a ^ s1 ^ s3 (parity),
      next = (a, s1, s2).
    Returns dict of (8, 2) int arrays: next_state, parity, and term_input
    (8,) — the input that zeroes the feedback (used for termination).
    """
    ns = np.zeros((8, 2), dtype=np.int64)
    par = np.zeros((8, 2), dtype=np.int64)
    term = np.zeros(8, dtype=np.int64)
    for s in range(8):
        s1, s2, s3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        term[s] = s2 ^ s3
        for x in (0, 1):
            a = x ^ s2 ^ s3
            z = a ^ s1 ^ s3
            ns[s, x] = (a << 2) | (s1 << 1) | s2
            par[s, x] = z
    return {"next_state": ns, "parity": par, "term_input": term}


@functools.lru_cache(maxsize=1)
def _rsc_byte_tables():
    """(8, 256) next state and (8, 256, 8) parity bits of the RSC encoder
    after 8 input bits (MSB first) from each state: the bit loop of the
    port's `_rsc_encode` taken 8 bits a step, with equal output."""
    t = rsc_tables()
    nxt = np.zeros((8, 256), np.int64)
    par = np.zeros((8, 256, 8), np.uint8)
    for s0 in range(8):
        for v in range(256):
            s = s0
            for i in range(8):
                x = (v >> (7 - i)) & 1
                par[s0, v, i] = t["parity"][s, x]
                s = t["next_state"][s, x]
            nxt[s0, v] = s
    return nxt, par


def _rsc_encode(bits: np.ndarray):
    """Returns (parity, tail) with tail = (x_K, z_K, x_K1, z_K1, x_K2, z_K2)."""
    t = rsc_tables()
    nxt, par = _rsc_byte_tables()
    n = len(bits)
    n8 = n - n % 8
    z = np.empty(n, dtype=np.uint8)
    s = 0
    vals = np.packbits(np.asarray(bits[:n8], np.uint8)).tolist()
    zz = z[:n8].reshape(-1, 8)
    for k, v in enumerate(vals):
        zz[k] = par[s, v]
        s = int(nxt[s, v])
    for i in range(n8, n):
        x = int(bits[i])
        z[i] = t["parity"][s, x]
        s = int(t["next_state"][s, x])
    tail = []
    for _ in range(3):
        x = int(t["term_input"][s])
        tail.extend([x, int(t["parity"][s, x])])
        s = t["next_state"][s, x]
    return z, np.array(tail, dtype=np.uint8)


def turbo_encode(block: np.ndarray):
    """Code block (with NULL=2 fillers) -> (3, K+4) streams d0,d1,d2.

    Fillers are encoded as 0 but marked as NULL (=2) in d0/d1 per spec.
    """
    K = len(block)
    nulls = block == 2
    x = np.where(nulls, 0, block).astype(np.uint8)
    pi = tables.qpp_interleave_indices(K)
    z1, tail1 = _rsc_encode(x)
    z2, tail2 = _rsc_encode(x[pi])
    d = np.zeros((3, K + 4), dtype=np.uint8)
    d[0, :K] = np.where(nulls, 2, x)
    d[1, :K] = np.where(nulls, 2, z1)
    d[2, :K] = z2
    # tail mapping (36.212 5.1.3.2.2): tail1 = x_K z_K x_K1 z_K1 x_K2 z_K2
    xk, zk, xk1, zk1, xk2, zk2 = tail1
    xk_, zk_, xk1_, zk1_, xk2_, zk2_ = tail2
    d[0, K:] = [xk, zk1, xk_, zk1_]
    d[1, K:] = [zk, xk2, zk_, xk2_]
    d[2, K:] = [xk1, zk2, xk1_, zk2_]
    return d


# ---------------------------------------------------------------------------
# Rate matching (5.1.4.1)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def turbo_rm_maps(K: int):
    """Static circular-buffer layout for one code block size.

    Returns dict:
      w_src:   (3*K_pi,) flat source index into d.reshape(3*(K+4)) or -1 (NULL pad)
      R:       rows of the sub-block interleaver
      K_pi:    padded per-stream length
    NULL *fillers* are not representable here (they depend on F); they are
    masked at LLR level by the caller.
    """
    D = K + 4
    R = -(-D // C_SB)
    K_pi = R * C_SB
    n_null = K_pi - D
    # streams 0 and 1: standard column permutation
    v01 = np.full((2, K_pi), -1, dtype=np.int64)
    for out_j in range(K_pi):
        col = PERM_TURBO[out_j // R]
        row = out_j % R
        src = row * C_SB + col - n_null
        if src >= 0:
            v01[0, out_j] = src
            v01[1, out_j] = src
    # stream 2: pi(k) = (P[k//R] + C*(k%R) + 1) mod K_pi, over the padded
    # matrix written row-wise (NULL-prepended like the others)
    v2 = np.full(K_pi, -1, dtype=np.int64)
    for k in range(K_pi):
        idx = (PERM_TURBO[k // R] + C_SB * (k % R) + 1) % K_pi
        src = idx - n_null
        if src >= 0:
            v2[k] = src
    # circular buffer: w = [v0 | interlaced(v1, v2)]
    w_src = np.full(3 * K_pi, -1, dtype=np.int64)
    w_src[:K_pi] = np.where(v01[0] >= 0, v01[0], -1)           # d0
    w_src[K_pi + 0::2] = np.where(v01[1] >= 0, D + v01[1], -1)  # d1
    w_src[K_pi + 1::2] = np.where(v2 >= 0, 2 * D + v2, -1)      # d2
    nonnull = np.nonzero(w_src >= 0)[0]
    nn_rank = np.cumsum(w_src >= 0) - (w_src >= 0)  # rank of position j
    return {"w_src": w_src, "R": R, "K_pi": K_pi,
            "nonnull": nonnull, "nn_rank": nn_rank}


def rv_start(K: int, rv: int, n_cb: int | None = None) -> int:
    m = turbo_rm_maps(K)
    R = m["R"]
    if n_cb is None:
        n_cb = 3 * m["K_pi"]
    return R * (2 * (-(-n_cb // (8 * R))) * rv + 2)


def rate_match_turbo(d: np.ndarray, E: int, rv: int = 0) -> np.ndarray:
    """(3, K+4) streams (with NULL=2 markers) -> E selected bits."""
    K = d.shape[1] - 4
    m = turbo_rm_maps(K)
    flat = d.reshape(-1)
    w = np.full(3 * m["K_pi"], 2, dtype=np.uint8)   # 2 = NULL
    valid = m["w_src"] >= 0
    w[valid] = flat[m["w_src"][valid]]
    k0 = rv_start(K, rv)
    Kw = 3 * m["K_pi"]
    # the E bits read cyclically from k0, NULLs skipped (the port's bit
    # loop, as one gather)
    order = np.roll(np.arange(Kw), -(k0 % Kw))
    live = order[w[order] != 2]
    reps = -(-E // len(live))
    return w[np.tile(live, reps)[:E]].astype(np.uint8)

