"""Tail-biting convolutional code + rate matching (36.212 5.1.3.1 / 5.1.4.2).

Used by PDCCH (DCI) and PBCH (MIB).  Host-side NumPy here serves two roles:

* the test-side transmitter (`ltesniffer_tpu_torch.testing.encoder`);
* precomputation of the de-rate-matching index maps that the batched JAX
  Viterbi path (`ltesniffer_tpu_torch.kernels.viterbi`) consumes as compile-time
  constants or device tensors.

Replaces the srsRAN `rm_conv` / conv-encoder surface the reference leans on
for its blind search (`lib/src/phy/falcon_phch/falcon_pdcch.c:110-170`).
"""
from __future__ import annotations

import functools

import numpy as np

K_CONV = 7
_POLYS = (0o133, 0o171, 0o165)
N_STREAMS = 3
C_SUBBLOCK = 32
# 36.212 Table 5.1.4-2: inter-column permutation for the conv sub-block interleaver
PERM_CONV = np.array([
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30], dtype=np.int64)


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def trellis_tables():
    """Static trellis tables for the rate-1/3 K=7 code.

    Returns dict with, for all 64 states s and inputs b in {0,1}:
      out_bits:  (64, 2, 3) uint8 — encoder output for (state, input)
      next_state:(64, 2) int32
      pred:      (64, 2) int32 — the two predecessor states of each state
      pred_bit:  (64,)  int32 — input bit that leads *into* each state
    State convention: s = [u_{k-1} .. u_{k-6}] packed with u_{k-1} as bit 5.
    New state after input b: (b << 5) | (s >> 1).
    """
    s = np.arange(64)[:, None]          # (64, 1)
    b = np.arange(2)[None, :]           # (1, 2)
    reg = (b << 6) | s                  # 7-bit register [u_k, u_{k-1}..u_{k-6}]
    out = np.stack([_parity(reg & p) for p in _POLYS], axis=-1).astype(np.uint8)
    nxt = ((b << 5) | (s >> 1)).astype(np.int32)
    ns = np.arange(64)
    pred = np.stack([((ns & 31) << 1), ((ns & 31) << 1) | 1], axis=-1).astype(np.int32)
    pred_bit = (ns >> 5).astype(np.int32)
    return {"out_bits": out, "next_state": nxt, "pred": pred, "pred_bit": pred_bit}


def conv_encode_tb(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: returns (3, D) coded streams d^(0..2)."""
    bits = np.asarray(bits, dtype=np.uint8)
    D = len(bits)
    t = trellis_tables()
    # initial state = last 6 info bits, u_{D-1} in bit 5
    state = 0
    for i in range(1, 7):
        state |= int(bits[D - i]) << (6 - i)
    out = np.empty((N_STREAMS, D), dtype=np.uint8)
    for k in range(D):
        b = int(bits[k])
        out[:, k] = t["out_bits"][state, b]
        state = int(t["next_state"][state, b])
    return out


def subblock_interleave_indices(D: int):
    """Column-permuted read order for one stream.

    Returns (perm, K_pi): ``v[j] = d[perm[j]]`` with ``perm[j] = -1`` for
    <NULL> positions; K_pi = len(perm) = R*32.
    """
    R = -(-D // C_SUBBLOCK)
    K_pi = R * C_SUBBLOCK
    n_null = K_pi - D
    perm = np.empty(K_pi, dtype=np.int64)
    j = 0
    for c in PERM_CONV:
        for r in range(R):
            src = r * C_SUBBLOCK + c - n_null
            perm[j] = src if src >= 0 else -1
            j += 1
    return perm, K_pi


@functools.lru_cache(maxsize=64)
def rate_match_maps(D: int, E: int):
    """Index maps between the E rate-matched bits and the (3, D) streams.

    Returns dict:
      e_to_d:    (E,) int64 — flat index into d.reshape(3*D) for each output bit
      w_nonnull: (3*K_pi,) validity info (for reference/tests)
    The circular-buffer w is v0||v1||v2; selection skips NULLs (36.212
    5.1.4.2.2 with k0 = 0 for the conv code).
    """
    perm, K_pi = subblock_interleave_indices(D)
    # w position -> (stream, original index) or -1
    w_src = np.concatenate([
        np.where(perm >= 0, i * D + perm, -1) for i in range(N_STREAMS)])
    nonnull = np.nonzero(w_src >= 0)[0]
    cycle = w_src[nonnull]              # length 3*D
    e_to_d = cycle[np.arange(E) % len(cycle)]
    return {"e_to_d": e_to_d.astype(np.int64), "w_src": w_src}


def rate_match(d: np.ndarray, E: int) -> np.ndarray:
    """Rate-match (3, D) coded bits to E output bits."""
    D = d.shape[1]
    maps = rate_match_maps(D, E)
    flat = d.reshape(-1)
    return flat[maps["e_to_d"]].astype(np.uint8)

