"""Modulation mappers (36.211 7.1) — NumPy, TX/test side.

Gray-mapped QPSK/16QAM/64QAM/256QAM per the spec tables.  The soft demappers
(RX, JAX) live in `ltesniffer_tpu_torch.kernels.demapper`.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def constellation(qm: int) -> np.ndarray:
    """Symbol table indexed by the Qm-bit label (MSB-first, 36.211 7.1)."""
    if qm == 2:
        # (b0,b1): I from b0, Q from b1; 0 -> +1/sqrt2
        table = np.empty(4, dtype=np.complex64)
        for label in range(4):
            b0, b1 = (label >> 1) & 1, label & 1
            table[label] = ((1 - 2 * b0) + 1j * (1 - 2 * b1)) / np.sqrt(2.0)
        return table
    if qm == 4:
        # 16QAM: I from (b0, b2), Q from (b1, b3); (0,0)->1, (0,1)->3 /sqrt10
        amp = {(0, 0): 1.0, (0, 1): 3.0, (1, 0): -1.0, (1, 1): -3.0}
        table = np.empty(16, dtype=np.complex64)
        for label in range(16):
            b = [(label >> (3 - i)) & 1 for i in range(4)]
            table[label] = (amp[(b[0], b[2])] + 1j * amp[(b[1], b[3])]) / np.sqrt(10.0)
        return table
    if qm == 6:
        # 64QAM: I from (b0,b2,b4), Q from (b1,b3,b5)
        amp = {(0, 0, 0): 3.0, (0, 0, 1): 1.0, (0, 1, 0): 5.0, (0, 1, 1): 7.0}
        full = {}
        for bits, a in amp.items():
            full[bits] = a
            full[(1,) + bits[1:]] = -a
        table = np.empty(64, dtype=np.complex64)
        for label in range(64):
            b = [(label >> (5 - i)) & 1 for i in range(6)]
            i_amp = full[(b[0], b[2], b[4])]
            q_amp = full[(b[1], b[3], b[5])]
            table[label] = (i_amp + 1j * q_amp) / np.sqrt(42.0)
        return table
    if qm == 8:
        # 256QAM: I from (b0,b2,b4,b6), Q from (b1,b3,b5,b7)
        amp4 = {
            (0, 0, 0, 0): 5.0, (0, 0, 0, 1): 7.0, (0, 0, 1, 0): 3.0, (0, 0, 1, 1): 1.0,
            (0, 1, 0, 0): 11.0, (0, 1, 0, 1): 9.0, (0, 1, 1, 0): 13.0, (0, 1, 1, 1): 15.0,
        }
        full = {}
        for bits, a in amp4.items():
            full[bits] = a
            full[(1,) + bits[1:]] = -a
        table = np.empty(256, dtype=np.complex64)
        for label in range(256):
            b = [(label >> (7 - i)) & 1 for i in range(8)]
            i_amp = full[(b[0], b[2], b[4], b[6])]
            q_amp = full[(b[1], b[3], b[5], b[7])]
            table[label] = (i_amp + 1j * q_amp) / np.sqrt(170.0)
        return table
    raise ValueError(qm)


def modulate(bits: np.ndarray, qm: int) -> np.ndarray:
    """Bit array (len divisible by qm, MSB-first per symbol) -> symbols."""
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, qm)
    weights = 1 << np.arange(qm - 1, -1, -1)
    labels = (bits * weights).sum(axis=1)
    return constellation(qm)[labels]
