"""LTE CRC computation (36.212 5.1.1).

A NumPy bit-level implementation for host-side encoding (the port's
batched device-side CRC is left out of this copy).

Capability parity target: srsRAN `srsran_crc_*` as used by the reference for
DCI (CRC16 ⊕ RNTI, `lib/src/phy/falcon_phch/falcon_pdcch.c:110-170`), PBCH
(CRC16 ⊕ antenna mask) and DL-SCH/UL-SCH transport blocks (CRC24A/B).
"""
from __future__ import annotations

import functools

import numpy as np

# Polynomials, MSB (x^n) implicit.
CRC24A = (0x864CFB, 24)
CRC24B = (0x800063, 24)
CRC16 = (0x1021, 16)
CRC8 = (0x9B, 8)


def crc_bits(bits: np.ndarray, poly_n) -> np.ndarray:
    """CRC of a bit array (MSB first).  Returns ``n`` CRC bits (MSB first).

    Vectorized via the GF(2) linearity of LTE CRCs (zero init, no final
    XOR): one int matvec against the remainder table instead of a per-bit
    Python loop (matters for 75k-bit transport blocks)."""
    poly, n = poly_n
    bits = np.asarray(bits, dtype=np.uint8).reshape(-1)
    L = len(bits)
    if L == 0:
        return np.zeros(n, dtype=np.uint8)
    cap = 1 << max(6, (L - 1).bit_length())   # pow2 bucket bounds table builds
    table = _remainder_table_i64(poly_n, cap)
    acc = bits[::-1].astype(np.int64) @ table[:L]
    return (acc % 2).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _remainder_table_i64(poly_n, max_len: int) -> np.ndarray:
    return crc_remainder_table(poly_n, max_len).astype(np.int64)


def attach_crc(bits: np.ndarray, poly_n, mask: int = 0) -> np.ndarray:
    """Append CRC bits, XOR-masked with ``mask`` (e.g. RNTI for DCI)."""
    poly, n = poly_n
    c = crc_bits(bits, poly_n)
    mask_bits = np.array([(mask >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)
    return np.concatenate([np.asarray(bits, dtype=np.uint8), c ^ mask_bits])


@functools.lru_cache(maxsize=None)
def crc_remainder_table(poly_n, max_len: int) -> np.ndarray:
    """``R[k] = D^(k+n) mod g(D)`` as bit rows, shape (max_len, n).

    ``crc(m)[j] = XOR_i m_reversed[i] * R[i][j]``  for message length <= max_len.
    """
    poly, n = poly_n
    mask = (1 << n) - 1
    top = 1 << (n - 1)
    out = np.zeros((max_len, n), dtype=np.uint8)
    rem = 1  # D^0; we need D^(k+n) mod g -> start from D^n mod g = poly
    # D^n mod g(D) == poly (low n bits)
    rem = poly & mask
    for k in range(max_len):
        out[k] = [(rem >> (n - 1 - i)) & 1 for i in range(n)]
        # multiply by D
        if rem & top:
            rem = ((rem << 1) ^ poly) & mask
        else:
            rem = (rem << 1) & mask
    return out

