"""Float-pair complex arithmetic for the device path.

Device tensors represent complex values as float32 arrays with a trailing
re/im axis of size 2 — the layout of the JAX reference package, kept at
every public function so tensors compare one to one.  DFTs become four
real matmuls and elementwise complex math becomes plain float math.

Host boundary: `to_ri` views numpy complex64 as (..., 2) float32;
`to_i16` quantizes it to int16 pairs with one global scale;
`to_i8_packed` / `view_i64` pack it as int8 IQ for the device, and
`unpack_i8` unpacks one subframe on the host.  `const` uploads a cached
numpy constant to a device once.
"""
from __future__ import annotations

import numpy as np
import torch

_CONST_CACHE: dict = {}


def const(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Device copy of a host constant, uploaded once per (array, device,
    dtype).  ``arr`` must be a long-lived array (lru-cached tables): the
    cache keeps a reference to it, so its id stays unique."""
    key = (id(arr), str(device), dtype)
    hit = _CONST_CACHE.get(key)
    if hit is None or hit[0] is not arr:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.to(device=device, dtype=dtype) if dtype is not None \
            else t.to(device)
        hit = _CONST_CACHE[key] = (arr, t)
    return hit[1]


def to_ri(x: np.ndarray) -> np.ndarray:
    """numpy complex64 -> (..., 2) float32 (host side)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def to_i16(x: np.ndarray):
    """numpy complex64 -> ((..., 2) int16, scale) quantized IQ (host side).

    Halves host->device bytes vs float pairs; the ~90 dB quantization SNR
    is far beyond any radio front-end (SDR ADCs are 12-14 bit)."""
    ri = to_ri(x)
    peak = float(np.max(np.abs(ri))) or 1.0
    scale = peak / 32000.0
    return np.round(ri / scale).astype(np.int16), np.float32(scale)


def to_i8_packed(x: np.ndarray):
    """numpy complex64 frames (B, RX, n) -> ((B, RX, n/2) int32 packed
    int8 IQ, (B,) float32 per-subframe scales).

    8-bit IQ with per-subframe AGC: ~42 dB SNR below each subframe's peak —
    above the ~35 dB a 256QAM grant needs and at the fidelity of real SDR
    front-ends.  Device-side unpack is 4 shift/mask ops
    (`frontend._unpack_i8`)."""
    ri = to_ri(x)                                  # (B, RX, n, 2) f32
    B = ri.shape[0]
    flat = ri.reshape(B, -1)
    # per-subframe peak without an |.| temporary (one less full pass)
    peak = np.maximum(flat.max(axis=1), -flat.min(axis=1))
    peak[peak == 0] = 1.0
    scales = (peak / 126.0).astype(np.float32)
    q = np.multiply(ri, (1.0 / scales)[:, None, None, None],
                    dtype=np.float32)
    np.rint(q, out=q)
    q = q.astype(np.int8)
    # explicit little-endian word view: the device-side unpack shifts
    # assume byte k sits at bits 8k (true only for '<i4' words)
    packed = (np.ascontiguousarray(q).reshape(B, ri.shape[1], -1)
              .view(np.dtype("<i4")))
    return packed, scales


def view_i64(packed: np.ndarray) -> np.ndarray:
    """(..., n/2) '<i4' packed words -> (..., n/4) '<i8' zero-copy view.

    Pairs adjacent int32 words into one int64 element (w0 in the low half
    on little-endian hosts; the device-side unpack splits each int64 back
    into [w0, w1] order)."""
    assert packed.shape[-1] % 2 == 0
    return np.ascontiguousarray(packed).view(np.dtype("<i8"))


def unpack_i8(packed_row: np.ndarray, scale: float) -> np.ndarray:
    """Inverse of `to_i8_packed` for one subframe: (RX, n/2) '<i4' words +
    scale -> (RX, n) complex64 (host side; PRACH correlation runs on host
    numpy for the occasional allowed subframe)."""
    b = np.ascontiguousarray(packed_row).view(np.int8)
    ri = b.astype(np.float32).reshape(packed_row.shape[0], -1, 2) * scale
    return ri.view(np.complex64).reshape(packed_row.shape[0], -1)


def cmul(a, b):
    """a * b for (..., 2) pairs."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def cmul_conj(a, b):
    """a * conj(b)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ai * br - ar * bi], dim=-1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def cscale(a, s):
    """a * real s (broadcast over the pair axis)."""
    return a * s[..., None]


def cabs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def cdiv_real(a, d):
    """a / real d."""
    return a / d[..., None]


def cmatmul(x, w_re, w_im):
    """Complex matmul: x (..., K, 2) @ W (K, N) -> (..., N, 2), with W given
    as separate real/imag float32 matrices (four real matmuls)."""
    xr, xi = x[..., 0], x[..., 1]
    yr = torch.matmul(xr, w_re) - torch.matmul(xi, w_im)
    yi = torch.matmul(xr, w_im) + torch.matmul(xi, w_re)
    return torch.stack([yr, yi], dim=-1)


def dft_matrices(n_in: int, bins: np.ndarray, sign: float = -1.0,
                 scale: float = 1.0):
    """(n_in, len(bins)) cos/sin DFT matrices: Y[k] = sum_n x[n] e^{sign*j*2pi*n*bins[k]/n_in}."""
    n = np.arange(n_in)[:, None]
    k = np.asarray(bins)[None, :]
    ang = sign * 2.0 * np.pi * n * k / n_in
    return (np.cos(ang).astype(np.float32) * scale,
            np.sin(ang).astype(np.float32) * scale)
