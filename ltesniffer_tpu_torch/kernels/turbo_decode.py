"""Whole turbo decode in one launch: the wrapper of the hand-written CUDA
kernel `csrc/turbo_decode.cu`.

`turbo_decode_cuda(d_llrs, K, n_iter) -> (bits (B, K) uint8, llr (B, K) f32)`
runs every iteration of both constituent decoders, the QPP interleave, the
window-boundary handover, the tail-terminated beta_K, the final LLR and the
hard decision for B code blocks of size K in one kernel launch.  It is the
function of `ltesniffer_tpu/kernels/turbo.py:_make_decoder_pallas` (with
the TPU kernel `turbo_pallas.make_bcjr` inside it); its plain version is
the port's lane decoder `kernels/turbo.py:make_decoder_lanes` over the plain
BCJR twin, which forms every sum in the kernel's order.
`kernels/turbo.py:make_decoder` launches this kernel for CUDA tensors and
runs the plain version for CPU tensors.

The kernel is built with nvcc at first use (`nvcc_build`) and launched on
the current stream; `LAUNCHES["turbo_decode"]` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from ltesniffer_tpu_torch.phy import tables_data
from . import nvcc_build

SRC = os.path.join(nvcc_build.CSRC, "turbo_decode.cu")
HEADER = os.path.join(nvcc_build.CSRC, "bcjr_step.cuh")

LAUNCHES = {"turbo_decode": 0}

MIN_THREADS = 64          # pack code blocks into a CTA up to this many
MAX_THREADS = 192         # the kernel's launch bound
MAX_SMEM = 232448         # dynamic shared memory one block may have (H100)
SEG = 8                   # checkpoint spacing of the alpha window (kSeg)
OPS_PER_STEP = 107        # float32 operations per trellis step and pass


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window_len(K: int) -> int:
    """Largest power-of-two window <= 32 dividing K (every 36.212 K is a
    multiple of 8)."""
    for w in (32, 16, 8):
        if K % w == 0:
            return w
    return K


def launch_geometry(K: int, B: int) -> dict:
    """How the kernel is launched for B code blocks of size K: window W,
    windows NW (threads per code block), checkpoint spacing S, code blocks
    per CTA G, threads per CTA, CTAs, dynamic shared memory bytes."""
    W = window_len(K)
    NW = K // W
    S = min(W, SEG)
    G = max(1, min(-(-MIN_THREADS // NW), max(B, 1)))
    smem = G * (4 * (K + NW) + 32 * NW + 32) * 4   # .cu block_floats
    return dict(W=W, NW=NW, S=S, G=G, threads=G * NW, ctas=-(-B // G),
                smem=smem)


def bytes_moved(K: int, B: int) -> int:
    """Bytes one decode must move: d_llrs (B, 3, K+4) f32 read once, llr
    (B, K) f32 and bits (B, K) u8 written once."""
    return B * 3 * (K + 4) * 4 + B * K * 4 + B * K


def ops(K: int, B: int, n_iter: int) -> int:
    """Float32 operations of one decode: OPS_PER_STEP per trellis step of
    each of the 2 * n_iter constituent passes, and the final LLR's two adds
    (the tail's 3 steps are left out; recomputed alphas are not counted)."""
    return OPS_PER_STEP * 2 * n_iter * K * B + 2 * K * B


@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/turbo_decode.cu (at first use) and return its entry."""
    fn = nvcc_build.load("turbo_decode", SRC, (HEADER,)).turbo_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("turbo_decode", 0.0)


def turbo_decode_cuda(d_llrs, K: int, n_iter: int):
    """Launch the fused decode on the current stream of d_llrs' device,
    with that device made current for the launch (CUDA tensors only).

    d_llrs: (B, 3, K+4) float32, contiguous.  Returns (bits (B, K) uint8,
    llr (B, K) float32) on d_llrs' device."""
    if K not in tables_data.QPP_F1_F2:
        raise ValueError(f"turbo_decode: K={K} is not an LTE code-block "
                         "size")
    if int(n_iter) < 1:
        raise ValueError(f"turbo_decode: n_iter={n_iter} < 1")
    if d_llrs.dtype != torch.float32:
        raise TypeError(f"turbo_decode: d_llrs must be float32, got "
                        f"{d_llrs.dtype}")
    if d_llrs.dim() != 3 or tuple(d_llrs.shape[1:]) != (3, K + 4):
        raise ValueError(f"turbo_decode: d_llrs has shape "
                         f"{tuple(d_llrs.shape)}, expected (B, 3, {K + 4})")
    if not d_llrs.is_contiguous():
        raise ValueError("turbo_decode: d_llrs must be contiguous")
    dev = d_llrs.device
    if dev.type != "cuda":
        raise ValueError(f"turbo_decode_cuda: d_llrs on {dev}, not a CUDA "
                         "device")
    B = d_llrs.shape[0]
    geo = launch_geometry(K, B)
    if geo["threads"] > MAX_THREADS or geo["smem"] > MAX_SMEM:
        raise ValueError(f"turbo_decode: K={K} needs {geo['threads']} "
                         f"threads and {geo['smem']} bytes of shared memory")
    llr = torch.empty((B, K), dtype=torch.float32, device=dev)
    bits = torch.empty((B, K), dtype=torch.uint8, device=dev)
    if B == 0:
        return bits, llr
    fn = _library()
    f1, f2 = tables_data.QPP_F1_F2[K]
    # the launch goes to the current device's context: make it the
    # tensor's (a tensor on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(d_llrs.data_ptr(), llr.data_ptr(), bits.data_ptr(), B, K,
                 int(n_iter), f1, f2, geo["W"], geo["G"], stream)
    if err != 0:
        raise RuntimeError(f"turbo_decode kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["turbo_decode"] += 1
    return bits, llr
