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

`turbo_decode_pack_cuda(d_llrs, K, n_iter, out, word_off)` is the same
decode through the kernel's packing entry: in place of the LLRs and bits
it writes each code block's row [CB CRC24B remainder popcount | u32 words
of its bits] (`sniffer/pdsch_rx.py:_crc_pack`'s layout, which
`kernels/tb_finish.py` reads) into `out` from `word_off` on, one launch for
every code block of one K of a dispatch (`pdsch_rx._turbo_only_fn`).

The kernel is built with nvcc at first use (`nvcc_build`) and launched on
the current stream; `LAUNCHES["turbo_decode"]` counts its launches, and
each launch adds its B code blocks to the tracer's counters `turbo_cb` and
`turbo_cb.K<K>` (`sniffer/prof.py`: total / events is the code blocks a
launch).
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from ltesniffer_tpu_torch.phy import tables_data
from ltesniffer_tpu_torch.sniffer import prof
from . import nvcc_build

SRC = os.path.join(nvcc_build.CSRC, "turbo_decode.cu")
HEADER = os.path.join(nvcc_build.CSRC, "bcjr_step.cuh")

LAUNCHES = {"turbo_decode": 0, "turbo_decode_pack": 0}

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


def bytes_moved_pack(K: int, B: int) -> int:
    """Bytes one decode through the packing entry must move: d_llrs read
    once, each code block's row of 1 + ceil(K / 32) int64 words written
    once."""
    return B * 3 * (K + 4) * 4 + B * (1 + (K + 31) // 32) * 8


def ops(K: int, B: int, n_iter: int) -> int:
    """Float32 operations of one decode: OPS_PER_STEP per trellis step of
    each of the 2 * n_iter constituent passes, and the final LLR's two adds
    (the tail's 3 steps are left out; recomputed alphas are not counted)."""
    return OPS_PER_STEP * 2 * n_iter * K * B + 2 * K * B


@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/turbo_decode.cu (at first use) and return its library,
    both entries bound."""
    lib = nvcc_build.load("turbo_decode", SRC, (HEADER,))
    lib.turbo_decode_launch.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.turbo_decode_pack_launch.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for fn in (lib.turbo_decode_launch, lib.turbo_decode_pack_launch):
        fn.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("turbo_decode", 0.0)


def _check(d_llrs, K: int, n_iter: int) -> dict:
    """The launch geometry of d_llrs' decode, or raises on what the kernel
    does not take."""
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
    geo = launch_geometry(K, d_llrs.shape[0])
    if geo["threads"] > MAX_THREADS or geo["smem"] > MAX_SMEM:
        raise ValueError(f"turbo_decode: K={K} needs {geo['threads']} "
                         f"threads and {geo['smem']} bytes of shared memory")
    return geo


def _launch(entry: str, d_llrs, outs, K: int, n_iter: int, geo: dict):
    """One launch of `entry` with the output pointers `outs`, counted."""
    B = d_llrs.shape[0]
    fn = getattr(_library(), entry)
    f1, f2 = tables_data.QPP_F1_F2[K]
    dev = d_llrs.device
    # the launch goes to the current device's context: make it the
    # tensor's (a tensor on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(d_llrs.data_ptr(), *outs, B, K, int(n_iter), f1, f2,
                 geo["W"], geo["G"], stream)
    if err != 0:
        raise RuntimeError(f"turbo_decode kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["turbo_decode"] += 1
    prof.count("turbo_cb", B)
    prof.count(f"turbo_cb.K{K}", B)


def turbo_decode_cuda(d_llrs, K: int, n_iter: int):
    """Launch the fused decode on the current stream of d_llrs' device,
    with that device made current for the launch (CUDA tensors only).

    d_llrs: (B, 3, K+4) float32, contiguous.  Returns (bits (B, K) uint8,
    llr (B, K) float32) on d_llrs' device."""
    geo = _check(d_llrs, K, n_iter)
    B, dev = d_llrs.shape[0], d_llrs.device
    llr = torch.empty((B, K), dtype=torch.float32, device=dev)
    bits = torch.empty((B, K), dtype=torch.uint8, device=dev)
    if B:
        _launch("turbo_decode_launch", d_llrs,
                (llr.data_ptr(), bits.data_ptr()), K, n_iter, geo)
    return bits, llr


def turbo_decode_pack_cuda(d_llrs, K: int, n_iter: int, out=None,
                           word_off: int = 0):
    """The decode through the packing entry, on the current stream of
    d_llrs' device with that device made current (CUDA tensors only).

    d_llrs: (B, 3, K+4) float32, contiguous.  Writes B rows of
    1 + ceil(K / 32) int64 words ([CB CRC24B remainder popcount | u32
    words of the decided bits]) into the 1-d int64 tensor `out` (a new
    one if None) from word `word_off` on; returns them as a (B, 1 + Wk)
    view.  No LLRs: the launch writes the rows alone."""
    geo = _check(d_llrs, K, n_iter)
    B, dev = d_llrs.shape[0], d_llrs.device
    n = B * (1 + (K + 31) // 32)
    if out is None:
        out = torch.empty(n, dtype=torch.int64, device=dev)
    if out.dtype != torch.int64 or out.dim() != 1 or \
            not out.is_contiguous() or out.device != dev or word_off < 0 or \
            word_off + n > out.numel():
        raise ValueError(f"turbo_decode: the rows' buffer (a "
                         f"{tuple(out.shape)} {out.dtype} tensor on "
                         f"{out.device}) does not take {n} int64 words at "
                         f"{word_off} on {dev}")
    rows = out[word_off:word_off + n]
    if B:
        _launch("turbo_decode_pack_launch", d_llrs, (rows.data_ptr(),), K,
                n_iter, geo)
        LAUNCHES["turbo_decode_pack"] += 1
    return rows.view(B, -1)
