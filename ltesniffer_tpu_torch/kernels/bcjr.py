"""Windowed max-log BCJR pass: the hand-written CUDA kernel and its plain
torch twin.

`bcjr(apr, l_sys, l_par, a0, bK) -> (ext, a_end, b_start)` is one
constituent BCJR pass over W-step windows for L lanes (one lane per code
block x window), the function of the TPU kernel
`ltesniffer_tpu/kernels/turbo_pallas.py:make_bcjr`:

  apr, l_sys, l_par: (W, L) f32;  a0, bK: (8, L) f32
  ext (W, L) = llr - (apr + l_sys);  a_end (8, L);  b_start (8, L)

On CUDA tensors the wrapper launches `csrc/bcjr.cu` (built with nvcc at
first use into `ltesniffer_tpu_torch/_build/` by `nvcc_build`) or
raises; on CPU tensors it runs `bcjr_plain`, which forms every sum in the
kernel's order.  `LAUNCHES["bcjr"]` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from . import nvcc_build
from .cplx import const
from .nvcc_build import BUILD_DIR, BUILD_SECONDS, NVCC_FLAGS  # noqa: F401

SRC = os.path.join(nvcc_build.CSRC, "bcjr.cu")
HEADER = os.path.join(nvcc_build.CSRC, "bcjr_step.cuh")

LAUNCHES = {"bcjr": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# trellis tables (also hard-coded in csrc/bcjr_step.cuh; the tests compare
# them)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def trellis_lanes():
    """Index tables of the 8-state RSC trellis in the kernel's form.

    Branch metric g[c] with c = 2*x + parity is one of
    {a+b, a-b, b-a, -(a+b)} for a = (apr+l_sys)/2, b = l_par/2.
    Forward: state n <- (P0[n], metric C0[n]) | (P1[n], metric C1[n]).
    Backward: state s -> (N0[s], metric CB0[s]) | (N1[s], metric CB1[s]).
    """
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    t = turbo_host.rsc_tables()
    ns, par = t["next_state"], t["parity"]
    prev = [[] for _ in range(8)]
    for s in range(8):
        for x in (0, 1):
            prev[int(ns[s, x])].append((s, x))
    P0 = np.array([prev[n][0][0] for n in range(8)], np.int64)
    P1 = np.array([prev[n][1][0] for n in range(8)], np.int64)
    C0 = np.array([2 * prev[n][0][1] + int(par[prev[n][0]])
                   for n in range(8)], np.int64)
    C1 = np.array([2 * prev[n][1][1] + int(par[prev[n][1]])
                   for n in range(8)], np.int64)
    N0 = ns[:, 0].astype(np.int64)
    N1 = ns[:, 1].astype(np.int64)
    CB0 = par[:, 0].astype(np.int64)
    CB1 = (2 + par[:, 1]).astype(np.int64)
    return dict(P0=P0, C0=C0, P1=P1, C1=C1, N0=N0, CB0=CB0, N1=N1,
                CB1=CB1)


def _gammas(a, b):
    return torch.stack([a + b, a - b, b - a, -(a + b)])      # (4, L)


def bcjr_plain(apr, l_sys, l_par, a0, bK):
    """Plain torch version of the kernel: same arithmetic, same order."""
    W, L = apr.shape
    dev = apr.device
    t = {k: const(v, dev) for k, v in trellis_lanes().items()}
    alphas = torch.empty((W, 8, L), dtype=torch.float32, device=dev)
    alpha = a0
    for k in range(W):
        alphas[k] = alpha
        g = _gammas(0.5 * (apr[k] + l_sys[k]), 0.5 * l_par[k])
        anew = torch.maximum(alpha[t["P0"]] + g[t["C0"]],
                             alpha[t["P1"]] + g[t["C1"]])
        alpha = anew - anew[0]
    a_end = alpha
    ext = torch.empty_like(apr)
    beta = bK
    for i in range(W):
        k = W - 1 - i
        l_in = apr[k] + l_sys[k]
        g = _gammas(0.5 * l_in, 0.5 * l_par[k])
        t0 = g[t["CB0"]] + beta[t["N0"]]
        t1 = g[t["CB1"]] + beta[t["N1"]]
        m0 = torch.max(alphas[k] + t0, dim=0).values
        m1 = torch.max(alphas[k] + t1, dim=0).values
        ext[k] = (m0 - m1) - l_in
        bnew = torch.maximum(t0, t1)
        beta = bnew - bnew[0]
    return ext, a_end, beta


# ---------------------------------------------------------------------------
# build + bind (kernels/nvcc_build.py: nvcc by hand, plain C ABI, ctypes)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/bcjr.cu (at first use) and return its ctypes entry."""
    fn = nvcc_build.load("bcjr", SRC, (HEADER,)).bcjr_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return BUILD_SECONDS.get("bcjr", 0.0)


def _check(x, shape, name):
    if x.dtype != torch.float32:
        raise TypeError(f"bcjr: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"bcjr: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"bcjr: {name} must be contiguous")


def bcjr_cuda(apr, l_sys, l_par, a0, bK):
    """Launch the CUDA kernel on the current stream of the tensors'
    device, with that device made current for the launch (CUDA tensors
    only)."""
    W, L = apr.shape
    if W not in (8, 16, 32):
        raise ValueError(f"bcjr: window {W} not in (8, 16, 32)")
    dev = apr.device
    for x, shape, name in ((apr, (W, L), "apr"), (l_sys, (W, L), "l_sys"),
                           (l_par, (W, L), "l_par"), (a0, (8, L), "a0"),
                           (bK, (8, L), "bK")):
        _check(x, shape, name)
        if x.device != dev:
            raise ValueError(f"bcjr: {name} on {x.device}, apr on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"bcjr_cuda: tensors on {dev}, not a CUDA device")
    fn = _library()
    ext = torch.empty((W, L), dtype=torch.float32, device=dev)
    a_end = torch.empty((8, L), dtype=torch.float32, device=dev)
    b_start = torch.empty((8, L), dtype=torch.float32, device=dev)
    # the launch goes to the current device's context: make it the
    # tensors' (tensors on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(apr.data_ptr(), l_sys.data_ptr(), l_par.data_ptr(),
                 a0.data_ptr(), bK.data_ptr(), ext.data_ptr(),
                 a_end.data_ptr(), b_start.data_ptr(), L, W, stream)
    if err != 0:
        raise RuntimeError(f"bcjr kernel launch failed: cudaError {err}")
    LAUNCHES["bcjr"] += 1
    return ext, a_end, b_start


def bcjr(apr, l_sys, l_par, a0, bK):
    """The BCJR pass: CUDA kernel for CUDA tensors, plain twin for CPU."""
    if apr.device.type == "cuda":
        return bcjr_cuda(apr, l_sys, l_par, a0, bK)
    if apr.device.type != "cpu":
        raise ValueError(f"bcjr: unsupported device {apr.device}")
    return bcjr_plain(apr, l_sys, l_par, a0, bK)


def bytes_moved(W: int, L: int) -> int:
    """Bytes one pass must move: (W,L) x3 + (8,L) x2 in, (W,L) + (8,L) x2
    out, float32."""
    return (4 * W + 32) * L * 4
