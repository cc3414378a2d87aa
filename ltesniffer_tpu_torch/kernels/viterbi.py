"""Batched tail-biting Viterbi decoder: the hand-written CUDA kernel and
its plain torch version.

The blind-search hot loop: the reference decodes each PDCCH candidate
sequentially through srsRAN's SSE Viterbi
(`lib/src/phy/falcon_phch/falcon_pdcch.c:110-170` →
`srsran_pdcch_dci_decode`); here *all* (location × format × subframe)
candidates decode in one batched call.  Counterpart of
`ltesniffer_tpu/kernels/viterbi.py:56 _acs_scan` and `:82 _traceback`,
reached through `:98 viterbi_decode_tb` and `:119 viterbi_decode_tb_multi`
(an XLA `lax.scan`, no `pallas_call`).

`viterbi_decode_tb` / `viterbi_decode_tb_multi` launch the CUDA kernel
`csrc/viterbi_tb.cu` for CUDA tensors (built with nvcc at first use into
`ltesniffer_tpu_torch/_build/` by `nvcc_build`; one launch per call, every
payload size of the call in it) or raise; for CPU tensors they run the
plain version below.  `LAUNCHES["viterbi"]` counts kernel launches and
`PLAIN_CUDA["viterbi"]` counts plain step loops run on a CUDA tensor (only
a comparison with the kernel does that).

The plain version has the JAX package's structure:

* the add-compare-select step is a **butterfly**: with the state
  convention s' = (b << 5) | (s >> 1), the two predecessors of states n and
  n+32 are the adjacent pair (2(n&31), 2(n&31)+1), so the 64-state update
  is a reshape plus a max — no gathers;
* branch metrics for all (state, input) come from ONE (B, 3) × (3, 128)
  matmul against the constant ±1 encoder-output signs;
* tail-biting is handled by a circular wrap: `wrap` training steps are
  prepended/appended from the other end and only the middle D decisions
  are kept;
* survivor decisions are bit-packed into two 32-bit words per step and
  codeword, held in int64 (uint32 has little CUDA support in torch);
* candidates of different payload sizes decode in one fused scan
  (`viterbi_decode_tb_multi_plain`): shorter codewords are zero-LLR-padded
  at the *front*, so the step count of the whole blind search is max T_i.

What bounds the kernel on the card: float32 operations (about
`OPS_PER_STEP` per codeword and trellis step; one search call of 64
subframes is 6.9 M codeword-steps, 34 us at 67 TFLOP/s against 12 us for
its 40 MB of LLRs and bits).  What the design does about it: one codeword
per thread with its 64 path metrics in registers (no warp exchange in
the recurrence), the LLRs staged once per warp in shared memory, the
decisions of the traceback's steps in shared memory and a traceback in
every lane, the circular wrap as an index and each codeword's own step
count (the plain version's front pad leaves every metric at +0, so
skipping it changes no bit); see the note at the top of the source.
The payload sizes a launch takes are the source's (`max_d`); `occupancy`
reports a launch's warps per SM and shared memory per block.

LLR sign convention: positive LLR ⇒ bit 0.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Sequence

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import conv
from . import nvcc_build
from .cplx import const

SRC = os.path.join(nvcc_build.CSRC, "viterbi_tb.cu")

LAUNCHES = {"viterbi": 0}
PLAIN_CUDA = {"viterbi": 0}   # plain step loops run on a CUDA tensor

# payload sizes one launch takes: the .cu's kMaxGroups, checked against
# it when the library loads; the C entry owns every other launch limit
MAX_GROUPS = 8
# float32 operations per codeword and trellis step: 4 distinct branch sums
# of 2 adds, 128 adds, 64 compares, 63 for the maximum, 64 subtracts
OPS_PER_STEP = 2 * 4 + 128 + 64 + 63 + 64


def reset_launches():
    for d in (LAUNCHES, PLAIN_CUDA):
        for k in d:
            d[k] = 0


@functools.lru_cache(maxsize=1)
def _tables():
    t = conv.trellis_tables()
    # signs[s, b, i] = +1 if encoder output bit i is 0 else -1
    signs = (1.0 - 2.0 * t["out_bits"].astype(np.float32))   # (64, 2, 3)
    # butterfly layout: bm_mat[(i), (b*64 + s)] — column-major over (b, s) so
    # bm.reshape(B, 2, 64) indexes [input b][prev state s]
    bm_mat = np.transpose(signs, (2, 1, 0)).reshape(3, 128).copy()
    return t, bm_mat


_PACK_W = (1 << np.arange(32, dtype=np.int64))


def _acs_scan(llr_seq):
    """Forward pass: llr_seq (T, B, 3) -> (final path metrics (B, 64),
    packed decisions (T, B, 2) int64 holding u32 words [new-half])."""
    _, bm_mat_np = _tables()
    dev = llr_seq.device
    bm_mat = const(bm_mat_np, dev, llr_seq.dtype)
    pack_w = const(_PACK_W, dev)
    T, B = llr_seq.shape[0], llr_seq.shape[1]
    if dev.type == "cuda":
        PLAIN_CUDA["viterbi"] += 1
    pm = torch.zeros((B, 64), dtype=llr_seq.dtype, device=dev)
    decs = torch.empty((T, B, 2), dtype=torch.int64, device=dev)
    for t in range(T):
        # (B, 3) @ (3, 128) -> (B, 2 inputs, 64 prev states)
        bm = torch.matmul(llr_seq[t], bm_mat)
        bm = bm.reshape(-1, 2, 32, 2)          # [input b][pair m][j]
        pmp = pm.reshape(-1, 1, 32, 2)         # prev states (2m, 2m+1)
        cand = pmp + bm                        # (B, 2, 32, 2)
        dec = cand[..., 1] > cand[..., 0]      # (B, 2, 32): j choice
        pm = torch.where(dec, cand[..., 1], cand[..., 0]).reshape(-1, 64)
        pm = pm - torch.max(pm, dim=-1, keepdim=True).values
        decs[t] = torch.sum(dec.to(torch.int64) * pack_w, dim=-1)
    return pm, decs


def _traceback(pm_fin, decs):
    """Reverse pass over packed decisions -> (T, B) uint8 bits."""
    state = torch.argmax(pm_fin, dim=-1)       # (B,) first max, as jnp
    T = decs.shape[0]
    bits = torch.empty((T, state.shape[0]), dtype=torch.uint8,
                       device=pm_fin.device)
    for t in range(T - 1, -1, -1):
        # state n = b*32 + m => input bit b = n>>5, pair index m = n&31
        bits[t] = (state >> 5).to(torch.uint8)
        dec_t = decs[t]
        word = torch.where(state >= 32, dec_t[:, 1], dec_t[:, 0])
        j = (word >> (state & 31)) & 1
        state = ((state & 31) << 1) | j       # pred[n, j]
    return bits


def _extend(llrs, wrap: int):
    D = llrs.shape[-1]
    w = min(wrap, D)
    # circular extension: [tail w | body D | head w]
    return torch.cat([llrs[:, :, D - w:], llrs, llrs[:, :, :w]], dim=-1), w


def viterbi_decode_tb_plain(llrs, wrap: int = 32):
    """Plain version of `viterbi_decode_tb` (the step loop, any device).

    Args:
      llrs: (B, 3, D) float32 stream LLRs (positive => bit 0).
      wrap: circular training length (clamped to D).

    Returns:
      bits: (B, D) uint8 decoded payloads.
    """
    B, three, D = llrs.shape
    assert three == 3
    ext, w = _extend(llrs, wrap)
    seq = torch.movedim(ext, -1, 0).contiguous()       # (T, B, 3)
    pm_fin, decs = _acs_scan(seq)
    bits = _traceback(pm_fin, decs).T                  # (B, T)
    return bits[:, w:w + D]


def viterbi_decode_tb_multi_plain(llrs_list: Sequence,
                                  wrap: int = 32) -> List:
    """Plain version of `viterbi_decode_tb_multi`: candidate groups of
    several payload sizes in ONE fused scan (any device).

    Args:
      llrs_list: sequence of (B_i, 3, D_i) float32 LLR tensors.
      wrap: circular training length (clamped per size).

    Returns:
      list of (B_i, D_i) uint8 decoded payloads, same order.
    """
    if len(llrs_list) == 1:
        return [viterbi_decode_tb_plain(llrs_list[0], wrap)]
    exts = []
    meta = []
    for llrs in llrs_list:
        B, three, D = llrs.shape
        assert three == 3
        ext, w = _extend(llrs, wrap)
        meta.append((B, D, w, ext.shape[-1]))
        exts.append(ext)
    t_max = max(m[3] for m in meta)
    # zero-LLR FRONT padding: path metrics stay uniform through the pad, so
    # the real trellis runs identically; traceback only crosses real steps
    # for the kept window [pad+w, pad+w+D).
    padded = [torch.nn.functional.pad(e, (t_max - m[3], 0))
              for e, m in zip(exts, meta)]
    cat = torch.cat(padded, dim=0)                     # (sum B, 3, T_max)
    seq = torch.movedim(cat, -1, 0).contiguous()       # (T_max, sum B, 3)
    pm_fin, decs = _acs_scan(seq)
    bits = _traceback(pm_fin, decs).T                  # (sum B, T_max)
    outs = []
    off = 0
    for (B, D, w, t_ext) in meta:
        pad = t_max - t_ext
        outs.append(bits[off:off + B, pad + w:pad + w + D])
        off += B
    return outs


# ---------------------------------------------------------------------------
# the kernel: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and its wrapper
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/viterbi_tb.cu (at first use) and return its entry."""
    lib = nvcc_build.load("viterbi_tb", SRC)
    lib.viterbi_tb_max_groups.restype = ctypes.c_int
    if lib.viterbi_tb_max_groups() != MAX_GROUPS:
        raise RuntimeError(f"viterbi: the kernel takes "
                           f"{lib.viterbi_tb_max_groups()} groups a launch, "
                           f"the wrapper checks for {MAX_GROUPS}")
    lib.viterbi_tb_launch.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int, ctypes.c_void_p]
    lib.viterbi_tb_launch.restype = ctypes.c_int
    lib.viterbi_tb_max_d.argtypes = [ctypes.c_int]
    lib.viterbi_tb_max_d.restype = ctypes.c_int
    lib.viterbi_tb_occupancy.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.viterbi_tb_occupancy.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("viterbi_tb", 0.0)


def max_d(wrap: int = 32) -> int:
    """The largest payload size D one launch takes with `wrap` (the
    source's shared-memory limit; builds the library)."""
    return int(_library().viterbi_tb_max_d(int(wrap)))


def occupancy(shapes, wrap: int = 32) -> dict:
    """Warps per SM and shared-memory bytes per block of one launch for
    groups of (N, D), on the current CUDA device."""
    ds = [int(d) for _, d in shapes]
    n = len(ds)
    ints = ctypes.c_int * n
    warps, smem = ctypes.c_int(), ctypes.c_int()
    err = _library().viterbi_tb_occupancy(
        ints(*ds), ints(*[min(int(wrap), d) for d in ds]), n,
        ctypes.byref(warps), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"viterbi occupancy query failed: cudaError "
                           f"{err} (D {ds}, wrap {wrap})")
    return dict(warps_per_sm=warps.value, smem_per_block=smem.value)


def bytes_moved(shapes) -> int:
    """Bytes one call must move for groups of (N, D): the (N, 3, D) f32
    LLRs read once and the (N, D) u8 bits written once."""
    return sum(n * 3 * d * 4 + n * d for n, d in shapes)


def ops(shapes, wrap: int = 32) -> int:
    """Float32 operations of one call for groups of (N, D): OPS_PER_STEP
    for each of a codeword's own D + 2 min(wrap, D) steps."""
    return OPS_PER_STEP * sum(n * (d + 2 * min(wrap, d)) for n, d in shapes)


def viterbi_tb_cuda(groups: Sequence, wrap: int = 32) -> List:
    """Launch the kernel once for every group of the call, on the current
    stream of the groups' device, with that device made current for the
    launch (CUDA tensors only).

    groups: (N_i, 3, D_i) float32 contiguous tensors on one CUDA device,
    at most MAX_GROUPS of them.  Returns [(N_i, D_i) uint8] in order."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"viterbi: {len(groups)} groups, the kernel takes "
                         f"1 to {MAX_GROUPS}")
    if int(wrap) < 0:
        raise ValueError(f"viterbi: wrap={wrap} < 0")
    for x in groups:
        if x.dtype != torch.float32:
            raise TypeError(f"viterbi: LLRs must be float32, got {x.dtype}")
        if x.dim() != 3 or x.shape[1] != 3 or x.shape[2] < 1:
            raise ValueError(f"viterbi: LLRs have shape {tuple(x.shape)}, "
                             "expected (N, 3, D) with D >= 1")
        if not x.is_contiguous():
            raise ValueError("viterbi: LLRs must be contiguous")
    dev = groups[0].device
    if dev.type != "cuda" or any(x.device != dev for x in groups):
        raise ValueError(f"viterbi_tb_cuda: LLRs on "
                         f"{sorted({str(x.device) for x in groups})}, not "
                         "one CUDA device")
    ds = [int(x.shape[2]) for x in groups]
    ws = [min(int(wrap), d) for d in ds]
    outs = [torch.empty((x.shape[0], d), dtype=torch.uint8, device=dev)
            for x, d in zip(groups, ds)]
    live = [k for k, x in enumerate(groups) if x.shape[0] > 0]
    if not live:
        return outs
    fn = _library().viterbi_tb_launch
    n = len(live)
    ints = ctypes.c_int * n
    ptrs = ctypes.c_void_p * n
    llr_p = ptrs(*[groups[k].data_ptr() for k in live])
    bit_p = ptrs(*[outs[k].data_ptr() for k in live])
    # the launch goes to the current device's context: make it the
    # tensors' (tensors on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(llr_p, bit_p, ints(*[int(groups[k].shape[0]) for k in live]),
                 ints(*[ds[k] for k in live]), ints(*[ws[k] for k in live]),
                 n, stream)
    if err != 0:
        # cudaErrorInvalidValue (1): the entry refused the shapes, e.g. a
        # D above max_d(wrap), whose slot exceeds a block's shared memory
        raise RuntimeError(f"viterbi kernel launch failed: cudaError {err} "
                           f"(D {ds}, wrap {wrap})")
    LAUNCHES["viterbi"] += 1
    return outs


def _check_cpu(x):
    if x.device.type != "cpu":
        raise ValueError(f"viterbi: unsupported device {x.device}")


def viterbi_decode_tb(llrs, wrap: int = 32):
    """Decode tail-biting rate-1/3 K=7 codewords: the kernel for a CUDA
    tensor, the plain version for a CPU tensor.

    Args:
      llrs: (B, 3, D) float32 stream LLRs (positive => bit 0).
      wrap: circular training length (clamped to D).

    Returns:
      bits: (B, D) uint8 decoded payloads.
    """
    if llrs.device.type == "cuda":
        return viterbi_tb_cuda([llrs], wrap)[0]
    _check_cpu(llrs)
    return viterbi_decode_tb_plain(llrs, wrap)


def viterbi_decode_tb_multi(llrs_list: Sequence, wrap: int = 32) -> List:
    """Decode candidate groups of several payload sizes in one call: one
    kernel launch for CUDA tensors, the plain fused scan for CPU tensors.

    Args:
      llrs_list: sequence of (B_i, 3, D_i) float32 LLR tensors.
      wrap: circular training length (clamped per size).

    Returns:
      list of (B_i, D_i) uint8 decoded payloads, same order.
    """
    if llrs_list[0].device.type == "cuda":
        return viterbi_tb_cuda(llrs_list, wrap)
    for x in llrs_list:
        _check_cpu(x)
    return viterbi_decode_tb_multi_plain(llrs_list, wrap)


def conv_encode_tb(bits):
    """Batched tail-biting conv encoder on tensors (for re-encode checks;
    plain torch, as the JAX package's `conv_encode_tb_jax` is plain XLA).

    bits: (B, D) uint8 -> (B, 3, D) uint8, on bits' device.
    """
    t = conv.trellis_tables()
    dev = bits.device
    out_tab = const(t["out_bits"], dev)                    # (64, 2, 3)
    nxt_tab = const(t["next_state"], dev, torch.int64)     # (64, 2)
    B, D = bits.shape
    b = bits.to(torch.int64)
    # initial state = last 6 bits, u_{D-1} at bit 5
    weights = torch.tensor([1, 2, 4, 8, 16, 32], dtype=torch.int64,
                           device=dev)
    state = torch.sum(b[:, D - 6:] * weights, dim=-1)
    outs = []
    for k in range(D):
        outs.append(out_tab[state, b[:, k]])               # (B, 3)
        state = nxt_tab[state, b[:, k]]
    return torch.stack(outs, dim=-1)                       # (B, 3, D)
