"""One two-codeword (TM3 / TM4) grant's equalize + demap + descramble: the
hand-written CUDA kernel and its plain torch version.

Counterpart of the JAX package's jitted program
`ltesniffer_tpu/sniffer/pdsch_rx.py:130 _eq_demap_mimo_fn` (XLA, no
`pallas_call`): gather the grant's REs, form the 2-layer effective
channel (TM4 codebook, TM3 CDD with the 4-port precoder cycle), the 2x2
MMSE, and per codeword the max-log demap and the Gold descramble.

`eq_demap_mimo` launches the CUDA kernel `csrc/mimo_eq_demap.cu` for
CUDA tensors (built with nvcc at first use into `ltesniffer_tpu_torch/
_build/` by `nvcc_build`; one launch per grant) or raises; for CPU
tensors it runs the plain version, `eq_demap_mimo_plain`, which is the
torch chain `sniffer/pdsch_rx.py` ran before the kernel (162 CUDA
kernels and 5 host-to-device copies a grant on an H100, by
`chip_smoke.py` phase 2c).  Both return ONE buffer: codeword 0's
n_pad * qm0 descrambled LLRs, then codeword 1's n_pad * qm1.
`LAUNCHES["mimo_eq_demap"]` counts kernel launches and
`PLAIN_CUDA["mimo_eq_demap"]` plain chains run on a CUDA tensor (only a
comparison with the kernel does that).

What bounds the kernel on the card: bytes (`bytes_moved`; ~0.03 us at
the MIMO cell's grants, far under a launch's latency).  What the design
does about it: one launch, one thread per RE, no intermediate in device
memory and no host-to-device copy per call (precoders, c_init and shapes
are kernel parameters, the noise is read by pointer, the Gold table
(`gold_words`) is uploaded once per device); see the note at the top of
the source.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import sequences
from . import demapper, mimo, nvcc_build

SRC = os.path.join(nvcc_build.CSRC, "mimo_eq_demap.cu")

LAUNCHES = {"mimo_eq_demap": 0}
PLAIN_CUDA = {"mimo_eq_demap": 0}   # plain chains run on a CUDA tensor

QMS = (2, 4, 6, 8)
MAX_PORTS = 4
MAX_CYCLE = 4
# the demapper's scales, as kernels/demapper.py multiplies and divides by
SCALES = np.array([demapper._S2, demapper._S10, demapper._S42,
                   demapper._S170], np.float32)


def reset_launches():
    for d in (LAUNCHES, PLAIN_CUDA):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# the plain version: the torch chain, op for op as the JAX program
# ---------------------------------------------------------------------------
def eq_demap_mimo_plain(grid_flat, h_flat, noise_var, re_idx, c_init0: int,
                        c_init1: int, tm: int, pmi: int, qm0: int, qm1: int):
    """Plain version of `eq_demap_mimo` (torch ops, any device).

    grid_flat (RX, L, 2), h_flat (RX, P, L, 2) float32; noise_var 0-d;
    re_idx (n_pad,) int64 -> (n_pad * (qm0 + qm1),) float32."""
    if grid_flat.device.type == "cuda":
        PLAIN_CUDA["mimo_eq_demap"] += 1
    y = grid_flat[:, re_idx, :][None]            # (1, RX, n, 2)
    hh = h_flat[:, :, re_idx, :][None]           # (1, RX, P, n, 2)
    nv = noise_var.reshape(1)
    if tm == 4:
        he = mimo.effective_channel_tm4(hh, pmi, 2)
    else:
        he = mimo.effective_channel_tm3(hh)
    x = mimo.mmse_2layer(y, he, nv)[0]           # (2, n, 2)
    outs = []
    for q, (qm, ci) in enumerate(((qm0, c_init0), (qm1, c_init1))):
        llr = demapper.llr(x[q], qm)
        scr = sequences.gold_sequence_torch(
            torch.tensor(ci, dtype=torch.int64, device=llr.device),
            re_idx.shape[0] * qm)
        outs.append(llr * (1.0 - 2.0 * scr.to(torch.float32)))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# the kernel's constants: precoders, demapper scales, Gold table
# ---------------------------------------------------------------------------
def precoders(tm: int, pmi: int, ports: int):
    """(list of (ports, 2) complex precoders cycled per RE pair, CDD tail
    on?) — the matrices `kernels/mimo.py` applies for this grant."""
    if tm == 4:
        w = (mimo.pmi_matrix_2layer_4tx(pmi) if ports == 4
             else mimo.pmi_matrix_2layer(pmi))
        return [w], False
    if ports == 4:
        return [mimo.pmi_matrix_2layer_4tx(12 + k)
                for k in range(MAX_CYCLE)], True
    return [mimo._W_CDD], True


def _mat_floats(w: np.ndarray) -> np.ndarray:
    """(P, 2) complex -> 16 floats: re[4][2] then im[4][2], zero-padded."""
    re = np.zeros((MAX_PORTS, 2), np.float32)
    im = np.zeros((MAX_PORTS, 2), np.float32)
    w = np.asarray(w, np.complex64)
    re[:w.shape[0]] = np.real(w)
    im[:w.shape[0]] = np.imag(w)
    return np.concatenate([re.ravel(), im.ravel()])


@functools.lru_cache(maxsize=None)
def constants(tm: int, pmi: int, ports: int):
    """(the kernel's constant floats, n_cycle, cdd) for one grant kind."""
    ws, cdd = precoders(tm, pmi, ports)
    mats = [ws[k % len(ws)] for k in range(MAX_CYCLE)]
    u = mimo._U_CDD
    mats += [np.diag([1.0, 0.0]).astype(np.complex64) @ u,
             np.diag([0.0, 1.0]).astype(np.complex64) @ u]
    inv = np.float32(1.0) / SCALES
    flat = np.concatenate([_mat_floats(m) for m in mats] + [SCALES, inv])
    return flat.astype(np.float32), len(ws), int(cdd)


def gold_words(length: int) -> np.ndarray:
    """(length,) uint32 table words of the Gold sequence (36.211 7.2):
    bits 0-30 of word n are column n of the x2 basis (c(n)'s dependence
    on the c_init bits), bit 31 is x1(n), so that
    c(n) = popcount((c_init | 1 << 31) & word[n]) & 1."""
    total = sequences.NC + length
    # x1 and x2 as GF(2) masks over (x1 state, c_init bits 0-30): x2(n)
    # for n < 31 is c_init bit n, x1(0) = 1
    x2 = [1 << n for n in range(31)]
    x1 = [1] + [0] * 30
    for n in range(total - 31):
        x2.append(x2[n + 3] ^ x2[n + 2] ^ x2[n + 1] ^ x2[n])
        x1.append(x1[n + 3] ^ x1[n])
    m = np.array(x2[sequences.NC:total], np.uint32)
    b = np.array(x1[sequences.NC:total], np.uint32)
    return m | (b << np.uint32(31))


_GOLD: dict = {}     # device -> int32 tensor of table words (grown)


def gold_table(length: int, device):
    """The Gold table on `device` with at least `length` words: one upload
    per device, grown (doubled) when a longer grant needs more."""
    key = str(device)
    t = _GOLD.get(key)
    if t is None or t.numel() < length:
        n = max(length, 2 * t.numel() if t is not None else 0)
        n = -(-n // 4096) * 4096
        t = _GOLD[key] = torch.from_numpy(
            gold_words(n).view(np.int32)).to(device)
    return t


def bytes_moved(n_re: int, n_pad: int, rx: int, ports: int, qm0: int,
                qm1: int) -> int:
    """Bytes one call must move: the grant's n_re distinct REs of grid and
    port channels (8 bytes a complex value), the (n_pad,) int64 index and
    the noise read once, and the n_pad * (qm0 + qm1) LLRs written once."""
    return (rx * (1 + ports) * 8 * n_re + 8 * n_pad + 4
            + 4 * n_pad * (qm0 + qm1))


def ops(n_pad: int, rx: int, ports: int, tm: int, qm0: int, qm1: int) -> int:
    """Float32 operations of one call, n_pad REs (the kernel's count per
    RE, every multiply and add one operation):
    - a constant-matrix product over P ports: 2 layers x (8P - 2);
    - the TM3 tail: two 2-port products and 2 x 2 multiply-adds;
    - the MMSE: 24 per receive antenna, 8 to sum each further one, 2
      noise adds, 7 for det, its clamp and 1 / det, 25 for the solves;
    - the demap of qm bits: 2 scales, for qm > 2 (qm - 2) abs-subtract
      pairs and qm reciprocal multiplies; qm descramble negations."""
    def prod(p):
        return 2 * (8 * p - 2)
    chan = prod(ports) + (2 * prod(2) + 8 if tm == 3 else 0)
    mmse = 24 * rx + 8 * (rx - 1) + 2 + 7 + 25

    def demap(qm):
        return 2 + (2 * (qm - 2) + qm if qm > 2 else 0) + qm
    return n_pad * (rx * chan + mmse + demap(qm0) + demap(qm1))


# ---------------------------------------------------------------------------
# the kernel: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and its wrapper
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/mimo_eq_demap.cu (at first use) and return its entry."""
    lib = nvcc_build.load("mimo_eq_demap", SRC)
    lib.mimo_eq_demap_const_floats.restype = ctypes.c_int
    n = constants(4, 0, 2)[0].size
    if lib.mimo_eq_demap_const_floats() != n:
        raise RuntimeError(f"mimo_eq_demap: the kernel takes "
                           f"{lib.mimo_eq_demap_const_floats()} constant "
                           f"floats, the wrapper packs {n}")
    lib.mimo_eq_demap_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 2)
    lib.mimo_eq_demap_launch.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("mimo_eq_demap", 0.0)


def _check(grid_flat, h_flat, noise_var, re_idx, tm, pmi, qm0, qm1):
    if tm not in (3, 4):
        raise ValueError(f"mimo_eq_demap: tm={tm}, expected 3 or 4")
    for qm in (qm0, qm1):
        if qm not in QMS:
            raise ValueError(f"mimo_eq_demap: qm={qm}, expected one of {QMS}")
    if grid_flat.dim() != 3 or grid_flat.shape[2] != 2:
        raise ValueError(f"mimo_eq_demap: grid_flat has shape "
                         f"{tuple(grid_flat.shape)}, expected (RX, L, 2)")
    rx, L = int(grid_flat.shape[0]), int(grid_flat.shape[1])
    if rx not in (1, 2):
        raise ValueError(f"mimo_eq_demap: {rx} receive antennas, the kernel "
                         "takes 1 or 2")
    if h_flat.dim() != 4 or h_flat.shape[0] != rx or \
            h_flat.shape[1] not in (2, 4) or h_flat.shape[2] != L or \
            h_flat.shape[3] != 2:
        raise ValueError(f"mimo_eq_demap: h_flat has shape "
                         f"{tuple(h_flat.shape)}, expected ({rx}, 2 or 4, "
                         f"{L}, 2)")
    ports = int(h_flat.shape[1])
    if tm == 4 and not 0 <= pmi < (16 if ports == 4 else 3):
        raise ValueError(f"mimo_eq_demap: pmi={pmi} for {ports} ports")
    for name, x, dt in (("grid_flat", grid_flat, torch.float32),
                        ("h_flat", h_flat, torch.float32),
                        ("noise_var", noise_var, torch.float32),
                        ("re_idx", re_idx, torch.int64)):
        if x.dtype != dt:
            raise TypeError(f"mimo_eq_demap: {name} must be {dt}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"mimo_eq_demap: {name} must be contiguous")
    if noise_var.numel() != 1:
        raise ValueError("mimo_eq_demap: noise_var must hold one value")
    if re_idx.dim() != 1 or re_idx.shape[0] < 1:
        raise ValueError(f"mimo_eq_demap: re_idx has shape "
                         f"{tuple(re_idx.shape)}, expected (n_pad,)")
    return rx, L, ports


def eq_demap_mimo_cuda(grid_flat, h_flat, noise_var, re_idx, c_init0: int,
                       c_init1: int, tm: int, pmi: int, qm0: int, qm1: int):
    """Launch the kernel once on the current stream of the tensors' device,
    with that device made current for the launch (CUDA tensors only)."""
    rx, L, ports = _check(grid_flat, h_flat, noise_var, re_idx, tm, pmi,
                          qm0, qm1)
    dev = grid_flat.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (h_flat, noise_var, re_idx)):
        raise ValueError(f"eq_demap_mimo_cuda: tensors on "
                         f"{sorted({str(x.device) for x in (grid_flat, h_flat, noise_var, re_idx)})}"
                         ", not one CUDA device")
    n_pad = int(re_idx.shape[0])
    consts, n_cycle, cdd = constants(tm, pmi, ports)
    fn = _library().mimo_eq_demap_launch
    # the launch goes to the current device's context: make it the
    # tensors' (tensors on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        gold = gold_table(n_pad * max(qm0, qm1), dev)
        out = torch.empty(n_pad * (qm0 + qm1), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(grid_flat.data_ptr(), h_flat.data_ptr(),
                 noise_var.data_ptr(), re_idx.data_ptr(), gold.data_ptr(),
                 out.data_ptr(), L, rx, ports, n_pad, qm0, qm1, n_cycle, cdd,
                 int(c_init0) & 0xFFFFFFFF, int(c_init1) & 0xFFFFFFFF,
                 consts.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"mimo_eq_demap kernel launch failed: cudaError "
                           f"{err} (RX {rx}, ports {ports}, n_pad {n_pad}, "
                           f"qm {qm0}/{qm1})")
    LAUNCHES["mimo_eq_demap"] += 1
    return out


def eq_demap_mimo(grid_flat, h_flat, noise_var, re_idx, c_init0: int,
                  c_init1: int, tm: int, pmi: int, qm0: int, qm1: int):
    """One two-codeword grant's REs -> both codewords' descrambled LLRs:
    the kernel for CUDA tensors, the plain version for CPU tensors.

    Args:
      grid_flat: (RX, L, 2) float32, the subframe's grid, RX in {1, 2}.
      h_flat: (RX, P, L, 2) float32 port channels, P in {2, 4}.
      noise_var: 0-d float32 tensor.
      re_idx: (n_pad,) int64 RE positions, the padded tail repeating the
        last RE.
      c_init0, c_init1: each codeword's scrambling c_init.
      tm: 3 (open-loop CDD) or 4 (closed loop, codebook index pmi).
      qm0, qm1: each codeword's bits per symbol (2, 4, 6, 8).

    Returns:
      (n_pad * (qm0 + qm1),) float32: codeword 0's LLRs, then codeword 1's.
    """
    if grid_flat.device.type == "cuda":
        return eq_demap_mimo_cuda(grid_flat, h_flat, noise_var, re_idx,
                                  c_init0, c_init1, tm, pmi, qm0, qm1)
    if grid_flat.device.type != "cpu":
        raise ValueError(f"mimo_eq_demap: unsupported device "
                         f"{grid_flat.device}")
    return eq_demap_mimo_plain(grid_flat, h_flat, noise_var, re_idx,
                               c_init0, c_init1, tm, pmi, qm0, qm1)
