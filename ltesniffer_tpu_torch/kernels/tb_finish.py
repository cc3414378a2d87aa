"""The finish of the batched downlink PDSCH decode's transport blocks: the
hand-written CUDA kernel `tb_finish` and its plain torch version.

After a dispatch's turbo launches, each code block is one int64 row of
`fused` ([CB CRC24B remainder popcount | u32 words of its bits],
`pdsch_rx._crc_pack`'s layout).  `finish` turns those rows, in one launch
for the whole dispatch, into one uint8 buffer: each transport block's
payload bytes (MSB first, `np.packbits` of its bits) at its offset, and a
u32 status word per block (bit 0: the TB CRC24A and every CB CRC24B
hold; bits 1..C: each code block's CB CRC24B holds; a block of one code
block carries no CB CRC, so its bit 1 is set).  The host reads that
buffer once, in place of every row's bits.

No TPU kernel corresponds to it: the JAX package unpacks the bits and
checks the TB CRC on the host.  The kernel takes that per-bit work off the
port's host.  Source `csrc/tb_finish.cu` (built with nvcc at first use by
`nvcc_build`); its notes say how it works and what bounds it (a launch:
`bytes_moved` is ~0.56 MB a batch of the E-TM 3.1 cell).

`Table` is one launch's descriptor table, filled while the caller walks
its code blocks; `upload` copies it to the card through a pinned host
buffer without a synchronizing copy.  For CUDA tensors `finish` launches
the kernel (or raises); for CPU tensors it runs `finish_plain`, which
gives the same bytes and words by other means (every bit unpacked, the
CRC as `phy/crc.py`'s matmul).  `LAUNCHES["tb_finish"]` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import List

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import crc
from . import nvcc_build
from .cplx import const, upload_pinned

SRC = os.path.join(nvcc_build.CSRC, "tb_finish.cu")

THREADS = 256            # the .cu's kThreads: a block per transport block
MAX_C = 31               # code blocks a transport block (kMaxC)
POW_TERMS = 24           # powers x^(8 2^j) mod g in the table (kPowTerms)
TB_WORDS, CB_WORDS = 5, 2

LAUNCHES = {"tb_finish": 0}

_MSB = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64)


def reset_launches():
    LAUNCHES["tb_finish"] = 0


class Table:
    """One launch's descriptors: per transport block [tbs, C, F, payload
    byte offset, first code block], per code block [row's word offset in
    `fused`, K].  `add` a block, then `set_row` each of its code blocks as
    the rows are laid out.  Payloads lie back to back from byte 0; the
    status words follow at `stat_off`."""

    def __init__(self):
        self.tb: List[list] = []
        self.cb: List[list] = []
        self.n_pay = 0

    def add(self, tbs: int, seg) -> int:
        """Index of a new transport block of `tbs` bits, segmented as
        `seg` (`phy.turbo.segment_sizes`)."""
        if tbs <= 0 or tbs % 8 or seg.F % 8 or any(K % 8 for K in seg.K) \
                or not 1 <= seg.C <= MAX_C:
            raise ValueError(f"tb_finish: tbs {tbs} segmented as {seg} is "
                             "not byte-aligned or has too many code blocks")
        t = len(self.tb)
        self.tb.append([tbs, seg.C, seg.F, self.n_pay, len(self.cb)])
        self.cb.extend([-1, K] for K in seg.K)
        self.n_pay += tbs // 8
        return t

    def set_row(self, t: int, r: int, word_off: int):
        self.cb[self.tb[t][4] + r][0] = word_off

    @property
    def n_tb(self) -> int:
        return len(self.tb)

    @property
    def stat_off(self) -> int:
        return -(-self.n_pay // 4) * 4

    @property
    def n_out(self) -> int:
        return self.stat_off + 4 * self.n_tb

    def offset(self, t: int) -> int:
        return self.tb[t][3]

    def array(self) -> np.ndarray:
        """The descriptors as the kernel reads them, int32."""
        return np.array([v for row in self.tb for v in row]
                        + [v for row in self.cb for v in row], np.int32)

    def status(self, out: np.ndarray) -> np.ndarray:
        """The status words of a host copy of the output buffer."""
        return out[self.stat_off:self.n_out].view("<u4")


def upload(table: Table, device):
    """(host buffer, device int32 tensor) of the table's descriptors, by
    `cplx.upload_pinned`: keep the host buffer until the launch's output
    has been read."""
    return upload_pinned(table.array(), device)


@functools.lru_cache(maxsize=1)
def crc_table() -> np.ndarray:
    """The kernel's CRC24A table, int32 bit patterns of u32 words: b x^24
    mod g(x) for each byte b, then x^(8 2^j) mod g(x) for j < POW_TERMS."""
    poly, n = crc.CRC24A
    mask = (1 << n) - 1

    def times_x(r, k):
        for _ in range(k):
            r = ((r << 1) ^ poly) & mask if r >> (n - 1) else (r << 1) & mask
        return r

    def mulmod(a, b):
        r = 0
        for i in range(n - 1, -1, -1):
            r = times_x(r, 1) ^ (a if (b >> i) & 1 else 0)
        return r

    words = [times_x(b, n) for b in range(256)]
    p = times_x(1, 8)
    for _ in range(POW_TERMS):
        words.append(p)
        p = mulmod(p, p)
    return np.array(words, np.uint32).view(np.int32)


def bytes_moved(table: Table) -> int:
    """Bytes a launch reads and writes at the least: every code block's
    row (8 bytes a word), the descriptors, the output buffer."""
    rows = sum(8 * (1 + (K + 31) // 32) for _, K in table.cb)
    return rows + 4 * (TB_WORDS * table.n_tb + CB_WORDS * len(table.cb)) \
        + table.n_out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
def finish_plain(fused, desc, n_tb: int, stat_off: int, n_out: int):
    """Plain version of the kernel (torch ops, any device): the same
    (n_out,) uint8 buffer from the same inputs.  Blocks of one (tbs, F,
    K list) are taken together: their rows' bits unpacked, the stream cut
    from them, its CRC24A by `crc.batched_crc`, its first tbs bits packed
    MSB first."""
    dev = fused.device
    vals = desc.tolist()
    tb = [vals[TB_WORDS * t:TB_WORDS * (t + 1)] for t in range(n_tb)]
    cb = vals[TB_WORDS * n_tb:]
    out = torch.zeros(n_out, dtype=torch.uint8, device=dev)
    status = torch.zeros(n_tb, dtype=torch.int64, device=dev)
    fams = {}
    for t, (tbs, C, F, _off, c0) in enumerate(tb):
        if tbs > 0 and 1 <= C <= MAX_C:
            ks = tuple(cb[CB_WORDS * (c0 + r) + 1] for r in range(C))
            fams.setdefault((tbs, F, ks), []).append(t)
    shifts = torch.arange(32, device=dev)
    for (tbs, F, ks), ts in fams.items():
        C, n = len(ks), len(ts)
        rows = torch.tensor([[cb[CB_WORDS * (tb[t][4] + r)] for r in range(C)]
                             for t in ts], dtype=torch.int64, device=dev)
        parts, st = [], torch.zeros(n, dtype=torch.int64, device=dev)
        for r, K in enumerate(ks):
            wk = (K + 31) // 32
            w = fused[rows[:, r:r + 1] + 1 + torch.arange(wk, device=dev)]
            bits = ((w[:, :, None] >> shifts) & 1).reshape(n, -1)[:, :K]
            parts.append(bits[:, (F if r == 0 else 0):(K - 24 if C > 1
                                                        else K)])
            ok = fused[rows[:, r]] == 0 if C > 1 else torch.ones(
                n, dtype=torch.bool, device=dev)
            st |= ok.to(torch.int64) << (r + 1)
        stream = torch.cat(parts, dim=1)
        if stream.shape[1] != tbs + 24:
            continue                      # descriptors that do not add up
        tb_ok = (crc.batched_crc(stream, crc.CRC24A).sum(dim=1) == 0) \
            & (st == ((1 << (C + 1)) - 2))
        status[ts] = st | tb_ok.to(torch.int64)
        pay = (stream[:, :tbs].reshape(n, -1, 8) * _MSB.to(dev)).sum(dim=2)
        at = torch.tensor([tb[t][3] for t in ts], device=dev)[:, None] \
            + torch.arange(tbs // 8, device=dev)
        out[at] = pay.to(torch.uint8)
    le = (status[:, None] >> torch.tensor([0, 8, 16, 24], device=dev)) & 0xFF
    out[stat_off:stat_off + 4 * n_tb] = le.reshape(-1).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# the kernel: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and its wrapper
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/tb_finish.cu (at first use) and return its entries."""
    lib = nvcc_build.load("tb_finish", SRC)
    for name in ("tb_finish_threads", "tb_finish_max_c",
                 "tb_finish_pow_terms"):
        getattr(lib, name).restype = ctypes.c_int
    got = (lib.tb_finish_threads(), lib.tb_finish_max_c(),
           lib.tb_finish_pow_terms())
    if got != (THREADS, MAX_C, POW_TERMS):
        raise RuntimeError(f"tb_finish: the kernel's (threads, max C, "
                           f"powers) are {got}, the wrapper's "
                           f"{(THREADS, MAX_C, POW_TERMS)}")
    lib.tb_finish_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
    lib.tb_finish_launch.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("tb_finish", 0.0)


def _check(fused, table: Table, desc):
    if fused.dtype != torch.int64 or fused.dim() != 1:
        raise ValueError(f"tb_finish: fused must be 1-d int64, not "
                         f"{fused.dtype} {tuple(fused.shape)}")
    if desc.dtype != torch.int32 or desc.numel() != \
            TB_WORDS * table.n_tb + CB_WORDS * len(table.cb):
        raise ValueError("tb_finish: the descriptors are not the table's")
    if table.n_tb < 1:
        raise ValueError("tb_finish: no transport block")
    n = fused.numel()
    for row, K in table.cb:
        if row < 0 or row + 1 + (K + 31) // 32 > n:
            raise ValueError(f"tb_finish: a code block's row at {row} (K "
                             f"{K}) is not inside fused ({n} words)")


def finish_cuda(fused, table: Table, desc):
    """Launch `tb_finish` once on the current stream of fused's device,
    with that device made current (CUDA tensors only).  Returns the
    (n_out,) uint8 output buffer."""
    _check(fused, table, desc)
    dev = fused.device
    if dev.type != "cuda" or desc.device != dev:
        raise ValueError(f"tb_finish: inputs on {fused.device} and "
                         f"{desc.device}, not one CUDA device")
    fn = _library().tb_finish_launch
    with torch.cuda.device(dev):
        tab = const(crc_table(), dev)
        out = torch.empty(table.n_out, dtype=torch.uint8, device=dev)
        err = fn(fused.data_ptr(), desc.data_ptr(), table.n_tb,
                 tab.data_ptr(), out.data_ptr(), table.stat_off,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tb_finish kernel launch failed: cudaError "
                           f"{err} ({table.n_tb} blocks)")
    LAUNCHES["tb_finish"] += 1
    return out


def finish(fused, table: Table, desc):
    """The output buffer of `table`'s transport blocks from the fused rows:
    the kernel for CUDA tensors, `finish_plain` for CPU tensors."""
    if fused.device.type == "cuda":
        return finish_cuda(fused, table, desc)
    _check(fused, table, desc)
    return finish_plain(fused, desc, table.n_tb, table.stat_off,
                        table.n_out)
