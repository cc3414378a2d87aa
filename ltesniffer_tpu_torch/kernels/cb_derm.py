"""The de-rate-match of every turbo code block of a batched downlink PDSCH
dispatch: the hand-written CUDA kernel `cb_derm` and its plain torch
version.

For each code block: select its window of E LLRs in its grant's row of
the eq/demap output, fold the circular buffer's laps, rotate by the rv's
start, apply the inverse sub-block permutation (positions never sent read
0), set the fillers to 1e4 and add the HARQ prior, into one (3, K+4) row
of combined LLRs (36.212 5.1.4.1, de-rate-matched).  The JAX package does
this per (K, F, laps, rv, window start) group in the XLA program
`ltesniffer_tpu/sniffer/pdsch_rx.py:468 _derm_turbo_static_fn` (no
`pallas_call`); the port's plain version is that chain (`window` and
`fold`, shared with `sniffer/pdsch_rx.py:_derm_turbo_static_fn`, which the
uplink keeps).

A `Table` holds one dispatch's code blocks, one descriptor each (row,
window, K, F, laps, the cycle length L, the rv's start rank s0, the
address of its (K, F) map, its HARQ prior, its output offset); `upload`
copies it in one pinned, non_blocking copy (`cplx.upload_pinned`) and
`derm` launches `csrc/cb_derm.cu` once per dependency round (a
retransmission that combines with an earlier code block of the same
dispatch reads that block's output, so it waits for the next round).  A
prior is read by address: a row of an earlier dispatch's output, or of
this one's; a prior held in a host array rides in the same upload.  For
CPU tensors `derm` runs `derm_plain`, the chain per group, from the same
descriptors.

`LAUNCHES["cb_derm"]` counts kernel launches and `PLAIN_CUDA["cb_derm"]`
plain versions run on a CUDA tensor (a comparison with the kernel); every
launch (and every round of the plain version) counts one event of the
tracer's `pdsch_derm_cb`, its code blocks as the total.

What bounds the kernel on the card: bytes (`bytes_moved`: ~27 MB a batch
of the E-TM 3.1 cell, ~8 us), under a launch's latency; the source's note
says what its design does about it.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import turbo as turbo_mod
from ltesniffer_tpu_torch.sniffer import prof
from . import nvcc_build
from .cplx import const, upload_pinned

SRC = os.path.join(nvcc_build.CSRC, "cb_derm.cu")

THREADS = 256            # the .cu's kThreads
DESC_WORDS = 16          # the .cu's kDescWords, these words a code block:
(ROW, OFF, E, K, F, LAPS, L, S0, OUT, PUP, MAP_LO, MAP_HI, PRIOR_LO,
 PRIOR_HI, RV, ROUND) = range(DESC_WORDS)
FILLER = 1e4             # the fillers' LLR: known zeros

LAUNCHES = {"cb_derm": 0}
PLAIN_CUDA = {"cb_derm": 0}      # plain versions run on a CUDA tensor


def reset_launches():
    for d in (LAUNCHES, PLAIN_CUDA):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# the circular buffer's structure per (K, F)
# ---------------------------------------------------------------------------
@prof.factory(512)
def static_maps(K: int, F: int):
    """Static circular-buffer structure for one (K, F):

    nonnull_pos: (L,) w-positions that carry transmitted bits (NULL pads
    and filler positions excluded), in cyclic order;
    INVP: (3*(K+4),) int64 mapping each d-stream position to its rank in
    nonnull_pos (or L for never-transmitted positions — filler/pad);
    L: the selection cycle length (the circular buffer revisits the same
    positions every L LLRs)."""
    m = turbo_mod.turbo_rm_maps(K)
    Kp = K + 4
    flat_null = np.zeros(3 * Kp, bool)
    flat_null[:F] = True
    flat_null[Kp:Kp + F] = True
    w_valid = m["w_src"] >= 0
    w_null = ~w_valid | (w_valid
                         & flat_null[np.where(w_valid, m["w_src"], 0)])
    nonnull_pos = np.nonzero(~w_null)[0]
    L_ = len(nonnull_pos)
    INVP = np.full(3 * Kp, L_, np.int64)
    INVP[m["w_src"][nonnull_pos]] = np.arange(L_, dtype=np.int64)
    return nonnull_pos, INVP, L_


@prof.factory(512)
def map32(K: int, F: int) -> np.ndarray:
    """`static_maps`' INVP as int32, the kernel's map of one (K, F):
    uploaded once per (K, F) and device through `const`."""
    return static_maps(K, F)[1].astype(np.int32)


def start_rank(K: int, F: int, rv: int) -> int:
    """s0: the rank among the transmitted positions where rv's selection
    starts."""
    nonnull_pos, _, L_ = static_maps(K, F)
    return int(np.searchsorted(nonnull_pos, turbo_mod.rv_start(K, rv))) % L_


@prof.factory(2048)
def cycle(K: int, F: int, rv: int) -> tuple:
    """(L, s0) of one (K, F, rv): a descriptor's cycle length and start
    rank, cached (a cell re-issues the same sizes)."""
    return static_maps(K, F)[2], start_rank(K, F, rv)


def laps(K: int, F: int, E_: int) -> int:
    """Number of circular-buffer laps the selection of E bits spans."""
    return max(1, -(-E_ // static_maps(K, F)[2]))


# ---------------------------------------------------------------------------
# the plain version: the torch chain, per group of one (K, F, laps, s0,
# window start)
# ---------------------------------------------------------------------------
def window(rows_mat, rows, e_true, off: int, EB: int):
    """(n, EB) LLRs of rows `rows` from column `off` on, zero from each
    row's e_true on (and past the row's end)."""
    dev = rows_mat.device
    win = rows_mat[rows]
    ok = torch.arange(EB, device=dev)[None, :] < e_true[:, None]
    winp = torch.nn.functional.pad(win, (0, EB))
    off = max(0, min(int(off), winp.shape[1] - EB))      # clamped slice
    x = winp[:, off:off + EB]
    return torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=dev))


def fold(x, K: int, F: int, laps_: int, s0: int, prior=None):
    """(n, laps * L) windowed LLRs -> (n, 3, K+4) combined LLRs: fold the
    laps, rotate by s0, inverse sub-block permutation (rank L reads 0.0),
    fillers, + prior."""
    _, INVP, L_ = static_maps(K, F)
    n = x.shape[0]
    f = x.reshape(n, laps_, L_).sum(dim=1) if laps_ > 1 else x
    acc = torch.roll(f, s0, dims=1)
    accp = torch.nn.functional.pad(acc, (0, 1))          # rank L -> 0.0
    d = accp[:, const(INVP, x.device)].reshape(n, 3, K + 4)
    if F:
        d[:, :2, :F] = FILLER    # fillers: known zeros
    if prior is not None:
        d = d + prior
    return d


def derm_plain(rows_mat, desc, table: "Table", out):
    """Plain version of the kernel (torch ops, any device): the same
    combined LLRs into `out` from the same descriptors (the uploaded
    int32 buffer `desc`), round by round, each round's code blocks in
    groups of one (K, F, laps, s0, window start, prior or none)."""
    dev = rows_mat.device
    if dev.type == "cuda":
        PLAIN_CUDA["cb_derm"] += 1
    words = desc.cpu().numpy()
    d = words[:DESC_WORDS * table.n_cb].reshape(-1, DESC_WORDS).astype(
        np.int64)
    up = words.view(np.float32)
    base = out.data_ptr()
    t = functools.partial(torch.tensor, dtype=torch.int64, device=dev)
    for first, n, _chunks in table.rounds():
        groups: Dict[tuple, list] = {}
        for r in range(first, first + n):
            w = d[r]
            addr = int(w[PRIOR_HI]) << 32 | int(w[PRIOR_LO]) & 0xFFFFFFFF
            kind = w[PUP] >= 0 or addr != 0
            groups.setdefault((int(w[K]), int(w[F]), int(w[LAPS]),
                               int(w[S0]), int(w[OFF]), kind), []).append(
                (r, addr))
        for (K_, F_, laps_, s0, off, kind), items in groups.items():
            Kp = K_ + 4
            ws = d[[r for r, _ in items]]
            prior = None
            if kind:
                parts = []
                for (r, addr), w in zip(items, ws):
                    if w[PUP] >= 0:
                        parts.append(torch.from_numpy(
                            up[w[PUP]:w[PUP] + 3 * Kp].copy()).to(dev))
                    elif base <= addr < base + 4 * out.numel():
                        o = (addr - base) // 4
                        parts.append(out[o:o + 3 * Kp])
                    else:
                        parts.append(table.tensors[addr].reshape(-1))
                prior = torch.stack(parts).reshape(-1, 3, Kp)
            x = window(rows_mat, t(ws[:, ROW]), t(ws[:, E]), off,
                       laps_ * static_maps(K_, F_)[2])
            dd = fold(x, K_, F_, laps_, s0, prior)
            idx = t(ws[:, OUT])[:, None] + torch.arange(3 * Kp, device=dev)
            out[idx] = dd.reshape(len(items), -1)
        prof.count("pdsch_derm_cb", n)
    return out


# ---------------------------------------------------------------------------
# one dispatch's descriptors
# ---------------------------------------------------------------------------
class Table:
    """One dispatch's code blocks.  `add` one (its output offset and its
    prior given by the caller), then `array` makes the int32 words the
    kernel reads: the code blocks round by round (a round's in ascending
    K and output offset), DESC_WORDS words each, then the floats of the
    priors held in host arrays.  A prior is None, ("out", float offset)
    (an earlier round's code block of this dispatch), a tensor on the
    dispatch's device (read by address) or a host array (uploaded)."""

    def __init__(self):
        self.cb: List[list] = []        # [ROW .. ROUND] minus the addresses
        self.priors: Dict[int, object] = {}          # code block -> prior
        self.tensors: Dict[int, torch.Tensor] = {}   # address -> prior
        self._order: Optional[np.ndarray] = None
        self._c: Optional[np.ndarray] = None

    def add(self, row: int, off: int, E_: int, K_: int, F_: int, rv: int,
            out: int, rnd: int, prior=None) -> int:
        L_, s0 = cycle(K_, F_, rv)
        self.cb.append([row, off, E_, K_, F_, max(1, -(-E_ // L_)), L_, s0,
                        out, rv, rnd])
        if prior is not None:
            self.priors[len(self.cb) - 1] = prior
        self._order = self._c = None
        return len(self.cb) - 1

    @property
    def n_cb(self) -> int:
        return len(self.cb)

    def _cols(self) -> np.ndarray:
        """The code blocks' columns [ROW .. ROUND] minus the addresses, as
        added."""
        if self._c is None:
            self._c = np.array(self.cb, np.int64).reshape(-1, 11)
        return self._c

    def order(self) -> np.ndarray:
        """The code blocks in launch order: by round, K, output offset."""
        if self._order is None:
            c = self._cols()
            self._order = np.lexsort((c[:, 8], c[:, 3], c[:, 10]))
        return self._order

    def rounds(self) -> List[tuple]:
        """[(first, n, chunks)]: each round's code blocks in launch order
        and the kernel's blocks of THREADS positions a code block."""
        c = self._cols()[self.order()]
        out = []
        for rnd in np.unique(c[:, 10]):
            at = np.flatnonzero(c[:, 10] == rnd)
            out.append((int(at[0]), len(at),
                        int(-(-3 * (c[at, 3].max() + 4) // THREADS))))
        return out

    def array(self, device, out, keep: list) -> np.ndarray:
        """The int32 words of the table for a launch writing into `out` on
        `device`: map and prior addresses resolved (the maps through
        `const`), host priors after the descriptors.  The tensors whose
        addresses the words hold are appended to `keep`: hold them until
        the launch has run."""
        order = self.order()
        n = len(order)
        d = np.zeros((n, DESC_WORDS), np.int64)
        d[:, [ROW, OFF, E, K, F, LAPS, L, S0, OUT, RV, ROUND]] = \
            self._cols()[order]
        d[:, PUP] = -1
        kf = d[:, K] << 16 | d[:, F]
        for u in np.unique(kf):
            m = const(map32(int(u >> 16), int(u & 0xFFFF)), device)
            keep.append(m)
            d[kf == u, MAP_LO] = m.data_ptr()
        host: List[np.ndarray] = []
        n_host = DESC_WORDS * n
        addr = np.zeros(n, np.int64)
        base = out.data_ptr()
        row_of = np.empty(n, np.int64)
        row_of[order] = np.arange(n)
        for i, p in sorted(self.priors.items()):
            r = row_of[i]
            if isinstance(p, tuple):
                addr[r] = base + 4 * p[1]
            elif isinstance(p, torch.Tensor):
                t = p.to(device=device, dtype=torch.float32).contiguous()
                keep.append(t)
                addr[r] = t.data_ptr()
                self.tensors[addr[r]] = t
            else:
                a_ = np.ascontiguousarray(p, np.float32).reshape(-1)
                d[r, PUP] = n_host
                n_host += a_.size
                host.append(a_)
        d[:, PRIOR_LO], d[:, PRIOR_HI] = addr & 0xFFFFFFFF, addr >> 32
        d[:, MAP_HI] = d[:, MAP_LO] >> 32
        d[:, MAP_LO] &= 0xFFFFFFFF
        words = d.astype(np.uint32).view(np.int32).reshape(-1)
        if host:
            words = np.concatenate(
                [words] + [h.view(np.int32) for h in host])
        return words


def bytes_moved(table: Table) -> int:
    """Bytes one dispatch must move at the least: each code block's
    output row written once and its E LLRs read once, each distinct
    (K, F) map once, the descriptors."""
    cb = table._cols()
    maps = {(int(k), int(f)) for k, f in cb[:, [3, 4]]}
    return int(4 * (3 * (cb[:, 3] + 4)).sum() + 4 * cb[:, 2].sum()
               + sum(12 * (k + 4) for k, _ in maps)
               + 4 * DESC_WORDS * len(cb))


# ---------------------------------------------------------------------------
# the kernel: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and its wrapper
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/cb_derm.cu (at first use) and return its entries."""
    lib = nvcc_build.load("cb_derm", SRC)
    for name in ("cb_derm_threads", "cb_derm_desc_words"):
        getattr(lib, name).restype = ctypes.c_int
    got = (lib.cb_derm_threads(), lib.cb_derm_desc_words())
    if got != (THREADS, DESC_WORDS):
        raise RuntimeError(f"cb_derm: the kernel's (threads, descriptor "
                           f"words) are {got}, the wrapper's "
                           f"{(THREADS, DESC_WORDS)}")
    lib.cb_derm_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.cb_derm_launch.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("cb_derm", 0.0)


def _check(rows_mat, table: Table, out):
    if rows_mat.dtype != torch.float32 or rows_mat.dim() != 2 or \
            not rows_mat.is_contiguous():
        raise ValueError(f"cb_derm: rows must be a contiguous 2-d float32 "
                         f"tensor, not {rows_mat.dtype} "
                         f"{tuple(rows_mat.shape)}")
    if out.dtype != torch.float32 or out.dim() != 1 or \
            out.device != rows_mat.device:
        raise ValueError("cb_derm: out must be a 1-d float32 tensor on the "
                         "rows' device")
    if table.n_cb < 1:
        raise ValueError("cb_derm: no code block")
    cb = table._cols()
    if cb[:, 0].min() < 0 or cb[:, 0].max() >= rows_mat.shape[0] or \
            cb[:, 1].min() < 0 or cb[:, 2].min() < 1 or \
            cb[:, 8].min() < 0 or \
            (cb[:, 8] + 3 * (cb[:, 3] + 4)).max() > out.numel() or \
            out.numel() >= 2 ** 31:
        raise ValueError("cb_derm: a code block's row, window or output "
                         "is not inside the tensors")


def derm_cuda(rows_mat, desc, table: Table, out):
    """Launch the kernel once per round on the current stream of the
    tensors' device, with that device made current (CUDA tensors only).
    `desc`: the uploaded words of `table.array`."""
    _check(rows_mat, table, out)
    dev = rows_mat.device
    if dev.type != "cuda" or desc.device != dev:
        raise ValueError(f"cb_derm: tensors on {dev} and {desc.device}, not "
                         "one CUDA device")
    if desc.dtype != torch.int32 or desc.numel() < DESC_WORDS * table.n_cb:
        raise ValueError("cb_derm: the descriptors are not the table's")
    fn = _library().cb_derm_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first, n, chunks in table.rounds():
            err = fn(rows_mat.data_ptr(), int(rows_mat.shape[1]),
                     desc.data_ptr(), first, n, chunks, out.data_ptr(),
                     stream)
            if err != 0:
                raise RuntimeError(f"cb_derm kernel launch failed: cudaError "
                                   f"{err} ({n} code blocks)")
            LAUNCHES["cb_derm"] += 1
            prof.count("pdsch_derm_cb", n)
    return out


def upload(table: Table, device, out, keep: list):
    """(host buffer, device int32 tensor) of the table's words for a
    launch writing into `out`, by `cplx.upload_pinned`: keep the host
    buffer, and the tensors appended to `keep`, until the output has been
    used."""
    return upload_pinned(table.array(device, out, keep), device)


def derm(rows_mat, table: Table, desc, out):
    """Every code block of `table` de-rate-matched into `out` (a flat
    float32 tensor) from its uploaded words `desc`: the kernel for CUDA
    tensors (one launch a round), the plain version for CPU tensors."""
    dev = rows_mat.device
    if dev.type == "cuda":
        return derm_cuda(rows_mat, desc, table, out)
    if dev.type != "cpu":
        raise ValueError(f"cb_derm: unsupported device {dev}")
    _check(rows_mat, table, out)
    return derm_plain(rows_mat, desc, table, out)
