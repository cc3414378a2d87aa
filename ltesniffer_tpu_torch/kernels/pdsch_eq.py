"""Every single-layer PDSCH grant of a batched dispatch: equalize, demap
and descramble, as the hand-written CUDA kernel `pdsch_eq_demap` and its
plain torch version.

Counterpart of the JAX package's jitted programs
`ltesniffer_tpu/sniffer/pdsch_rx.py:294 _eq_demap_batch_fn`, `:336
_reorg_fn` and `:357 _eq_demap_prb_fn` (XLA, no `pallas_call`): gather
each grant's REs, combine them (port 0 MMSE, SFBC or SFBC-FSTD), the
max-log demap and the Gold descramble, into one (G, wm) rows matrix whose
row g holds grant g's n_pad * qm LLRs and zeros after them.

A `Table` holds one call's grants, each a descriptor: its subframe b, qm,
c_init, p_a, RE count and padded count, and where its REs come from: a
PRB list (grants whose RE pattern is the same in every subframe: the
kernel maps an RE ordinal to (symbol, PRB slot, subcarrier) from the
cell's data subcarriers of a PRB per symbol, `cell_constants`) or a row of
an RE index table (the centre PRBs of subframes 0 and 5, two slot masks).
`upload` copies the descriptors to the card in one pinned, non_blocking
copy, which does not synchronize.

`eq_demap` launches the kernel `csrc/pdsch_eq_demap.cu` for CUDA tensors
(built with nvcc at first use by `nvcc_build`; one launch a call, whatever
the grants' qm, size and RE source) or raises; for CPU tensors it runs
the plain version, `eq_demap_plain`: the torch chains the port ran before
the kernel, one per group of grants of one (qm, PRB count, CFI) over a
PRB-major copy of the grids (`_reorg`, `_eq_demap_prb_fn`) or one (qm,
padded RE count) over the RE index table (`_eq_demap_batch_fn`), ~73 CUDA
kernels a group on an H100.  `LAUNCHES["pdsch_eq_demap"]` counts kernel
launches and `PLAIN_CUDA["pdsch_eq_demap"]` plain versions run on a CUDA
tensor (only a comparison with the kernel does that); every call counts
one event of the tracer's `pdsch_eq_grants`, its grants as the total.

What bounds the kernel on the card: bytes (`bytes_moved`: ~10 MB a batch
of the loaded cell, ~3 us), under a launch's latency and the host's
enqueue.  What the design does about it: see the note at the top of the
source.
"""
from __future__ import annotations

import array
import ctypes
import functools
import os
import struct
from typing import Optional

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod, sequences
from ltesniffer_tpu_torch.sniffer import prof
from . import chest, demapper, mimo_eq, nvcc_build
from .cplx import const, upload_pinned

SRC = os.path.join(nvcc_build.CSRC, "pdsch_eq_demap.cu")

THREADS = 128            # the .cu's kThreads
DESC_WORDS = 8           # the .cu's kDescWords, these words of a grant:
B, QM, CINIT, PA, NRE, NPAD, SRC_W, SHAPE = range(DESC_WORDS)
RE_BUCKET = 256          # grants' RE counts round up to this
QMS = (2, 4, 6, 8)
PORTS = (1, 2, 4)
N_SYM = 14

LAUNCHES = {"pdsch_eq_demap": 0}
PLAIN_CUDA = {"pdsch_eq_demap": 0}   # plain versions run on a CUDA tensor

# scale[4], inv[4] of the demapper (kernels/mimo_eq.py's), SFBC's sqrt(2)
FLOATS = np.concatenate([mimo_eq.SCALES, np.float32(1.0) / mimo_eq.SCALES,
                         [np.float32(np.sqrt(2.0))]]).astype(np.float32)


def reset_launches():
    for d in (LAUNCHES, PLAIN_CUDA):
        for k in d:
            d[k] = 0


def bucket(n: int) -> int:
    """n REs rounded up to a multiple of RE_BUCKET."""
    return -(-n // RE_BUCKET) * RE_BUCKET


def res_per_thread(ports: int) -> int:
    """REs one kernel thread combines: 1 (port 0), the SFBC pair, the
    SFBC-FSTD quad."""
    return 1 if ports == 1 else ports


@functools.lru_cache(maxsize=16)
def _float_bits(x: float) -> int:
    """The float32 bit pattern of x as a signed int32."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


@functools.lru_cache(maxsize=16)
def cell_constants(cell) -> np.ndarray:
    """The kernel's (14 + 14 * 12,) int32 cell block: each symbol's count
    of PDSCH subcarriers in a PRB outside the centre puncture (CRS taken
    out, control symbols included), then those subcarriers ascending, 12
    slots a symbol.  The CRS pattern has period 6, so PRB 0 speaks for
    every PRB of a symbol."""
    res = pdsch_mod.reserved_re_mask(cell, 1, 0)
    out = np.zeros(N_SYM + N_SYM * 12, np.int32)
    for l in range(N_SYM):
        ks = np.flatnonzero(~res[l, :12])
        out[l] = len(ks)
        out[N_SYM + 12 * l:N_SYM + 12 * l + len(ks)] = ks
    return out


class Table:
    """One call's grant descriptors, in row order: `add_prbs` / `add_row`
    a grant, its row index is returned.  The int32 buffer (`array`) is
    the G descriptors of DESC_WORDS words, first[G + 1] (each grant's
    first kernel block) and the PRB lists.  A descriptor's shape word is
    cfi << 8 | n_prb for a PRB-list grant (src: its list's offset in the
    PRB lists) and -1 for a table grant (src: its row of the RE table)."""

    def __init__(self, ports: int):
        if ports not in PORTS:
            raise ValueError(f"pdsch_eq: {ports} ports, expected one of "
                             f"{PORTS}")
        self.ports = ports
        self._per_thread = res_per_thread(ports)
        self.desc = array.array("i")       # int32 words, as uploaded
        self.first = array.array("i", [0])
        self.prbs = array.array("i")
        self.wm = 0
        self.n_pad_tab = 0          # the table grants' largest n_pad

    def _add(self, b, qm, c_init, pa, n_re, n_pad, src, shape) -> int:
        if qm not in QMS or not 0 < n_re <= n_pad or n_pad % 4:
            raise ValueError(f"pdsch_eq: a grant of qm {qm}, {n_re} REs "
                             f"padded to {n_pad}")
        g = len(self.first) - 1
        ci = int(c_init) & 0xFFFFFFFF
        self.desc.extend((int(b), qm, ci - (ci >> 31 << 32),
                          _float_bits(pa), n_re, n_pad, src, shape))
        units = n_pad // self._per_thread
        self.first.append(self.first[-1] - (-units // THREADS))
        if n_pad * qm > self.wm:
            self.wm = n_pad * qm
        return g

    def add_prbs(self, b, qm, c_init, pa, n_re, n_pad, cfi, prbs) -> int:
        """A grant on PRBs `prbs` (ascending ints) in every symbol from cfi
        on, outside the centre puncture."""
        src = len(self.prbs)
        self.prbs.extend(prbs)
        return self._add(b, qm, c_init, pa, n_re, n_pad, src,
                         cfi << 8 | len(prbs))

    def add_row(self, b, qm, c_init, pa, n_re, n_pad, u) -> int:
        """A grant whose REs are row u of the RE table."""
        self.n_pad_tab = max(self.n_pad_tab, n_pad)
        return self._add(b, qm, c_init, pa, n_re, n_pad, int(u), -1)

    @property
    def n_grants(self) -> int:
        return len(self.first) - 1

    @property
    def n_blocks(self) -> int:
        return self.first[-1]

    def array(self) -> np.ndarray:
        return np.frombuffer(self.desc + self.first + self.prbs, np.int32)


def upload(table: Table, device, arr: Optional[np.ndarray] = None):
    """(host buffer, device int32 tensor) of the table (`arr`: its
    `array()`, if made already), by `cplx.upload_pinned`: keep the host
    buffer until the output has been read."""
    return upload_pinned(table.array() if arr is None else arr, device)


def bytes_moved(table: Table, rx: int) -> int:
    """Bytes one call must move: each grant's n_re distinct REs of grid
    and port channels (8 bytes a complex value), its RE source (8 bytes a
    table index, 4 a PRB), its noise, its descriptor, and its row of wm
    floats written once (LLRs and zeros)."""
    d = np.asarray(table.desc, np.int64).reshape(-1, DESC_WORDS)
    src = np.where(d[:, SHAPE] < 0, 8 * d[:, NPAD], 4 * (d[:, SHAPE] & 0xFF))
    return int(rx * (1 + table.ports) * 8 * d[:, NRE].sum() + src.sum()
               + table.n_grants * (4 + 4 * DESC_WORDS + 4 + 4 * table.wm))


# ---------------------------------------------------------------------------
# the plain version: the torch chains the port ran before the kernel
# ---------------------------------------------------------------------------
def descramble(llr, c_init, n_bits: int):
    """llr (..., n_bits) * (1 - 2 * gold(c_init)) for c_init (...,)."""
    scr = sequences.gold_sequence_torch(c_init, n_bits)
    return llr * (1.0 - 2.0 * scr.to(torch.float32))


@prof.factory(64)
def _eq_demap_batch_fn(cell, qm: int, n_re_pad: int, n_ports: int):
    """Many grants' REs -> descrambled LLRs in one call.

    (grids (B,RX,L,2), h (B,RX,P,L,2), noise (B,), bidx (G,), u_idx (G,),
     re_tab (n_u, n), c_init (G,), pa (G,)) -> llr (G, n*qm)
    """
    def run(gflat, hflat, noise_var, bidx, u_idx, re_tab, c_init, pa):
        re_idx = re_tab[u_idx]                           # (G, n)
        # advanced-index gather: result (G, n, RX, 2) -> move RX forward
        y = gflat[bidx[:, None], :, re_idx, :]           # (G, n, RX, 2)
        y = torch.movedim(y, 1, 2)                       # (G, RX, n, 2)
        hh = hflat[bidx[:, None], :, :, re_idx, :]       # (G, n, RX, P, 2)
        hh = torch.movedim(hh, 1, 3)                     # (G, RX, P, n, 2)
        hh = hh * pa[:, None, None, None, None]          # p_a scaling
        nv = noise_var[bidx]
        x = chest.equalize_ports(y, hh, nv, n_ports)     # (G, n, 2)
        llr = demapper.llr(x, qm)                        # (G, n*qm)
        return descramble(llr, c_init, n_re_pad * qm)

    return run


def _reorg(cell, grids, h):
    """Once-per-batch grid reorg to PRB-major block layout:

    grids (B, RX, 14, n_sc, 2), h (B, RX, P, 14, n_sc, 2) ->
      Xg (B, n_prb, 14, 12, RX, 2), Xh (B, n_prb, 14, 12, RX, P, 2)

    so a grant's REs become whole-PRB contiguous blocks."""
    B = grids.shape[0]
    g = grids.reshape(B, grids.shape[1], 14, cell.n_prb, 12, 2)
    Xg = g.permute(0, 3, 2, 4, 1, 5).contiguous()
    hh = h.reshape(B, h.shape[1], h.shape[2], 14, cell.n_prb, 12, 2)
    Xh = hh.permute(0, 4, 3, 5, 1, 2, 6).contiguous()
    return Xg, Xh


@prof.factory(256)
def _eq_demap_prb_fn(cell, qm: int, n_prb: int, cfi: int, n_ports: int):
    """Eq/demap for one (qm, n_prb, cfi) group of PRB-list grants:
    PRB-block gather + constant data-RE compress + equalize + demap +
    descramble.  The RE selection within the (14, n_prb, 12) PRB window
    is a constant (the CRS pattern has period 6, so it is uniform across
    PRBs); only the PRB list rides as data.

    (Xg, Xh, noise_var (B,), bidx (G,), prbi (G, n_prb), c_init (G,),
     pa (G,)) -> llr (G, n_pad*qm)
    """
    res = pdsch_mod.reserved_re_mask(cell, 1, cfi)   # sf 1: no center puncture
    data_sc = [np.nonzero(~res[l, :12])[0] for l in range(14)]
    n_re = sum(n_prb * len(data_sc[l]) for l in range(cfi, 14))
    n_pad = bucket(n_re)
    SEL = np.zeros(n_pad, np.int64)
    pos = 0
    for l in range(cfi, 14):
        for p in range(n_prb):
            for k in data_sc[l]:
                SEL[pos] = (l * n_prb + p) * 12 + k
                pos += 1
    SEL[pos:] = SEL[pos - 1]

    def run(Xg, Xh, noise_var, bidx, prbi, c_init, pa):
        G = bidx.shape[0]
        sel = const(SEL, Xg.device)
        Y = Xg[bidx[:, None], prbi]              # (G, n_prb, 14, 12, RX, 2)
        Y = Y.permute(0, 4, 2, 1, 3, 5)          # (G, RX, 14, n_prb, 12, 2)
        y = Y.reshape(G, Y.shape[1], -1, 2)[:, :, sel]    # (G, RX, n_pad, 2)
        H = Xh[bidx[:, None], prbi]           # (G, n_prb, 14, 12, RX, P, 2)
        H = H.permute(0, 4, 5, 2, 1, 3, 6)
        hh = H.reshape(G, H.shape[1], H.shape[2], -1, 2)[:, :, :, sel]
        hh = hh * pa[:, None, None, None, None]
        nv = noise_var[bidx]
        x = chest.equalize_ports(y, hh, nv, n_ports)
        llr = demapper.llr(x, qm)
        return descramble(llr, c_init, n_pad * qm)

    return run, n_pad


def eq_demap_plain(grids, h, noise_var, desc, re_tab, cell, n_grants: int,
                   wm: int):
    """Plain version of the kernel (torch ops, any device): the same
    (n_grants, wm) rows from the same descriptors.  The grants are taken
    in groups: PRB-list grants by (qm, PRB count, CFI) over `_reorg`'s
    copy, table grants by (qm, n_pad) over the RE table."""
    dev = grids.device
    if dev.type == "cuda":
        PLAIN_CUDA["pdsch_eq_demap"] += 1
    vals = desc.tolist()
    prb0 = DESC_WORDS * n_grants + n_grants + 1
    ports = int(h.shape[2])
    out = torch.zeros((n_grants, wm), dtype=torch.float32, device=dev)
    fast, tab = {}, {}
    for g in range(n_grants):
        d = vals[DESC_WORDS * g:DESC_WORDS * (g + 1)]
        key = ((d[QM], d[SHAPE] & 0xFF, d[SHAPE] >> 8) if d[SHAPE] >= 0
               else (d[QM], d[NPAD]))
        (fast if d[SHAPE] >= 0 else tab).setdefault(key, []).append(d + [g])

    def t(x, dtype=torch.int64):
        return torch.tensor(x, dtype=dtype, device=dev)

    def scalars(ds):
        return (t([d[B] for d in ds]),
                t([d[CINIT] & 0xFFFFFFFF for d in ds]),
                t(np.array([d[PA] for d in ds], np.int32).view(np.float32),
                  torch.float32))
    if fast:
        Xg, Xh = _reorg(cell, grids, h)
    for (qm, n_prb, cfi), ds in fast.items():
        fn, n_pad = _eq_demap_prb_fn(cell, qm, n_prb, cfi, ports)
        bidx, cinit, pa = scalars(ds)
        prbi = t([vals[prb0 + d[SRC_W]:prb0 + d[SRC_W] + n_prb] for d in ds])
        out[t([d[-1] for d in ds]), :n_pad * qm] = fn(
            Xg, Xh, noise_var, bidx, prbi, cinit, pa)
    gflat = grids.reshape(grids.shape[0], grids.shape[1], -1, 2)
    hflat = h.reshape(h.shape[0], h.shape[1], h.shape[2], -1, 2)
    for (qm, n_pad), ds in tab.items():
        fn = _eq_demap_batch_fn(cell, qm, n_pad, ports)
        bidx, cinit, pa = scalars(ds)
        out[t([d[-1] for d in ds]), :n_pad * qm] = fn(
            gflat, hflat, noise_var, bidx, t([d[SRC_W] for d in ds]),
            re_tab[:, :n_pad], cinit, pa)
    return out


# ---------------------------------------------------------------------------
# the kernel: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and its wrapper
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/pdsch_eq_demap.cu (at first use) and return its entry."""
    lib = nvcc_build.load("pdsch_eq_demap", SRC)
    names = ("pdsch_eq_demap_threads", "pdsch_eq_demap_desc_words",
             "pdsch_eq_demap_const_floats", "pdsch_eq_demap_const_ints")
    for name in names:
        getattr(lib, name).restype = ctypes.c_int
    got = tuple(getattr(lib, name)() for name in names)
    want = (THREADS, DESC_WORDS, FLOATS.size, N_SYM + N_SYM * 12)
    if got != want:
        raise RuntimeError(f"pdsch_eq_demap: the kernel's (threads, "
                           f"descriptor words, floats, ints) are {got}, the "
                           f"wrapper's {want}")
    lib.pdsch_eq_demap_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 3)
    lib.pdsch_eq_demap_launch.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("pdsch_eq_demap", 0.0)


def _check(grids, h, noise_var, table: Table, re_tab, cell,
           arr: Optional[np.ndarray] = None):
    """(rx, ports) of the call, or raises on what the kernel does not
    take (`arr`: the table's `array()`, if made already): the checks need
    no card."""
    for name, x, dt in (("grids", grids, torch.float32),
                        ("h", h, torch.float32),
                        ("noise_var", noise_var, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"pdsch_eq: {name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pdsch_eq: {name} must be contiguous")
    if grids.dim() != 5 or tuple(grids.shape[2:]) != (N_SYM, cell.n_sc, 2):
        raise ValueError(f"pdsch_eq: grids has shape {tuple(grids.shape)}, "
                         f"expected (B, RX, 14, {cell.n_sc}, 2)")
    n_b, rx = int(grids.shape[0]), int(grids.shape[1])
    if rx not in (1, 2):
        raise ValueError(f"pdsch_eq: {rx} receive antennas, the kernel "
                         "takes 1 or 2")
    if h.dim() != 6 or tuple(h.shape[:2]) != (n_b, rx) or \
            tuple(h.shape[3:]) != tuple(grids.shape[2:]) or \
            h.shape[2] != table.ports:
        raise ValueError(f"pdsch_eq: h has shape {tuple(h.shape)}, expected "
                         f"({n_b}, {rx}, {table.ports}, 14, {cell.n_sc}, 2)")
    if tuple(noise_var.shape) != (n_b,):
        raise ValueError(f"pdsch_eq: noise_var has shape "
                         f"{tuple(noise_var.shape)}, expected ({n_b},)")
    G = table.n_grants
    if G < 1:
        raise ValueError("pdsch_eq: no grant")
    if arr is None:
        arr = table.array()
    d = arr[:DESC_WORDS * G].reshape(G, DESC_WORDS)
    prbs = arr[DESC_WORDS * G + G + 1:]
    if d[:, B].min() < 0 or d[:, B].max() >= n_b:
        raise ValueError(f"pdsch_eq: a grant's subframe is not in the "
                         f"batch of {n_b}")
    fast = d[:, SHAPE] >= 0
    if fast.any():
        cfi = np.minimum(d[fast, SHAPE] >> 8, N_SYM - 1)
        n_prb = d[fast, SHAPE] & 0xFF
        # REs of a PRB in the symbols from l on
        counts = np.cumsum(cell_constants(cell)[N_SYM - 1::-1])[::-1]
        if (d[fast, SHAPE] >> 8).max() >= N_SYM or \
                (d[fast, SRC_W] + n_prb).max() > len(prbs) or \
                prbs.min() < 0 or prbs.max() >= cell.n_prb or \
                not np.array_equal(d[fast, NRE], n_prb * counts[cfi]):
            raise ValueError("pdsch_eq: a PRB-list grant's CFI, PRBs or RE "
                             "count does not fit the cell")
    if (~fast).any():
        if re_tab is None or re_tab.dtype != torch.int64 or \
                re_tab.dim() != 2 or not re_tab.is_contiguous() or \
                d[~fast, SRC_W].max() >= re_tab.shape[0] or \
                d[~fast, SRC_W].min() < 0 or \
                table.n_pad_tab > re_tab.shape[1]:
            raise ValueError("pdsch_eq: the table grants need a contiguous "
                             "int64 RE table with their rows and n_pad "
                             "columns")
    return rx, table.ports


def eq_demap_cuda(grids, h, noise_var, desc, table: Table, re_tab, cell,
                  arr: Optional[np.ndarray] = None):
    """Launch the kernel once on the current stream of the tensors'
    device, with that device made current (CUDA tensors only; `arr`: the
    table's `array()`, if made already).  Returns the (G, wm) rows."""
    rx, ports = _check(grids, h, noise_var, table, re_tab, cell, arr)
    dev = grids.device
    ins = [grids, h, noise_var, desc] + ([re_tab] if re_tab is not None
                                         else [])
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError(f"pdsch_eq: tensors on "
                         f"{sorted({str(x.device) for x in ins})}, not one "
                         "CUDA device")
    if desc.dtype != torch.int32 or desc.numel() != len(table.desc) + \
            len(table.first) + len(table.prbs):
        raise ValueError("pdsch_eq: the descriptors are not the table's")
    fn = _library().pdsch_eq_demap_launch
    ints = cell_constants(cell)
    with torch.cuda.device(dev):
        gold = mimo_eq.gold_table(table.wm, dev)
        out = torch.empty((table.n_grants, table.wm), dtype=torch.float32,
                          device=dev)
        err = fn(grids.data_ptr(), h.data_ptr(), noise_var.data_ptr(),
                 re_tab.data_ptr() if re_tab is not None else None,
                 gold.data_ptr(), desc.data_ptr(), out.data_ptr(),
                 N_SYM * cell.n_sc, cell.n_sc, rx, ports, table.n_grants,
                 table.n_blocks, table.wm,
                 int(re_tab.shape[1]) if re_tab is not None else 0,
                 FLOATS.ctypes.data, ints.ctypes.data,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pdsch_eq_demap kernel launch failed: cudaError "
                           f"{err} ({table.n_grants} grants, RX {rx}, ports "
                           f"{ports})")
    LAUNCHES["pdsch_eq_demap"] += 1
    return out


def eq_demap(grids, h, noise_var, table: Table, re_tab, cell):
    """Every grant of `table` equalized, demapped and descrambled into one
    rows matrix: the kernel for CUDA tensors, the plain version for CPU
    tensors.

    Args:
      grids: (B, RX, 14, n_sc, 2) float32 resource grids, RX in {1, 2}.
      h: (B, RX, P, 14, n_sc, 2) float32 port channels, P in {1, 2, 4}.
      noise_var: (B,) float32.
      table: the grants (`Table`, made for P ports).
      re_tab: (U, tab_w) int64 RE index rows of the table grants (the
        padded tail repeating the last RE), or None if there is none.
      cell: the cell (`phy.params.CellConfig`).

    Returns:
      ((G, wm) float32 rows: row g holds grant g's n_pad * qm LLRs, then
      zeros; the host buffer of the descriptors, to keep until the rows
      have been used).
    """
    dev = grids.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"pdsch_eq: unsupported device {dev}")
    arr = table.array()
    host, desc = upload(table, dev, arr)
    if dev.type == "cuda":
        out = eq_demap_cuda(grids, h, noise_var, desc, table, re_tab, cell,
                            arr)
    else:
        _check(grids, h, noise_var, table, re_tab, cell, arr)
        out = eq_demap_plain(grids, h, noise_var, desc, re_tab, cell,
                             table.n_grants, table.wm)
    prof.count("pdsch_eq_grants", table.n_grants)
    return out, host
