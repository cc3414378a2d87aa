"""PDSCH decode path: equalize -> demap -> descramble -> de-rate-match ->
turbo decode -> CRC, with HARQ soft combining (torch).

Counterpart of `ltesniffer_tpu/sniffer/pdsch_rx.py`: single-layer grants
(TM1 port 0, TM2 SFBC) through the batched main path, and two-codeword
spatial multiplexing (TM3 CDD, TM4 closed loop) through
`decode_grant_mimo`; capability parity with the reference's
`PDSCH_Decoder::decode_dl_mode` (`src/src/DL_Sniffer_PDSCH.cc:881-1291`):
per-DCI decode, softbuffer reuse for retransmissions, dual-table retry
handled by the caller (MCSTracking).

The per-RE math (gather, equalize, demap, Gold descramble) of every
single-layer grant of a dispatch runs as one launch of
`kernels/pdsch_eq.py`'s kernel on the card (its plain torch version on the
CPU), a two-codeword grant's as one launch of `kernels/mimo_eq.py`'s; the
de-rate-match of every code block (`kernels/cb_derm.py`), the turbo
decoder with the CB CRC24B and packing in its epilogue, and the
transport-block finish run on the grids' device too, a fixed set of
launches a dispatch; the thin glue (segmentation sizes, descriptors) is
NumPy on the host.  Integer words that the JAX package keeps as uint32 are
int64 here (torch's uint32 has little CUDA support) and become uint32 on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import crc, pdsch as pdsch_mod, turbo as turbo_mod
from ltesniffer_tpu_torch.phy import uci as uci_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import cb_derm, mimo_eq, pdsch_eq
from ltesniffer_tpu_torch.kernels import tb_finish, turbo_decode
from ltesniffer_tpu_torch.kernels import turbo as kturbo
from ltesniffer_tpu_torch.kernels.cplx import const
from ltesniffer_tpu_torch.kernels.pdsch_eq import (  # noqa: F401
    RE_BUCKET, bucket as _bucket, descramble as _descramble)
from ltesniffer_tpu_torch.sniffer import prof

_W32 = (1 << np.arange(32, dtype=np.int64))


def _host(x, site: str) -> np.ndarray:
    """x on the host; a tensor through one read counted at `site`."""
    return (prof.host_read(site, x).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


class LazyRow:
    """A HARQ soft buffer stored as (parent device tensor, row): the row
    is gathered only when a retransmission actually combines with it."""
    __slots__ = ("arr", "i")

    def __init__(self, arr, i):
        self.arr, self.i = arr, i

    @property
    def shape(self):
        return tuple(self.arr.shape[1:])

    def get(self):
        return self.arr[self.i]


def _buffer_value(v):
    return v.get() if isinstance(v, LazyRow) else v


def _eq_demap_fn(grids, h, noise_var, cell: CellConfig, job: "GrantJob",
                 src: tuple):
    """One grant's REs -> its (n_pad * qm,) descrambled LLRs: the batched
    eq/demap (`_eq_rows`, one kernel launch on the card) of one grant, its
    `_re_source` `src`.

    p_a: the job's linear PDSCH-to-CRS amplitude ratio 10^(p_a/20) from the
    UE's dedicated config (`MCSTracking.cc:1446-1529` stores p_a; applied as
    a scale on the CRS-derived channel estimate)."""
    table, re_tab = _eq_table(cell, int(h.shape[2]), [job], [0], [src],
                              grids.device)
    rows, _desc_host = _eq_rows(grids, h, noise_var, table, re_tab, cell)
    return rows[0]


class PdschResult:
    """One transport block's decode.  On success its payload (without the
    TB CRC) is `payload`, bytes MSB first, as the MAC handlers and the pcap
    take it: on the batched path straight from `tb_finish`'s buffer.
    `tb_bits` is the same payload as 0/1 bits, derived from the bytes when
    read; setting it makes those bits the payload."""
    __slots__ = ("rnti", "tbs", "crc_ok", "cb_crc_ok", "d_llrs", "n_re",
                 "_bits", "_bytes")

    def __init__(self, rnti: int, tbs: int, crc_ok: bool,
                 tb_bits: Optional[np.ndarray], cb_crc_ok: List[bool],
                 d_llrs: List[np.ndarray], n_re: int = 0,
                 payload: Optional[bytes] = None):
        self.rnti, self.tbs, self.crc_ok = rnti, tbs, crc_ok
        self.cb_crc_ok = cb_crc_ok
        self.d_llrs = d_llrs                # per-CB (3, K+4) combined LLRs
        self.n_re = n_re
        self._bits, self._bytes = tb_bits, payload

    @property
    def tb_bits(self) -> Optional[np.ndarray]:
        if self._bits is None and self._bytes is not None:
            self._bits = np.unpackbits(np.frombuffer(self._bytes, np.uint8),
                                       count=self.tbs)
            self._bytes = None
        return self._bits

    @tb_bits.setter
    def tb_bits(self, bits: Optional[np.ndarray]):
        self._bits, self._bytes = bits, None

    @property
    def payload(self) -> Optional[bytes]:
        if self._bits is not None:
            return np.packbits(self._bits).tobytes()
        return self._bytes

    def __repr__(self):
        return (f"PdschResult(rnti={self.rnti}, tbs={self.tbs}, "
                f"crc_ok={self.crc_ok}, cb_crc_ok={self.cb_crc_ok}, "
                f"n_re={self.n_re})")


def decode_grant(grids, h, noise_var, b: int, cell: CellConfig, sf_idx: int,
                 cfi: int, rnti: int, prb_mask: np.ndarray, qm: int, tbs: int,
                 rv: int = 0, prb_mask_slot1: Optional[np.ndarray] = None,
                 soft_buffers: Optional[Dict] = None,
                 harq_key: Optional[Tuple] = None,
                 n_iter: int = 8, pa: float = 1.0) -> PdschResult:
    """Decode one PDSCH grant from subframe ``b`` of a demodulated batch.

    grids: (B, RX, 14, n_sc, 2); h: (B, RX, P, 14, n_sc, 2); noise_var: (B,)
    tensors.  soft_buffers: dict keyed by (harq_key, cb) holding per-CB
    (3, K+4) LLR arrays (HARQ combining; `HARQ.cc` semantics live in the
    caller).
    """
    job = GrantJob(b=b, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                   prb_mask=np.asarray(prb_mask, bool), qm=qm, tbs=tbs,
                   prb_mask_slot1=None if prb_mask_slot1 is None
                   else np.asarray(prb_mask_slot1, bool), pa=pa)
    src = _src_of(cell, job)
    n_re = src[0]
    G = n_re * qm
    if tbs <= 0 or n_re == 0:
        return PdschResult(rnti, tbs, False, None, [], [], n_re)
    dev = grids.device
    llr = _host(_eq_demap_fn(grids, h, noise_var, cell, job, src),
                "grant_llr")[:G]
    return _decode_tb_from_llrs(llr, rnti, tbs, qm, rv, n_re, soft_buffers,
                                harq_key, n_iter, dev)


# ---------------------------------------------------------------------------
# Spatial multiplexing (TM3/TM4): two codewords over two layers
# ---------------------------------------------------------------------------
@prof.factory(64)
def _eq_demap_mimo_fn(cell: CellConfig, qm0: int, qm1: int, n_re_pad: int,
                      tm: int, pmi: int):
    """2-layer equalize + per-codeword demap/descramble.

    (grid_flat (RX, L, 2), h_flat (RX, P, L, 2), noise 0-d, re_idx
     (n_re_pad,) int64, c_init0 / c_init1 ints) -> both codewords' LLRs in
    one (n_re_pad * (qm0 + qm1),) buffer: one launch of the kernel
    `kernels/csrc/mimo_eq_demap.cu` on the card, the plain torch chain on
    the CPU (`kernels/mimo_eq.py`)."""
    def run(grid_flat, h_flat, noise_var, re_idx, c_init0, c_init1):
        return mimo_eq.eq_demap_mimo(grid_flat, h_flat, noise_var, re_idx,
                                     c_init0, c_init1, tm, pmi, qm0, qm1)

    return run


@prof.factory(512)
def _mimo_index(cell: CellConfig, sf_idx: int, cfi: int, mask: bytes,
                device: str) -> tuple:
    """`_mimo_re_index` of a PRB mask given as bytes (a device as str)."""
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi,
                                        np.frombuffer(mask, dtype=bool))
    n_re = len(re_idx)
    n_pad = _bucket(n_re)
    idx = np.full(n_pad, re_idx[-1], dtype=np.int64)
    idx[:n_re] = re_idx
    return n_re, n_pad, torch.from_numpy(idx).to(device)


def _mimo_re_index(cell: CellConfig, sf_idx: int, cfi: int,
                   prb_mask: np.ndarray, device):
    """(n_re, n_pad, (n_pad,) int64 RE index on `device`) of a
    two-codeword grant, the padded tail repeating the last RE; uploaded
    once per (subframe index, CFI, PRB mask, device)."""
    return _mimo_index(cell, sf_idx, cfi,
                       np.asarray(prb_mask, bool).tobytes(), str(device))


def decode_grant_mimo(grids, h, noise_var, b: int, cell: CellConfig,
                      sf_idx: int, cfi: int, rnti: int, prb_mask: np.ndarray,
                      qms, tbss, tm: int, pmi: int = 0, rvs=(0, 0),
                      soft_buffers=None, harq_keys=(None, None),
                      n_iter: int = 8):
    """Decode a 2-codeword spatial-multiplexed grant.  Returns per-codeword
    PdschResult list (capability parity: `DL_Sniffer_PDSCH.cc` TM3/TM4 path).

    Both codewords' LLRs come out of one kernel launch in one buffer and
    to the host in one read; their code blocks are decoded together, one
    decoder call (and one read) per code-block size — each block decodes
    on its own, so the bits are those of two separate decodes.

    Traced as four child spans of the caller's (`pm_eqdemap`, `pm_derm`,
    `pm_turbo`, `pm_finish`), one event of `pdsch_mimo_grant` a call and
    one of `pdsch_mimo_cb` a turbo launch (its code blocks the total)."""
    prof.count("pdsch_mimo_grant")
    dev = grids.device
    with prof.span("pm_eqdemap"):
        n_re, n_pad, idx = _mimo_re_index(cell, sf_idx, cfi, prb_mask, dev)
        ci = [pdsch_mod.scrambling_cinit(rnti, q, sf_idx, cell.n_id_cell)
              for q in (0, 1)]
        fn = _eq_demap_mimo_fn(cell, qms[0], qms[1], n_pad, tm, pmi)
        gflat = grids[b].reshape(grids.shape[1], -1, 2)
        hflat = h[b].reshape(h.shape[1], h.shape[2], -1, 2)
        both = _host(fn(gflat, hflat, noise_var[b], idx, *ci), "mimo_llr")
    n0 = n_pad * qms[0]
    cw = [both[:n0], both[n0:]]
    with prof.span("pm_derm"):
        segs = [_derm_cbs(cw[q][:n_re * qms[q]], tbss[q], qms[q], rvs[q],
                          n_re, soft_buffers, harq_keys[q]) for q in (0, 1)]
    with prof.span("pm_turbo"):
        bits = _decode_cbs([d for seg in segs if seg is not None
                            for d in seg[1]], n_iter, dev, site="mimo_bits",
                           launches="pdsch_mimo_cb")
    results = []
    with prof.span("pm_finish"):
        for q in (0, 1):
            if segs[q] is None:
                results.append(PdschResult(rnti, tbss[q], False, None, [],
                                           [], n_re))
                continue
            seg, d_llrs = segs[q]
            blocks, bits = bits[:seg.C], bits[seg.C:]
            results.append(_finish_tb(seg, blocks, d_llrs, rnti, tbss[q],
                                      n_re, soft_buffers, harq_keys[q]))
    return results


def _decode_tb_from_llrs(llr, rnti, tbs, qm, rv, n_re, soft_buffers,
                         harq_key, n_iter, device) -> PdschResult:
    """Shared backend: segmented de-rate-match + turbo + CRC."""
    segd = _derm_cbs(llr, tbs, qm, rv, n_re, soft_buffers, harq_key)
    if segd is None:
        return PdschResult(rnti, tbs, False, None, [], [], n_re)
    seg, d_llrs = segd
    return _finish_tb(seg, _decode_cbs(d_llrs, n_iter, device), d_llrs,
                      rnti, tbs, n_re, soft_buffers, harq_key)


def _derm_cbs(llr, tbs, qm, rv, n_re, soft_buffers, harq_key):
    """Host de-rate-match of one TB's LLRs into per-code-block (3, K+4)
    arrays, HARQ-combined with (and stored into) the soft buffers.
    Returns (segmentation, [d per code block]), or None if tbs <= 0."""
    if tbs <= 0:
        return None
    G = n_re * qm
    seg = turbo_mod.segment_sizes(tbs)
    es = pdsch_mod.cb_rate_match_sizes(G, seg.C, qm)
    d_llrs = []
    off = 0
    for ci_, (K, E) in enumerate(zip(seg.K, es)):
        F = seg.F if ci_ == 0 else 0
        pos = turbo_mod.derm_positions(K, F, E, rv)
        d = np.zeros(3 * (K + 4), dtype=np.float32)
        np.add.at(d, pos, llr[off:off + E])
        d = d.reshape(3, K + 4)
        if F:
            d[0, :F] = 1e4
            d[1, :F] = 1e4
        off += E
        if soft_buffers is not None and harq_key is not None:
            # buffers may be device tensors (stored by the batch path);
            # a K mismatch means the TBS changed since the buffer was
            # stored -> the stored soft bits are invalid (`HARQ.cc:71-130`)
            prev = soft_buffers.get((harq_key, ci_))
            if prev is not None and tuple(prev.shape) == d.shape:
                d = _host(_buffer_value(prev), "soft_buffer") + d
            soft_buffers[(harq_key, ci_)] = d
            d = d.copy()
        d_llrs.append(d)
    return seg, d_llrs


def _decode_cbs(d_llrs, n_iter, device, site: str = "grant_bits",
                launches: Optional[str] = None) -> List[np.ndarray]:
    """Turbo-decode (3, K+4) code blocks: one decoder call per code-block
    size on `device`; returns each block's (K,) hard bits on the host, one
    read (counted at `site`) per size.  With `launches`, each call is one
    event of that counter, its code blocks the total."""
    by_k = {}
    for c, d in enumerate(d_llrs):
        by_k.setdefault(d.shape[1] - 4, []).append(c)
    bits_per_cb = [None] * len(d_llrs)
    for K, cis in by_k.items():
        if launches is not None:
            prof.count(launches, len(cis))
        batch = torch.from_numpy(np.stack([d_llrs[c] for c in cis])).to(device)
        bits, _ = kturbo.make_decoder(K, n_iter)(batch)
        bits = _host(bits, site)
        for j, c in enumerate(cis):
            bits_per_cb[c] = bits[j]
    return bits_per_cb


def _finish_tb(seg, bits_per_cb, d_llrs, rnti, tbs, n_re, soft_buffers,
               harq_key) -> PdschResult:
    """CB CRC24B (segmented TBs), reassembly and TB CRC24A on the host;
    drops the HARQ soft buffers on success."""
    cb_ok, parts = [], []
    for ci_, K in enumerate(seg.K):
        blk = bits_per_cb[ci_]
        F = seg.F if ci_ == 0 else 0
        if seg.C > 1:
            ok = crc.crc_bits(blk, crc.CRC24B).sum() == 0
            data = blk[F:K - turbo_mod.SEG_CRC]
        else:
            ok = True
            data = blk[F:]
        cb_ok.append(bool(ok))
        parts.append(data)
    tb_with_crc = np.concatenate(parts)[:seg.B]
    tb_ok = all(cb_ok) and crc.crc_bits(tb_with_crc, crc.CRC24A).sum() == 0
    tb_bits = tb_with_crc[:tbs] if tb_ok else None
    if tb_ok and soft_buffers is not None and harq_key is not None:
        for ci_ in range(seg.C):
            soft_buffers.pop((harq_key, ci_), None)
    prof.count("pdsch_tb_host")
    return PdschResult(rnti, tbs, bool(tb_ok), tb_bits, cb_ok, d_llrs, n_re)


# ---------------------------------------------------------------------------
# Batched multi-grant decoding (the main path)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GrantJob:
    b: int                      # batch index into grids
    sf_idx: int
    cfi: int
    rnti: int
    prb_mask: np.ndarray
    qm: int
    tbs: int
    rv: int = 0
    prb_mask_slot1: Optional[np.ndarray] = None
    harq_key: Optional[Tuple] = None
    is_retx: bool = False       # HARQ: combine with the stored soft buffer
    pa: float = 1.0             # linear 10^(p_a/20) PDSCH power scale
    tag: object = None          # caller cookie (e.g. the AcceptedDci)


@prof.factory(512)
def _re_tab(cell: CellConfig, n_pad: int, combos: tuple) -> np.ndarray:
    """The RE index table of one eq/demap call's table grants.

    combos: tuple of (sf_idx, cfi, prb_mask bytes, slot1 bytes|None).
    Returns (U, n_pad) int64 (tail positions clamp to the last RE).  A
    loaded cell re-issues the same allocations every frame, so the tables
    are cached (and uploaded once per device through `const`)."""
    tab = np.zeros((len(combos), n_pad), np.int64)
    for u, (sf_idx, cfi, mb, s1b) in enumerate(combos):
        mask = np.frombuffer(mb, dtype=bool)
        s1 = None if s1b is None else np.frombuffer(s1b, dtype=bool)
        re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, mask, s1)
        tab[u, :len(re_idx)] = re_idx
        tab[u, len(re_idx):] = re_idx[-1]
    return tab


@prof.factory(16)
def _center_prbs(cell: CellConfig) -> frozenset:
    """PRBs overlapping the center 6 RBs (PBCH/PSS/SSS puncture zone)."""
    lo = cell.n_sc // 2 - 36
    hi = cell.n_sc // 2 + 36
    return frozenset(p for p in range(cell.n_prb)
                     if 12 * p < hi and 12 * p + 12 > lo)


@prof.factory(8192)
def _re_source(cell: CellConfig, sf_idx: int, cfi: int, mask: bytes,
               slot1: Optional[bytes]) -> tuple:
    """(n_re, PRB list, None) of an allocation whose RE pattern is that of
    every subframe (no centre-PRB puncture, one slot mask), else (n_re,
    None, its RE table combo (sf_idx, cfi, mask, slot1)); masks as bytes.
    A loaded cell re-issues the same allocations, so this is cached."""
    prb = np.frombuffer(mask, dtype=bool)
    n_re = len(pdsch_mod.grant_re_indices(
        cell, sf_idx, cfi, prb,
        None if slot1 is None else np.frombuffer(slot1, dtype=bool)))
    if slot1 is None and not (sf_idx in (0, 5)
                              and any(prb[p] for p in _center_prbs(cell))):
        return n_re, [int(p) for p in np.flatnonzero(prb)], None
    return n_re, None, (sf_idx, cfi, mask, slot1)


def _src_of(cell: CellConfig, j: GrantJob) -> tuple:
    """`_re_source` of a job's allocation."""
    return _re_source(cell, j.sf_idx, j.cfi, j.prb_mask.tobytes(),
                      None if j.prb_mask_slot1 is None
                      else j.prb_mask_slot1.tobytes())


def _eq_table(cell: CellConfig, ports: int, jobs: List[GrantJob],
              jis: List[int], srcs: List[tuple], device):
    """The `pdsch_eq.Table` of grants `jis` of `jobs` (their
    `_re_source`s `srcs`), grant jis[r] in row r, and the RE table its
    table grants read (None if it has none), built and uploaded once per
    set of allocations (`_re_tab`)."""
    table = pdsch_eq.Table(ports)
    combos: list = []
    u_of: Dict[tuple, int] = {}
    n_id = cell.n_id_cell
    for ji, (n_re, prbs, combo) in zip(jis, srcs):
        j = jobs[ji]
        c_init = pdsch_mod.scrambling_cinit(j.rnti, 0, j.sf_idx, n_id)
        if prbs is not None:
            table.add_prbs(j.b, j.qm, c_init, j.pa, n_re, _bucket(n_re),
                           j.cfi, prbs)
            continue
        u = u_of.get(combo)
        if u is None:
            u = u_of[combo] = len(combos)
            combos.append(combo)
        table.add_row(j.b, j.qm, c_init, j.pa, n_re, _bucket(n_re), u)
    re_tab = (const(_re_tab(cell, table.n_pad_tab, tuple(combos)), device)
              if combos else None)
    return table, re_tab


def _eq_rows(grids, h, noise_var, table: pdsch_eq.Table, re_tab,
             cell: CellConfig):
    """The grants of `table` through one call of `pdsch_eq.eq_demap` (one
    kernel launch on the card): row r of the (G, Wm) result holds grant
    r's n_pad * qm LLRs, then zeros.  Returns (rows, the descriptors' host
    buffer, to keep until the rows have been used)."""
    with prof.span("pd_eqdemap_call"):
        return pdsch_eq.eq_demap(grids.contiguous(), h.contiguous(),
                                 noise_var, table, re_tab, cell)


def _stack_rows(eq_outs: List, Wm: int):
    """Stack per-group eq/demap outputs into one (T, Wm) rows matrix
    (zero-padded columns; padded tails are masked out by e_true): the
    uplink's batched path (`pusch_rx`); the downlink's rows come whole out
    of `_eq_rows`."""
    parts = [o if int(o.shape[1]) == Wm
             else torch.nn.functional.pad(o, (0, Wm - int(o.shape[1])))
             for o in eq_outs]
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def _derm_laps(K: int, F: int, E: int) -> int:
    """Number of circular-buffer laps the selection of E bits spans."""
    return cb_derm.laps(K, F, E)


def _crc_pack(bits, K: int):
    """(n, K) uint8 decoded bits -> (n, 1+Wk) int64 rows [CB CRC24B
    remainder popcount | packed u32 bit words]."""
    n = bits.shape[0]
    Wk = (K + 31) // 32
    rem = crc.batched_crc(bits, crc.CRC24B).to(torch.int64)
    remsum = torch.sum(rem, dim=-1)
    pad = torch.nn.functional.pad(bits, (0, Wk * 32 - K))
    packed = torch.sum(pad.reshape(n, Wk, 32).to(torch.int64)
                       * const(_W32, bits.device), dim=-1)
    return torch.cat([remsum[:, None], packed], dim=1)


@prof.factory(512)
def _uci_src_map(EB: int, src_key: tuple):
    """UL UCI data-cell map for one window: (SRC (EB,) int64 row positions,
    clamped to 0 where unused; SRC_OK (EB,) bool).

    src_key = ("uci", m_sc, qm, n_ri, n_ack, n_cqi, off0): CQI cells head
    the multiplexed stream, RI cells are removed from the data cells, ACK
    cells read zero (punctures), and the window starts off0 LLRs into the
    remaining stream (36.212 5.2.2.8).  Positions lie below 12*m_sc*qm,
    the row's own width."""
    _, m_sc, qm, n_ri, n_ack, n_cqi, off0 = src_key
    _, ack_cells = uci_mod.uci_positions(m_sc, qm, n_ri, n_ack)
    data_cells = uci_mod.data_group_map(m_sc, n_ri)
    cell_src = (data_cells[:, None] * qm + np.arange(qm)).astype(np.int64)
    ack = np.zeros(12 * m_sc, bool)
    ack[ack_cells] = True
    cell_src[ack[data_cells]] = -1       # ACK punctures read zero
    rel = cell_src[n_cqi:].reshape(-1)
    SRC = np.full(EB, -1, np.int64)
    n_av = max(0, min(EB, len(rel) - off0))
    SRC[:n_av] = rel[off0:off0 + n_av]
    SRC_OK = SRC >= 0
    return np.where(SRC_OK, SRC, 0), SRC_OK


@prof.factory(512)
def _derm_turbo_static_fn(K: int, F: int, laps: int, rv: int, n_iter: int,
                          src_key: tuple = ("lin",)):
    """Finisher for one code-block-size group: window select +
    de-rate-match + filler LLRs + (HARQ prior add) + turbo decode + CB
    CRC24B + bit packing: the uplink's route (the downlink's batched
    dispatch takes `kernels/cb_derm.py` and the turbo kernel's packing
    entry, `_turbo_only_fn`).

    The de-rate-match runs as constant index maps (`cb_derm.fold`: fold
    the E LLRs over circular-buffer laps -> rotate by the rv start ->
    inverse sub-block permutation).  The exact E and each row's bit offset
    ride as data.

    src_key selects the per-row LLR window within its rows-matrix row:
      ("lin",)                      contiguous slice at `off` (every DL
                                    caller, and PUSCH without UCI)
      ("uci", m_sc, qm, n_ri, n_ack, n_cqi, off0)
                                    the PUSCH data cells around the UCI
                                    (`_uci_src_map`); `off` is unused, the
                                    offset is folded into the map

    (rows_mat (T, Wm), rows (n,), e_true (n,), off int [, prior (n,3,K+4)])
      -> (fused (n*(1+Wk),) int64 flat [crc_rem | packed bits] rows,
          d (n, 3, K+4) f32 combined LLRs)
    """
    s0 = cb_derm.start_rank(K, F, rv)
    EB = laps * cb_derm.static_maps(K, F)[2]
    lin = src_key[0] == "lin"
    if not lin:
        SRC, SRC_OK = _uci_src_map(EB, src_key)
    dec = kturbo.make_decoder(K, n_iter)

    def run(rows_mat, rows, e_true, off: int, prior=None):
        if lin:
            x = cb_derm.window(rows_mat, rows, e_true, off, EB)
        else:
            dev = rows_mat.device
            x = rows_mat[rows][:, const(SRC, dev)]        # (n, EB)
            ok = (torch.arange(EB, device=dev)[None, :] < e_true[:, None]) \
                & const(SRC_OK, dev)[None, :]
            x = torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=dev))
        d = cb_derm.fold(x, K, F, laps, s0, prior)
        bits, _ = dec(d)                                  # (n, K) u8
        return _crc_pack(bits, K).reshape(-1), d

    return run


@prof.factory(64)
def _turbo_only_fn(K: int, n_iter: int):
    """Decode (n, 3, K+4) combined LLRs of one K into (n, 1+Wk) rows
    [CB CRC24B remainder popcount | packed bits]: the batched dispatch's
    decode (one launch per K) and the iteration-escalation retry (straight
    from the stored combined LLRs at a higher iteration count — the
    batched analog of srsRAN's per-CB early stop: the primary pass runs
    few iterations; only CRC failures pay for more).

    run(d, out=None, word_off=0): on the card one launch of the turbo
    kernel's packing entry, on the CPU the decoder and `_crc_pack`; with
    `out` (a 1-d int64 tensor) the rows are written into it from word
    `word_off` on."""
    dec = kturbo.make_decoder(K, n_iter)

    def run(d, out=None, word_off: int = 0):
        d = d.to(torch.float32)
        if d.device.type == "cuda":
            return turbo_decode.turbo_decode_pack_cuda(
                d.contiguous(), K, n_iter, out, word_off)
        rows = _crc_pack(dec(d)[0], K)
        if out is not None:
            out[word_off:word_off + rows.numel()] = rows.reshape(-1)
        return rows

    return run


@dataclasses.dataclass
class PendingPdschBatch:
    """In-flight device decode: `dispatch_grants_batch` output, finished by
    `finish_grants_batch` (one pipeline phase later, so the device queue
    stays busy while the host works)."""
    jobs: List[GrantJob]
    results: List[Optional[PdschResult]]
    seg_of: Dict[int, object]
    group_rows: list          # [(K, Wk, n_K, [(ji, ci, F), ...]), ...],
                              # one a K, ascending
    fused_dev: object         # flat int64 device tensor: per-K (n_K, 1+Wk)
                              # row blocks concatenated
    n_re_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    # (ji, ci) -> LazyRow into the dispatch's combined-LLR slabs (one
    # (n_K, 3, K+4) slab a K), kept for HARQ and the iteration-escalation
    # retry (decode failures re-run at higher n_iter straight from these,
    # skipping equalize/de-rate-match)
    d_of: Dict[Tuple[int, int], object] = dataclasses.field(
        default_factory=dict)
    # the `tb_finish` launch over fused_dev, read by `finish_grants_batch`
    tb: Optional["TbFinish"] = None
    # the pinned host buffer of the eq/demap launch's descriptors, kept
    # until the batch's tb_finish output has been read
    eq_host: Optional[torch.Tensor] = None
    # the de-rate-match's table, the pinned host buffer of its words and
    # the tensors their addresses point into (maps, priors), kept the same
    derm: Optional[tuple] = None


@dataclasses.dataclass
class TbFinish:
    """One `tb_finish` launch in flight: its descriptor table, the pinned
    host buffer its descriptors were copied from (kept until `out` has
    been read), its (n_out,) uint8 output on the device, ji -> block."""
    table: tb_finish.Table
    desc_host: Optional[torch.Tensor]
    out: torch.Tensor
    tb_of: Dict[int, int]


def _launch_tb_finish(fused, table: tb_finish.Table,
                      tb_of: Dict[int, int]) -> TbFinish:
    desc_host, desc = tb_finish.upload(table, fused.device)
    out = tb_finish.finish(fused, table, desc)
    prof.count("pdsch_tb_device", table.n_tb)
    return TbFinish(table, desc_host, out, tb_of)


def _tb_results(pb: "PendingPdschBatch", tf: TbFinish, buf: np.ndarray,
                soft_buffers) -> Dict[int, PdschResult]:
    """ji -> PdschResult from a host copy `buf` of a `tb_finish` output:
    each block's status word and payload bytes; drops the HARQ soft
    buffers of blocks that passed."""
    tf.desc_host = None
    status = tf.table.status(buf)
    out = {}
    for ji, t in tf.tb_of.items():
        j, seg, st = pb.jobs[ji], pb.seg_of[ji], int(status[t])
        ok = bool(st & 1)
        if ok and soft_buffers is not None and j.harq_key is not None:
            for ci_ in range(seg.C):
                soft_buffers.pop((j.harq_key, ci_), None)
        off = tf.table.offset(t)
        out[ji] = PdschResult(
            j.rnti, j.tbs, ok, None,
            [bool(st >> (1 + r) & 1) for r in range(seg.C)], [],
            pb.n_re_of.get(ji, 0),
            payload=buf[off:off + j.tbs // 8].tobytes() if ok else None)
    return out


def _t(x, dev, dtype=torch.int64):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev,
                                                         dtype=dtype)


def dispatch_grants_batch(grids, h, noise_var, cell: CellConfig,
                          jobs: List[GrantJob],
                          soft_buffers: Optional[Dict] = None,
                          n_iter: int = 8) -> PendingPdschBatch:
    """Queue the full decode of many grants on the device; no host reads.

    Equalize/demap runs once for every grant (one `pdsch_eq` launch); the
    de-rate-match and HARQ combine of every code block from one pinned
    descriptor upload (one `cb_derm` launch per dependency round); turbo +
    CB CRC + packing once per code-block size K (the turbo kernel's
    packing entry, `_turbo_only_fn`); one `tb_finish` launch then checks
    every transport block's CRCs and writes its payload bytes.  No
    blocking upload.  Every output the host needs returns in ONE uint8
    buffer (`pb.tb.out`).
    """
    dev = grids.device
    results: List[Optional[PdschResult]] = [None] * len(jobs)
    live: List[int] = []               # jobs with REs and bits to decode
    srcs: List[tuple] = []             # their `_re_source`s
    with prof.span("pd_re_idx"):
        for ji, j in enumerate(jobs):
            src = _src_of(cell, j)
            if j.tbs <= 0 or src[0] == 0:
                results[ji] = PdschResult(j.rnti, j.tbs, False, None, [],
                                          [], 0)
                continue
            live.append(ji)
            srcs.append(src)
        n_re_of = {ji: src[0] for ji, src in zip(live, srcs)}
        if live:
            table, re_tab = _eq_table(cell, int(h.shape[2]), jobs, live,
                                      srcs, dev)
    if not live:
        return PendingPdschBatch(jobs, results, {}, [], None, n_re_of)
    # --- eq/demap of every grant: row r of rows_mat is grant live[r] -----
    rows_mat, eq_host = _eq_rows(grids, h, noise_var, table, re_tab, cell)
    pb = _dispatch_code_blocks(rows_mat, jobs, live, n_re_of, soft_buffers,
                               n_iter)
    pb.results, pb.eq_host = results, eq_host
    return pb


@prof.factory(4096)
def _cb_plan(tbs: int, G: int, qm: int) -> tuple:
    """(segmentation, ((K, F, E, window start) of each code block)) of a
    transport block of tbs bits over G bits at qm, cached: a cell
    re-issues the same sizes.  The segmentation is shared: read it only."""
    seg = turbo_mod.segment_sizes(tbs)
    es = pdsch_mod.cb_rate_match_sizes(G, seg.C, qm)
    starts = np.cumsum([0] + es[:-1]).tolist()
    return seg, tuple((K, seg.F if c == 0 else 0, E, off) for c, (K, E, off)
                      in enumerate(zip(seg.K, es, starts)))


def _dispatch_code_blocks(rows_mat, jobs: List[GrantJob], live: List[int],
                          n_re_of: Dict[int, int],
                          soft_buffers: Optional[Dict],
                          n_iter: int) -> PendingPdschBatch:
    """The code blocks of jobs `live` (job live[r]'s LLRs in row r of
    `rows_mat`, its RE count in `n_re_of`) through the de-rate-match, the
    turbo decode and `tb_finish`: one descriptor upload, one `cb_derm`
    launch per dependency round, one turbo launch per K, one `tb_finish`
    launch.  Updates `soft_buffers` (lazy references, no device ops)."""
    dev = rows_mat.device
    row_of = {ji: r for r, ji in enumerate(live)}
    # --- collect code blocks, grouped by K ------------------------------
    with prof.span("pd_collect_cb"):
        seg_of: Dict[int, object] = {}
        table = tb_finish.Table()
        tb_of: Dict[int, int] = {}
        # K -> [(ji, ci, F, E, off, rv, key, retx)]
        by_k: Dict[int, list] = {}
        for ji in live:
            j = jobs[ji]
            seg, cbs = _cb_plan(j.tbs, n_re_of[ji] * j.qm, j.qm)
            seg_of[ji] = seg
            tb_of[ji] = table.add(j.tbs, seg)
            key = j.harq_key if soft_buffers is not None else None
            for ci_, (K, F, E, off) in enumerate(cbs):
                by_k.setdefault(K, []).append(
                    (ji, ci_, F, E, off, j.rv,
                     None if key is None else (key, ci_), j.is_retx))

        # One descriptor a code block; each K's code blocks are one slab of
        # (n_K, 3, K+4) combined LLRs and one block of fused rows, in time
        # order (ji ascending).  In-batch retransmission chains: a retx
        # whose previous same-key transmission sits in THIS batch combines
        # with that code block's output, so it goes one dependency round
        # later (depth advances only across actual retx links, not mere
        # key repetition); a retx whose previous transmission is an earlier
        # batch's reads that soft buffer by address.
        derm = cb_derm.Table()
        group_rows = []
        slabs = []                 # (K, float offset, n_K, word offset)
        out_off = word_off = 0
        last_occ: Dict = {}        # key_ci -> LAST (time-ordered) (ji, ci)
        for K, rows in sorted(by_k.items()):
            Kp, Wk = K + 4, (K + 31) // 32
            rows.sort(key=lambda r: (r[0], r[1]))
            occ_prev: Dict = {}            # key_ci -> (ji, ci) of last occ.
            at: Dict[tuple, tuple] = {}    # (ji, ci) -> (slab row, depth)
            for r_i, (ji, ci_, F, E, off, rv, key, retx) in enumerate(rows):
                depth, prior = 0, None
                if retx and key is not None:
                    prev = occ_prev.get(key)
                    if prev is not None:
                        p_row, p_depth = at[prev]
                        depth = p_depth + 1
                        prior = ("out", out_off + p_row * 3 * Kp)
                    elif (key in soft_buffers
                            and tuple(soft_buffers[key].shape) == (3, Kp)):
                        # prior from an earlier batch; a K mismatch means
                        # the TBS changed -> stored soft bits invalid
                        # (reference stored-TBS rule, `HARQ.cc:71-130`)
                        prior = _buffer_value(soft_buffers[key])
                if key is not None:
                    occ_prev[key] = (ji, ci_)
                at[(ji, ci_)] = (r_i, depth)
                derm.add(row_of[ji], off, E, K, F, rv,
                         out_off + r_i * 3 * Kp, depth, prior)
                table.set_row(tb_of[ji], ci_, word_off + r_i * (1 + Wk))
            slabs.append((K, out_off, len(rows), word_off))
            group_rows.append((K, Wk, len(rows),
                               [(r[0], r[1], r[2]) for r in rows]))
            out_off += len(rows) * 3 * Kp
            word_off += len(rows) * (1 + Wk)
            for key, jici in occ_prev.items():
                last = last_occ.get(key)
                if last is None or jici[0] >= last[0]:
                    last_occ[key] = jici

    # --- one descriptor upload, one de-rate-match launch a round, one
    # turbo launch a K writing the fused rows ----------------------------
    with prof.span("pd_pos_build"):
        out = torch.empty(out_off, dtype=torch.float32, device=dev)
        fused_dev = torch.empty(word_off, dtype=torch.int64, device=dev)
        keep: list = []
        derm_host, desc = cb_derm.upload(derm, dev, out, keep)
    d_of: Dict[Tuple[int, int], LazyRow] = {}
    with prof.span("pd_turbo_call"):
        cb_derm.derm(rows_mat, derm, desc, out)
        for (K, o, n, w), (_K, _Wk, _n, items) in zip(slabs, group_rows):
            slab = out[o:o + n * 3 * (K + 4)].view(n, 3, K + 4)
            _turbo_only_fn(K, n_iter)(slab, fused_dev, w)
            for r_i, (ji, ci_, _F) in enumerate(items):
                d_of[(ji, ci_)] = LazyRow(slab, r_i)
    # the surviving HARQ soft buffer for each key is its LAST (time-ordered)
    # occurrence's combined LLRs ACROSS K groups (a mid-batch TBS change
    # must not leave a stale earlier-K buffer) — lazy refs, no device ops
    for key, jici in last_occ.items():
        soft_buffers[key] = d_of[jici]
    return PendingPdschBatch(jobs, [None] * len(jobs), seg_of, group_rows,
                             fused_dev, n_re_of, d_of=d_of,
                             tb=_launch_tb_finish(fused_dev, table, tb_of),
                             derm=(derm, derm_host, keep))


def finish_grants_batch(pb: PendingPdschBatch,
                        soft_buffers: Optional[Dict] = None,
                        site: str = "pf_d2h") -> List[PdschResult]:
    """Read the batch's `tb_finish` output (one read, counted at `site`)
    and make per-job PdschResults from each block's status word and
    payload bytes."""
    results = pb.results
    if pb.tb is None:
        return results
    with prof.span("pf_d2h"):
        buf = _host(pb.tb.out, site)     # ONE read for the whole batch
    pb.eq_host = pb.derm = None
    with prof.span("pf_assemble"):
        for ji, r in _tb_results(pb, pb.tb, buf, soft_buffers).items():
            results[ji] = r
    return results


def _gather_lazy_rows(refs: List, device):
    """Stack LazyRow references (and plain host/device arrays) into one
    (n, ...) device tensor with one gather per distinct parent."""
    by_parent: Dict[int, list] = {}
    parents: Dict[int, object] = {}
    host_items: list = []     # (order index, array)
    for i, r in enumerate(refs):
        if isinstance(r, LazyRow):
            by_parent.setdefault(id(r.arr), []).append((i, r.i))
            parents[id(r.arr)] = r.arr
        else:
            host_items.append((i, r))
    parts, order = [], []
    for pid, items in by_parent.items():
        rows = _t(np.array([it[1] for it in items], np.int64), device)
        parts.append(parents[pid][rows])
        order.extend(it[0] for it in items)
    if host_items:
        parts.append(torch.stack([torch.as_tensor(a, device=device)
                                  for _, a in host_items]))
        order.extend(i for i, _ in host_items)
    stacked = torch.cat(parts) if len(parts) > 1 else parts[0]
    inv = np.argsort(np.array(order))
    if np.array_equal(inv, np.arange(len(refs))):
        return stacked
    return stacked[_t(inv, device)]


def escalate_dispatch(pb: PendingPdschBatch, esc_idx: List[int],
                      n_iter: int):
    """Queue the iteration-escalation re-decode of CRC-failed jobs on the
    device (straight from the stored combined LLRs, no re-equalize /
    de-rate-match), then one `tb_finish` launch over the re-decoded rows.
    Returns a handle for `escalate_finish` (None if nothing to escalate)
    — the batched analog of srsRAN's per-CB early-stop under the
    reference's 12-iteration cap (`SubframeWorker.cc:365`), finished one
    pipeline phase later."""
    table = tb_finish.Table()
    tb_of: Dict[int, int] = {}
    by_k: Dict[int, list] = {}
    for ji in esc_idx:
        seg = pb.seg_of.get(ji)
        if seg is None or any((ji, ci_) not in pb.d_of
                              for ci_ in range(seg.C)):
            continue
        tb_of[ji] = table.add(pb.jobs[ji].tbs, seg)
        for ci_, K in enumerate(seg.K):
            by_k.setdefault(K, []).append((ji, ci_, pb.d_of[(ji, ci_)]))
    prof.count("pdsch_cb_escalated", sum(len(r) for r in by_k.values()))
    if not tb_of:
        return None
    dev = pb.fused_dev.device
    fused = torch.empty(sum(len(rows) * (1 + (K + 31) // 32)
                            for K, rows in by_k.items()),
                        dtype=torch.int64, device=dev)
    off = 0
    for K, rows in sorted(by_k.items()):
        Wk = (K + 31) // 32
        d = _gather_lazy_rows([r[2] for r in rows], dev)
        _turbo_only_fn(K, n_iter)(d, fused, off)
        for r_i, (ji, ci_, _) in enumerate(rows):
            table.set_row(tb_of[ji], ci_, off + r_i * (1 + Wk))
        off += len(rows) * (1 + Wk)
    return _launch_tb_finish(fused, table, tb_of)


def escalate_finish(pb: PendingPdschBatch, h,
                    soft_buffers: Optional[Dict] = None) -> int:
    """Read the escalation's `tb_finish` output (one read); apply fixed
    results to `pb.results` in place; returns the number of jobs flipped
    to CRC-ok."""
    if h is None:
        return 0
    n_fixed = 0
    buf = _host(h.out, "escalate_join")
    for ji, r2 in _tb_results(pb, h, buf, soft_buffers).items():
        if r2.crc_ok:
            pb.results[ji] = r2
            n_fixed += 1
    return n_fixed


def escalate_failures(pb: PendingPdschBatch, esc_idx: List[int],
                      n_iter: int,
                      soft_buffers: Optional[Dict] = None) -> int:
    """Synchronous dispatch+finish escalation (tests / simple callers)."""
    return escalate_finish(pb, escalate_dispatch(pb, esc_idx, n_iter),
                           soft_buffers=soft_buffers)


def decode_grants_batch(grids, h, noise_var, cell: CellConfig,
                        jobs: List[GrantJob],
                        soft_buffers: Optional[Dict] = None,
                        n_iter: int = 8) -> List[PdschResult]:
    """Decode many grants with grouped device calls (synchronous wrapper
    around `dispatch_grants_batch` + `finish_grants_batch`)."""
    pb = dispatch_grants_batch(grids, h, noise_var, cell, jobs,
                               soft_buffers=soft_buffers, n_iter=n_iter)
    return finish_grants_batch(pb, soft_buffers=soft_buffers)
