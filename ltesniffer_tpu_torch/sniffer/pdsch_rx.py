"""PDSCH decode path: equalize -> demap -> descramble -> de-rate-match ->
turbo decode -> CRC, with HARQ soft combining (torch).

Counterpart of `ltesniffer_tpu/sniffer/pdsch_rx.py`: single-layer grants
(TM1 port 0, TM2 SFBC) through the batched main path, and two-codeword
spatial multiplexing (TM3 CDD, TM4 closed loop) through
`decode_grant_mimo`; capability parity with the reference's
`PDSCH_Decoder::decode_dl_mode` (`src/src/DL_Sniffer_PDSCH.cc:881-1291`):
per-DCI decode, softbuffer reuse for retransmissions, dual-table retry
handled by the caller (MCSTracking).

The per-RE math (gather/equalize/demap/descramble via the Gold-basis
matmul) and the turbo decoder run as torch ops on the grids' device; the
thin glue (segmentation sizes, scatter positions, TB CRC) is NumPy on the
host.  Integer words that the JAX package keeps as uint32 are int64 here
(torch's uint32 has little CUDA support) and become uint32 on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import crc, pdsch as pdsch_mod, sequences, turbo as turbo_mod
from ltesniffer_tpu_torch.phy import uci as uci_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import chest, demapper, turbo as kturbo
from ltesniffer_tpu_torch.kernels.cplx import const
from ltesniffer_tpu_torch.sniffer import prof

RE_BUCKET = 256
_W32 = (1 << np.arange(32, dtype=np.int64))


def _bucket(n: int) -> int:
    return -(-n // RE_BUCKET) * RE_BUCKET


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_u32(x) -> np.ndarray:
    """int64 device words holding u32 values -> host uint32."""
    return x.cpu().numpy().astype(np.uint32)


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


def _descramble(llr, c_init, n_bits: int):
    """llr (..., n_bits) * (1 - 2 * gold(c_init)) for c_init (...,)."""
    scr = sequences.gold_sequence_torch(c_init, n_bits)
    return llr * (1.0 - 2.0 * scr.to(torch.float32))


@functools.lru_cache(maxsize=64)
def _eq_demap_fn(cell: CellConfig, qm: int, n_re_pad: int, n_ports: int):
    """One grant's REs -> descrambled LLRs.

    (grid_flat (RX, L, 2), h_flat (RX, P, L, 2), noise 0-d, re_idx
     (n_re_pad,) int64, c_init 0-d int64, pa float) -> llr (n_re_pad * qm,)

    pa: linear PDSCH-to-CRS amplitude ratio 10^(p_a/20) from the UE's
    dedicated config (`MCSTracking.cc:1446-1529` stores p_a; applied here
    as a scale on the CRS-derived channel estimate)."""
    def run(grid_flat, h_flat, noise_var, re_idx, c_init, pa: float):
        y = grid_flat[:, re_idx, :][None]                  # (1, RX, n, 2)
        hh = h_flat[:, :, re_idx, :][None] * float(np.float32(pa))
        nv = noise_var.reshape(1)
        x = chest.equalize_ports(y, hh, nv, n_ports)[0]
        llr = demapper.llr(x, qm)                          # (n*qm,)
        return _descramble(llr, c_init, n_re_pad * qm)

    return run


@dataclasses.dataclass
class PdschResult:
    rnti: int
    tbs: int
    crc_ok: bool
    tb_bits: Optional[np.ndarray]       # payload without TB CRC (on success)
    cb_crc_ok: List[bool]
    d_llrs: List[np.ndarray]            # per-CB (3, K+4) combined LLRs
    n_re: int = 0


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
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask,
                                        prb_mask_slot1)
    n_re = len(re_idx)
    G = n_re * qm
    if tbs <= 0 or n_re == 0:
        return PdschResult(rnti, tbs, False, None, [], [], n_re)
    dev = grids.device
    n_pad = _bucket(n_re)
    idx = np.full(n_pad, re_idx[-1], dtype=np.int64)
    idx[:n_re] = re_idx
    c_init = pdsch_mod.scrambling_cinit(rnti, 0, sf_idx, cell.n_id_cell)

    fn = _eq_demap_fn(cell, qm, n_pad, cell.nof_ports)
    gflat = grids[b].reshape(grids.shape[1], -1, 2)
    hflat = h[b].reshape(h.shape[1], h.shape[2], -1, 2)
    llr = _host(fn(gflat, hflat, noise_var[b],
                   torch.from_numpy(idx).to(dev),
                   torch.tensor(c_init, dtype=torch.int64, device=dev),
                   pa))[:G]
    return _decode_tb_from_llrs(llr, rnti, tbs, qm, rv, n_re, soft_buffers,
                                harq_key, n_iter, dev)


# ---------------------------------------------------------------------------
# Spatial multiplexing (TM3/TM4): two codewords over two layers
# ---------------------------------------------------------------------------
# host reads of the two-codeword path: one for both codewords' LLRs, one
# for the decided bits of each code-block size
HOST_READS = {"mimo": 0}


@functools.lru_cache(maxsize=64)
def _eq_demap_mimo_fn(cell: CellConfig, qm0: int, qm1: int, n_re_pad: int,
                      tm: int, pmi: int):
    """2-layer equalize + per-codeword demap/descramble.

    (grid_flat (RX, L, 2), h_flat (RX, P, L, 2), noise 0-d, re_idx
     (n_re_pad,) int64, c_init0 / c_init1 0-d int64) -> [llr0, llr1]"""
    from ltesniffer_tpu_torch.kernels import mimo as mimo_mod

    def run(grid_flat, h_flat, noise_var, re_idx, c_init0, c_init1):
        y = grid_flat[:, re_idx, :][None]            # (1, RX, n, 2)
        hh = h_flat[:, :, re_idx, :][None]           # (1, RX, P, n, 2)
        nv = noise_var.reshape(1)
        if tm == 4:
            he = mimo_mod.effective_channel_tm4(hh, pmi, 2)
        else:
            he = mimo_mod.effective_channel_tm3(hh)
        x = mimo_mod.mmse_2layer(y, he, nv)[0]       # (2, n, 2)
        return [_descramble(demapper.llr(x[q], qm), ci, n_re_pad * qm)
                for q, (qm, ci) in enumerate(((qm0, c_init0),
                                              (qm1, c_init1)))]

    return run


def decode_grant_mimo(grids, h, noise_var, b: int, cell: CellConfig,
                      sf_idx: int, cfi: int, rnti: int, prb_mask: np.ndarray,
                      qms, tbss, tm: int, pmi: int = 0, rvs=(0, 0),
                      soft_buffers=None, harq_keys=(None, None),
                      n_iter: int = 8):
    """Decode a 2-codeword spatial-multiplexed grant.  Returns per-codeword
    PdschResult list (capability parity: `DL_Sniffer_PDSCH.cc` TM3/TM4 path).

    Both codewords' LLRs come to the host in one read; their code blocks
    are decoded together, one decoder call (and one read) per code-block
    size — each block decodes on its own, so the bits are those of two
    separate decodes."""
    re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, prb_mask)
    n_re = len(re_idx)
    dev = grids.device
    n_pad = _bucket(n_re)
    idx = np.full(n_pad, re_idx[-1], dtype=np.int64)
    idx[:n_re] = re_idx
    ci = [pdsch_mod.scrambling_cinit(rnti, q, sf_idx, cell.n_id_cell)
          for q in (0, 1)]
    fn = _eq_demap_mimo_fn(cell, qms[0], qms[1], n_pad, tm, pmi)
    gflat = grids[b].reshape(grids.shape[1], -1, 2)
    hflat = h[b].reshape(h.shape[1], h.shape[2], -1, 2)
    llrs = fn(gflat, hflat, noise_var[b], torch.from_numpy(idx).to(dev),
              *(torch.tensor(c, dtype=torch.int64, device=dev) for c in ci))
    both = _host(torch.cat(llrs))
    cw = [both[:len(llrs[0])], both[len(llrs[0]):]]
    segs = [_derm_cbs(cw[q][:n_re * qms[q]], tbss[q], qms[q], rvs[q], n_re,
                      soft_buffers, harq_keys[q]) for q in (0, 1)]
    bits = _decode_cbs([d for seg in segs if seg is not None
                        for d in seg[1]], n_iter, dev)
    HOST_READS["mimo"] += 1 + len({d.shape for seg in segs
                                   if seg is not None for d in seg[1]})
    results = []
    for q in (0, 1):
        if segs[q] is None:
            results.append(PdschResult(rnti, tbss[q], False, None, [], [],
                                       n_re))
            continue
        seg, d_llrs = segs[q]
        blocks, bits = bits[:seg.C], bits[seg.C:]
        results.append(_finish_tb(seg, blocks, d_llrs, rnti, tbss[q], n_re,
                                  soft_buffers, harq_keys[q]))
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
                d = _host(_buffer_value(prev)) + d
            soft_buffers[(harq_key, ci_)] = d
            d = d.copy()
        d_llrs.append(d)
    return seg, d_llrs


def _decode_cbs(d_llrs, n_iter, device) -> List[np.ndarray]:
    """Turbo-decode (3, K+4) code blocks: one decoder call per code-block
    size on `device`; returns each block's (K,) hard bits on the host."""
    by_k = {}
    for c, d in enumerate(d_llrs):
        by_k.setdefault(d.shape[1] - 4, []).append(c)
    bits_per_cb = [None] * len(d_llrs)
    for K, cis in by_k.items():
        batch = torch.from_numpy(np.stack([d_llrs[c] for c in cis])).to(device)
        bits, _ = kturbo.make_decoder(K, n_iter)(batch)
        bits = _host(bits)
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


_RE_TAB_CACHE: Dict[tuple, np.ndarray] = {}


def _re_tab(cell: CellConfig, n_pad: int, combos: tuple) -> np.ndarray:
    """Unique grant-RE index tables for one eq/demap group.

    combos: tuple of (sf_idx, cfi, prb_mask bytes, slot1 bytes|None).
    Returns (U, n_pad) int64 (tail positions clamp to the last RE).  A
    loaded cell re-issues the same allocations every frame, so the tables
    are cached (and uploaded once per device through `const`)."""
    key = (cell, n_pad, combos)
    tab = _RE_TAB_CACHE.get(key)
    if tab is None:
        tab = np.zeros((len(combos), n_pad), np.int64)
        for u, (sf_idx, cfi, mb, s1b) in enumerate(combos):
            mask = np.frombuffer(mb, dtype=bool)
            s1 = None if s1b is None else np.frombuffer(s1b, dtype=bool)
            re_idx = pdsch_mod.grant_re_indices(cell, sf_idx, cfi, mask, s1)
            tab[u, :len(re_idx)] = re_idx
            tab[u, len(re_idx):] = re_idx[-1]
        if len(_RE_TAB_CACHE) > 512:
            _RE_TAB_CACHE.clear()
        _RE_TAB_CACHE[key] = tab
    return tab


@functools.lru_cache(maxsize=64)
def _eq_demap_batch_fn(cell: CellConfig, qm: int, n_re_pad: int,
                       n_ports: int):
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
        return _descramble(llr, c_init, n_re_pad * qm)

    return run


@functools.lru_cache(maxsize=16)
def _center_prbs(cell: CellConfig) -> frozenset:
    """PRBs overlapping the center 6 RBs (PBCH/PSS/SSS puncture zone)."""
    lo = cell.n_sc // 2 - 36
    hi = cell.n_sc // 2 + 36
    return frozenset(p for p in range(cell.n_prb)
                     if 12 * p < hi and 12 * p + 12 > lo)


def _reorg(cell: CellConfig, grids, h):
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


@functools.lru_cache(maxsize=256)
def _eq_demap_prb_fn(cell: CellConfig, qm: int, n_prb: int, cfi: int,
                     n_ports: int):
    """Fast-path eq/demap for one (qm, n_prb, cfi) group: PRB-block gather
    + constant data-RE compress + equalize + demap + descramble.

    Applies to grants whose RE pattern is sf-independent (no PBCH/PSS/SSS
    center-PRB puncture, single slot mask) — the common case on a loaded
    cell.  The RE selection within the (14, n_prb, 12) PRB window is a
    constant (the CRS pattern has period 6, so it is uniform across PRBs);
    only the PRB list rides as data.

    (Xg, Xh, noise_var (B,), bidx (G,), prbi (G, n_prb), c_init (G,),
     pa (G,)) -> llr (G, n_pad*qm)
    """
    res = pdsch_mod.reserved_re_mask(cell, 1, cfi)   # sf 1: no center puncture
    data_sc = [np.nonzero(~res[l, :12])[0] for l in range(14)]
    n_re = sum(n_prb * len(data_sc[l]) for l in range(cfi, 14))
    n_pad = _bucket(n_re)
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
        return _descramble(llr, c_init, n_pad * qm)

    return run, n_pad


def _stack_rows(eq_outs: List, Wm: int):
    """Stack per-group eq/demap outputs into one (T, Wm) rows matrix
    (zero-padded columns; padded tails are masked out by e_true)."""
    parts = [o if int(o.shape[1]) == Wm
             else torch.nn.functional.pad(o, (0, Wm - int(o.shape[1])))
             for o in eq_outs]
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


@functools.lru_cache(maxsize=512)
def _derm_static_maps(K: int, F: int):
    """Static circular-buffer structure for one (K, F):

    nonnull_pos: (L,) w-positions that carry transmitted bits (NULL pads and
    filler positions excluded), in cyclic order;
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
    L = len(nonnull_pos)
    INVP = np.full(3 * Kp, L, np.int64)
    INVP[m["w_src"][nonnull_pos]] = np.arange(L, dtype=np.int64)
    return nonnull_pos, INVP, L


def _derm_laps(K: int, F: int, E: int) -> int:
    """Number of circular-buffer laps the selection of E bits spans."""
    _, _, L = _derm_static_maps(K, F)
    return max(1, -(-E // L))


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


@functools.lru_cache(maxsize=512)
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


@functools.lru_cache(maxsize=512)
def _derm_turbo_static_fn(K: int, F: int, laps: int, rv: int, n_iter: int,
                          src_key: tuple = ("lin",)):
    """Finisher for one code-block-size group: window select +
    de-rate-match + filler LLRs + (HARQ prior add) + turbo decode + CB
    CRC24B + bit packing.

    The de-rate-match runs as constant index maps (fold the E LLRs over
    circular-buffer laps -> rotate by the rv start -> inverse sub-block
    permutation).  The exact E and each row's bit offset ride as data.

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
    Kp = K + 4
    nonnull_pos, INVP, L = _derm_static_maps(K, F)
    k0 = turbo_mod.rv_start(K, rv)
    s0 = int(np.searchsorted(nonnull_pos, k0)) % L
    EB = laps * L
    lin = src_key[0] == "lin"
    if not lin:
        SRC, SRC_OK = _uci_src_map(EB, src_key)
    dec = kturbo.make_decoder(K, n_iter)

    def run(rows_mat, rows, e_true, off: int, prior=None):
        dev = rows_mat.device
        n = rows.shape[0]
        win = rows_mat[rows]                              # (n, Wm)
        ok = torch.arange(EB, device=dev)[None, :] < e_true[:, None]
        if lin:
            winp = torch.nn.functional.pad(win, (0, EB))
            off = max(0, min(int(off), winp.shape[1] - EB))  # clamped slice
            x = winp[:, off:off + EB]
        else:
            x = win[:, const(SRC, dev)]                   # (n, EB)
            ok = ok & const(SRC_OK, dev)[None, :]
        x = torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=dev))
        f = x.reshape(n, laps, L).sum(dim=1) if laps > 1 else x
        acc = torch.roll(f, s0, dims=1)
        accp = torch.nn.functional.pad(acc, (0, 1))       # rank L -> 0.0
        d = accp[:, const(INVP, dev)].reshape(n, 3, Kp)
        if F:
            d[:, :2, :F] = 1e4       # fillers: known zeros
        if prior is not None:
            d = d + prior
        bits, _ = dec(d)                                  # (n, K) u8
        return _crc_pack(bits, K).reshape(-1), d

    return run


@functools.lru_cache(maxsize=64)
def _turbo_only_fn(K: int, n_iter: int):
    """Iteration-escalation retry: decode directly from stored (n, 3, K+4)
    combined LLRs (no re-equalize / de-rate-match) at a higher iteration
    count — the batched analog of srsRAN's per-CB early stop (primary pass
    runs few iterations; only CRC failures pay for more)."""
    dec = kturbo.make_decoder(K, n_iter)

    def run(d):
        bits, _ = dec(d)
        return _crc_pack(bits, K)

    return run


@dataclasses.dataclass
class PendingPdschBatch:
    """In-flight device decode: `dispatch_grants_batch` output, finished by
    `finish_grants_batch` (one pipeline phase later, so the device queue
    stays busy while the host works)."""
    jobs: List[GrantJob]
    results: List[Optional[PdschResult]]
    seg_of: Dict[int, object]
    group_rows: list          # [(K, Wk, n_b, [(ji, ci, F), ...]), ...]
    fused_dev: object         # flat int64 device tensor: per-group (n, 1+Wk)
                              # row blocks concatenated
    n_re_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    # (ji, ci) -> LazyRow into the dispatch's combined-LLR outputs, kept for
    # the iteration-escalation retry (decode failures re-run at higher
    # n_iter straight from these, skipping equalize/de-rate-match)
    d_of: Dict[Tuple[int, int], object] = dataclasses.field(
        default_factory=dict)


def _t(x, dev, dtype=torch.int64):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev,
                                                         dtype=dtype)


def dispatch_grants_batch(grids, h, noise_var, cell: CellConfig,
                          jobs: List[GrantJob],
                          soft_buffers: Optional[Dict] = None,
                          n_iter: int = 8) -> PendingPdschBatch:
    """Queue the full decode of many grants on the device; no host reads.

    Equalize/demap runs once per (qm, RE-bucket) group; de-rate-match +
    HARQ combine + turbo + CB CRC + packing run per code-block size K.
    Every output the host needs returns in ONE fused int64 tensor.
    """
    dev = grids.device
    results: List[Optional[PdschResult]] = [None] * len(jobs)
    meta = []
    groups: Dict[Tuple[int, int], List[int]] = {}
    fast_groups: Dict[Tuple[int, int, int], List[int]] = {}
    center = _center_prbs(cell)
    _t0 = prof.time.perf_counter()
    for ji, j in enumerate(jobs):
        re_idx = pdsch_mod.grant_re_indices(cell, j.sf_idx, j.cfi,
                                            j.prb_mask, j.prb_mask_slot1)
        meta.append(re_idx)
        if j.tbs <= 0 or len(re_idx) == 0:
            results[ji] = PdschResult(j.rnti, j.tbs, False, None, [], [], 0)
            continue
        n_prb = int(np.count_nonzero(j.prb_mask))
        # fast path: sf-independent RE pattern (no center-PRB puncture,
        # one slot mask) -> PRB-block gather with constant RE compress
        if (j.prb_mask_slot1 is None
                and not (j.sf_idx in (0, 5)
                         and any(j.prb_mask[p] for p in center))):
            fast_groups.setdefault((j.qm, n_prb, j.cfi), []).append(ji)
        else:
            groups.setdefault((j.qm, _bucket(len(re_idx))), []).append(ji)
    prof.add("pd_re_idx", prof.time.perf_counter() - _t0)
    gflat = grids.reshape(grids.shape[0], grids.shape[1], -1, 2)
    hflat = h.reshape(h.shape[0], h.shape[1], h.shape[2], -1, 2)
    # --- eq/demap per group; outputs stay on device --------------------
    eq_outs = []                       # (G, n_pad*qm) device tensors
    row_of: Dict[int, int] = {}        # ji -> row in the stacked rows matrix
    row_acc = 0
    if fast_groups:
        Xg, Xh = _reorg(cell, grids, h)
    for (qm, n_prb, cfi), jis in fast_groups.items():
        fn, n_pad = _eq_demap_prb_fn(cell, qm, n_prb, cfi, cell.nof_ports)
        G = len(jis)
        bidx = np.zeros(G, np.int64)
        prbi = np.zeros((G, n_prb), np.int64)
        cinit = np.zeros(G, np.int64)
        pa = np.ones(G, np.float32)
        for row, ji in enumerate(jis):
            j = jobs[ji]
            bidx[row] = j.b
            prbi[row] = np.nonzero(j.prb_mask)[0]
            cinit[row] = pdsch_mod.scrambling_cinit(j.rnti, 0, j.sf_idx,
                                                    cell.n_id_cell)
            pa[row] = j.pa
            row_of[ji] = row_acc + row
        with prof.span("pd_eqdemap_call"):
            out = fn(Xg, Xh, noise_var, _t(bidx, dev), _t(prbi, dev),
                     _t(cinit, dev), _t(pa, dev, torch.float32))
        eq_outs.append(out)
        row_acc += G
    for (qm, n_pad), jis in groups.items():
        G = len(jis)
        bidx = np.array([jobs[ji].b for ji in jis], np.int64)
        u_idx = np.zeros(G, np.int64)
        cinit = np.zeros(G, np.int64)
        pa = np.ones(G, np.float32)
        combo_rows: list = []
        u_of: Dict[tuple, int] = {}
        for row, ji in enumerate(jis):
            j = jobs[ji]
            combo = (j.sf_idx, j.cfi, j.prb_mask.tobytes(),
                     None if j.prb_mask_slot1 is None
                     else j.prb_mask_slot1.tobytes())
            u = u_of.get(combo)
            if u is None:
                u = u_of[combo] = len(combo_rows)
                combo_rows.append(combo)
            u_idx[row] = u
            cinit[row] = pdsch_mod.scrambling_cinit(j.rnti, 0, j.sf_idx,
                                                    cell.n_id_cell)
            pa[row] = j.pa
            row_of[ji] = row_acc + row
        re_tab = const(_re_tab(cell, n_pad, tuple(combo_rows)), dev)
        fn = _eq_demap_batch_fn(cell, qm, n_pad, cell.nof_ports)
        with prof.span("pd_eqdemap_call"):
            out = fn(gflat, hflat, noise_var, _t(bidx, dev), _t(u_idx, dev),
                     re_tab, _t(cinit, dev), _t(pa, dev, torch.float32))
        eq_outs.append(out)
        row_acc += G
    n_re_of = {ji: len(meta[ji]) for ji in range(len(jobs))
               if results[ji] is None}
    if not eq_outs:
        return PendingPdschBatch(jobs, results, {}, [], None, n_re_of)
    # one rows matrix: row_of[ji] holds that grant's LLR stream
    Wm = max(int(o.shape[1]) for o in eq_outs)
    rows_mat = _stack_rows(eq_outs, Wm)

    # --- collect code blocks, grouped by K ------------------------------
    _t1 = prof.time.perf_counter()
    seg_of: Dict[int, object] = {}
    by_k: Dict[int, list] = {}     # K -> [(ji, ci, F, E, off, rv, key, rt)]
    all_job_groups = ([(k[0], jis) for k, jis in fast_groups.items()]
                      + [(k[0], jis) for k, jis in groups.items()])
    for qm, jis in all_job_groups:
        for ji in jis:
            j = jobs[ji]
            Gbits = len(meta[ji]) * qm
            seg = turbo_mod.segment_sizes(j.tbs)
            seg_of[ji] = seg
            es = pdsch_mod.cb_rate_match_sizes(Gbits, seg.C, j.qm)
            off = 0
            for ci_, (K, E) in enumerate(zip(seg.K, es)):
                F = seg.F if ci_ == 0 else 0
                key_ci = ((j.harq_key, ci_)
                          if soft_buffers is not None and j.harq_key is not None
                          else None)
                by_k.setdefault(K, []).append(
                    (ji, ci_, F, E, off, j.rv, key_ci, j.is_retx))
                off += E

    prof.add("pd_collect_cb", prof.time.perf_counter() - _t1)
    # --- per-K device dispatch -------------------------------------------
    group_rows = []
    fused_parts = []               # flat 1-D segments, one per sub-group
    d_of: Dict[Tuple[int, int], LazyRow] = {}
    last_occ: Dict = {}            # key_ci -> LAST (time-ordered) (ji, ci)
    for K, rows in sorted(by_k.items()):
        Wk = (K + 31) // 32
        # time order (ji ascending): the in-batch retx chaining below walks
        # occurrences sequentially, and rows arrive grouped by eq-group
        rows.sort(key=lambda r: (r[0], r[1]))
        # In-batch retransmission chains: a retx whose previous same-key
        # transmission sits in THIS batch must combine with that row's
        # output.  Rows split into dependency-DEPTH rounds (depth advances
        # only across actual retx links, not mere key repetition), and each
        # chained row's prior is taken from its explicit predecessor row
        # (d_of LazyRow) rather than a mid-dispatch buffer store.
        occ_prev: Dict = {}            # key_ci -> (ji, ci) of last occurrence
        depth_of: Dict[tuple, int] = {}
        prior_src: Dict[int, tuple] = {}   # id(row) -> ("row",(ji,ci)) | ("buf",key)
        rounds: List[list] = []
        for r in rows:
            key = r[6]
            d_ = 0
            if r[7] and key is not None:
                prev = occ_prev.get(key)
                if prev is not None:
                    d_ = depth_of[prev] + 1
                    prior_src[id(r)] = ("row", prev)
                elif (key in soft_buffers
                        and tuple(soft_buffers[key].shape) == (3, K + 4)):
                    # prior from an earlier batch; a K mismatch means the
                    # TBS changed -> stored soft bits invalid (reference
                    # stored-TBS rule, `HARQ.cc:71-130`)
                    prior_src[id(r)] = ("buf", key)
            if key is not None:
                occ_prev[key] = (r[0], r[1])
                depth_of[(r[0], r[1])] = d_
            while len(rounds) <= d_:
                rounds.append([])
            rounds[d_].append(r)

        for rnd in rounds:
            # sub-group by (prior-class, F, laps, rv, off)
            subs: Dict[tuple, list] = {}
            for r in rnd:
                skey = (id(r) in prior_src, r[2],
                        _derm_laps(K, r[2], r[3]), r[5], r[4])
                subs.setdefault(skey, []).append(r)
            for (has_prior, F, laps, rv, off), sub in sorted(
                    subs.items(), key=lambda kv: kv[0][1:]):
                n_b = len(sub)
                _t2 = prof.time.perf_counter()
                rows_idx = np.zeros(n_b, np.int64)
                e_true = np.zeros(n_b, np.int64)
                priors = []
                for r_i, (ji, ci_, _F, E, _off, _rv, key_ci, _rt) \
                        in enumerate(sub):
                    rows_idx[r_i] = row_of[ji]
                    e_true[r_i] = E
                    if has_prior:
                        kind, ref = prior_src[id(sub[r_i])]
                        priors.append(d_of[ref] if kind == "row"
                                      else soft_buffers[ref])
                prof.add("pd_pos_build", prof.time.perf_counter() - _t2)
                fn = _derm_turbo_static_fn(K, F, laps, rv, n_iter)
                with prof.span("pd_turbo_call"):
                    prior = (_gather_lazy_rows(priors, dev) if has_prior
                             else None)
                    fused, d = fn(rows_mat, _t(rows_idx, dev),
                                  _t(e_true, dev), off, prior)
                for r_i, (ji, ci_, _F, E, _off, _rv, key_ci, _rt) \
                        in enumerate(sub):
                    d_of[(ji, ci_)] = LazyRow(d, r_i)
                fused_parts.append(fused)
                group_rows.append((K, Wk, n_b,
                                   [(r[0], r[1], r[2]) for r in sub]))
        for key, jici in occ_prev.items():
            last = last_occ.get(key)
            if last is None or jici[0] >= last[0]:
                last_occ[key] = jici
    # the surviving HARQ soft buffer for each key is its LAST (time-ordered)
    # occurrence's combined LLRs ACROSS K groups (a mid-batch TBS change
    # must not leave a stale earlier-K buffer) — lazy refs, no device ops
    for key, jici in last_occ.items():
        soft_buffers[key] = d_of[jici]
    fused_dev = (torch.cat(fused_parts) if len(fused_parts) > 1
                 else fused_parts[0]) if fused_parts else None
    return PendingPdschBatch(jobs, results, seg_of, group_rows, fused_dev,
                             n_re_of, d_of=d_of)


def finish_grants_batch(pb: PendingPdschBatch,
                        soft_buffers: Optional[Dict] = None
                        ) -> List[PdschResult]:
    """Read the fused result words and assemble per-job PdschResults
    (TB CRC24A + reassembly on host; MAC payloads need host bits anyway)."""
    jobs, results = pb.jobs, pb.results
    if pb.fused_dev is None:
        return results
    with prof.span("pf_d2h"):
        host = _host_u32(pb.fused_dev)        # ONE read for the whole batch
    _t3 = prof.time.perf_counter()
    bits_of: Dict[Tuple[int, int], np.ndarray] = {}
    rem_of: Dict[Tuple[int, int], int] = {}
    shifts = np.arange(32, dtype=np.uint32)
    r0 = 0
    for K, Wk, n_b, rows in pb.group_rows:
        n = len(rows)
        w = 1 + Wk
        sub = host[r0:r0 + n_b * w].reshape(n_b, w)[:n]
        r0 += n_b * w
        packed = sub[:, 1:1 + Wk]
        bits = ((packed[:, :, None] >> shifts) & 1).astype(np.uint8)
        bits = bits.reshape(n, Wk * 32)[:, :K]
        for r_i, (ji, ci_, F) in enumerate(rows):
            bits_of[(ji, ci_)] = bits[r_i]
            rem_of[(ji, ci_)] = int(sub[r_i, 0])
    # single-code-block TBs (the common case) take a BATCHED host CRC24A:
    # one f32 matmul per (K, F, tbs) family instead of a per-TB python loop
    singles: Dict[tuple, list] = {}
    for ji, j in enumerate(jobs):
        if results[ji] is not None or ji not in pb.seg_of:
            continue
        seg = pb.seg_of[ji]
        if seg.C == 1:
            singles.setdefault((seg.K[0], seg.F, seg.B, j.tbs),
                               []).append(ji)
        else:
            results[ji] = _assemble_tb(pb, ji, bits_of, rem_of,
                                       soft_buffers)
    for (K, F, Bb, tbs), jis in singles.items():
        blks = np.stack([bits_of[(ji, 0)] for ji in jis])
        tbw = blks[:, F:F + Bb]
        ok = crc.batched_crc_np(tbw, crc.CRC24A).sum(axis=1) == 0
        for r_i, ji in enumerate(jis):
            j = jobs[ji]
            tb_ok = bool(ok[r_i])
            if tb_ok and soft_buffers is not None and j.harq_key is not None:
                soft_buffers.pop((j.harq_key, 0), None)
            results[ji] = PdschResult(
                j.rnti, j.tbs, tb_ok,
                tbw[r_i, :tbs] if tb_ok else None, [True], [],
                pb.n_re_of.get(ji, 0))
    prof.add("pf_assemble", prof.time.perf_counter() - _t3)
    return results


def _assemble_tb(pb: PendingPdschBatch, ji: int, bits_of, rem_of,
                 soft_buffers) -> PdschResult:
    """Reassemble one job's transport block from per-CB hard bits + CB CRC
    remainders; TB CRC24A on host; pop HARQ buffers on success."""
    j = pb.jobs[ji]
    seg = pb.seg_of[ji]
    cb_ok, parts = [], []
    for ci_, K in enumerate(seg.K):
        blk = bits_of[(ji, ci_)]
        F = seg.F if ci_ == 0 else 0
        if seg.C > 1:
            ok = rem_of[(ji, ci_)] == 0
            data = blk[F:K - turbo_mod.SEG_CRC]
        else:
            ok = True
            data = blk[F:]
        cb_ok.append(bool(ok))
        parts.append(data)
    tb_with_crc = np.concatenate(parts)[:seg.B]
    tb_ok = (all(cb_ok)
             and crc.crc_bits(tb_with_crc, crc.CRC24A).sum() == 0)
    tb_bits = tb_with_crc[:j.tbs] if tb_ok else None
    if tb_ok and soft_buffers is not None and j.harq_key is not None:
        for ci_ in range(seg.C):
            soft_buffers.pop((j.harq_key, ci_), None)
    return PdschResult(j.rnti, j.tbs, bool(tb_ok), tb_bits,
                       cb_ok, [], pb.n_re_of.get(ji, 0))


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
    de-rate-match).  Returns a handle for `escalate_finish` (None if
    nothing to escalate) — the batched analog of srsRAN's per-CB
    early-stop under the reference's 12-iteration cap
    (`SubframeWorker.cc:365`), finished one pipeline phase later."""
    by_k: Dict[int, list] = {}
    for ji in esc_idx:
        seg = pb.seg_of.get(ji)
        if seg is None:
            continue
        for ci_, K in enumerate(seg.K):
            ref = pb.d_of.get((ji, ci_))
            if ref is not None:
                by_k.setdefault(K, []).append((ji, ci_, ref))
    pend = []
    for K, rows in sorted(by_k.items()):
        d = _gather_lazy_rows([r[2] for r in rows], pb.fused_dev.device)
        pend.append((K, rows, _turbo_only_fn(K, n_iter)(d)))
    if not pend:
        return None
    return {"pend": pend, "esc_idx": list(esc_idx)}


def escalate_finish(pb: PendingPdschBatch, h,
                    soft_buffers: Optional[Dict] = None) -> int:
    """Read the escalation results; apply fixed results to `pb.results`
    in place; returns the number of jobs flipped to CRC-ok."""
    if h is None:
        return 0
    bits_of: Dict[Tuple[int, int], np.ndarray] = {}
    rem_of: Dict[Tuple[int, int], int] = {}
    shifts = np.arange(32, dtype=np.uint32)
    for K, rows, fused in h["pend"]:
        host = _host_u32(fused)[:len(rows)]
        Wk = (K + 31) // 32
        packed = host[:, 1:1 + Wk]
        bits = ((packed[:, :, None] >> shifts) & 1).astype(np.uint8)
        bits = bits.reshape(len(rows), Wk * 32)[:, :K]
        for r_i, (ji, ci_, _) in enumerate(rows):
            bits_of[(ji, ci_)] = bits[r_i]
            rem_of[(ji, ci_)] = int(host[r_i, 0])
    n_fixed = 0
    for ji in h["esc_idx"]:
        if ji not in pb.seg_of:
            continue
        if any((ji, ci_) not in bits_of
               for ci_ in range(pb.seg_of[ji].C)):
            continue
        r2 = _assemble_tb(pb, ji, bits_of, rem_of, soft_buffers)
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
