"""PUSCH decode path (torch): SC-FDMA demod -> DMRS chest -> MMSE equalize
-> DFT despread -> demap -> descramble -> de-interleave -> turbo decode.

Counterpart of `ltesniffer_tpu/sniffer/pusch_rx.py`; capability parity
with `PUSCH_Decoder::decode/decode_run` (`src/src/UL_Sniffer_PUSCH.cc:250-583`):
per-grant UL chest with TA estimation, SNR gating for statistics, valid-PRB
filtering; the 16/64/256QAM table cascade lives in the caller (core UL
mode + MCSTracking).

The per-grant math runs as torch ops on the UL grids' device, batched over
the grants of one (n_prb, qm) group (the JAX package's `vmap`); the turbo
decode goes through the main path's decoder (`kernels/turbo.make_decoder`,
the fused CUDA kernel on a card) via `pdsch_rx._derm_turbo_static_fn`,
whose UCI window places the data cells around RI / ACK / CQI.  Rows are
not padded to bucket sizes: torch runs eagerly, so the JAX package's
pow2 row padding (there to bound compiled shapes) would only add work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import crc, pdsch as pdsch_mod, ra
from ltesniffer_tpu_torch.phy import turbo as turbo_mod, uci as uci_mod
from ltesniffer_tpu_torch.phy import ul_dmrs
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import cplx, demapper, scfdma
from ltesniffer_tpu_torch.kernels.cplx import const
from . import prof
from .pdsch_rx import (LazyRow, _decode_tb_from_llrs, _derm_laps,
                       _derm_turbo_static_fn, _descramble, _gather_lazy_rows,
                       _stack_rows, _t, _turbo_only_fn)

class UlFrontend:
    """Batched UL demod: samples -> (B, RX, 14, n_sc, 2) float-pair grid on
    the input's device."""

    def __init__(self, cell: CellConfig):
        self.cell = cell

    def run_ri(self, samples_ri):
        """(B, RX, sf_len, 2) float32 samples."""
        return scfdma.demodulate_ul_ri(samples_ri, self.cell)

    def run_i8c64(self, chunk64, scales):
        """Packed-int8 ingest from the int64 carrier (`cplx.view_i64`):
        (B, RX, n/4) int64 + per-subframe scales (B,) (DL twin:
        `frontend.Frontend.run_i8c64`)."""
        p8 = chunk64.contiguous().view(torch.int8)      # (B, RX, 2n) bytes
        B = p8.shape[0]
        x = (p8.to(torch.float32).reshape(B, p8.shape[1], -1, 2)
             * scales[:, None, None, None])
        return self.run_ri(x)


@prof.factory(16)
def make_ul_frontend(cell: CellConfig) -> UlFrontend:
    return UlFrontend(cell)


@prof.factory(16)
def make_power_map(cell: CellConfig):
    """(B, RX, 14, n_sc, 2) grid -> (B, n_prb) average PRB power in dB —
    the reference's per-PRB SubframePower map (`SubframePower.cc:18-74`,
    computed on `enb_ul.sf_symbols` each UL subframe, used for UL grant
    plausibility checks and the PowerDrawASCII rendering)."""
    def run(grids):
        p = torch.sum(grids.to(torch.float32) ** 2, dim=-1)   # |x|^2
        p = torch.mean(p, dim=(1, 2))              # avg over RX, symbols
        p = p.reshape(p.shape[0], cell.n_prb, 12).mean(dim=-1)
        return 10.0 * torch.log10(torch.clamp(p, min=1e-12))

    return run


@dataclasses.dataclass
class PuschResult:
    rnti: int
    tbs: int
    crc_ok: bool
    tb_bits: Optional[np.ndarray]
    snr_db: float
    ta_us: float
    n_prb: int


@prof.factory(8)
def _time_weights() -> np.ndarray:
    """(12, 2) interpolation weights from the 2 pilot symbols to the 12
    data symbols."""
    wt = np.zeros((12, 2), dtype=np.float32)
    t0, t1 = scfdma.DMRS_SYM
    for i, l in enumerate(scfdma.DATA_SYMS):
        t = np.clip((l - t0) / (t1 - t0), 0.0, 1.0)
        wt[i] = (1.0 - t, t)
    return wt


@prof.factory(64)
def _eq_batch_ul_fn(cell: CellConfig, n_prb: int, qm: int):
    """Batched UL equalize+despread+demap for one (n_prb, qm) group.

    (grids (B,RX,14,n_sc,2), bidx (n,), k0 (n,), dmrs (n,2,m_sc,2),
     c_init (n,)) -> (llr (n, 12*m_sc*qm), snr_db (n,), ta_us (n,))

    The JAX package maps one grant's function over the rows (`vmap`);
    here every op carries the row axis.  k0 must lie in [0, n_sc - m_sc]
    (the caller clamps it, as the reference's dynamic slice does).
    """
    m_sc = 12 * n_prb
    data_syms = np.asarray(scfdma.DATA_SYMS, np.int64)
    dmrs_syms = np.asarray(scfdma.DMRS_SYM, np.int64)
    cols = np.arange(m_sc, dtype=np.int64)
    subcarrier_spacing = 15e3

    def run(grids, bidx, k0, dmrs_ri, c_init):
        dev = grids.device
        n = bidx.shape[0]
        # per-row block of m_sc subcarriers: (n, m_sc, RX, 14, 2) by one
        # gather, then (n, RX, 14, m_sc, 2)
        col = k0[:, None] + const(cols, dev)[None, :]
        block = grids[bidx[:, None], :, :, col].permute(0, 2, 3, 1, 4)
        pil = block[:, :, const(dmrs_syms, dev)]        # (n, RX, 2, m_sc, 2)
        h_ls = cplx.cmul_conj(pil, dmrs_ri[:, None])
        # 3-tap freq smoothing
        pad = torch.cat([h_ls[..., :1, :], h_ls, h_ls[..., -1:, :]], dim=-2)
        h_sm = (0.25 * pad[..., :-2, :] + 0.5 * pad[..., 1:-1, :]
                + 0.25 * pad[..., 2:, :])
        resid = h_ls - h_sm
        noise = torch.mean(cplx.cabs2(resid).reshape(n, -1), dim=1) / 0.375
        sig = torch.mean(cplx.cabs2(h_sm).reshape(n, -1), dim=1)
        snr_db = 10.0 * torch.log10(torch.clamp(sig, min=1e-12)
                                    / torch.clamp(noise, min=1e-12))
        # TA: mean phase slope across subcarriers
        prod = cplx.cmul_conj(h_sm[..., 1:, :], h_sm[..., :-1, :])
        psum = torch.sum(prod.reshape(n, -1, 2), dim=1)
        slope = torch.atan2(psum[:, 1], psum[:, 0])
        ta_us = -slope / (2.0 * np.pi * subcarrier_spacing) * 1e6
        # interpolate over symbols
        h_data = torch.einsum("nrpsc,lp->nrlsc", h_sm,
                              const(_time_weights(), dev))
        y = block[:, :, const(data_syms, dev)]           # (n, RX, 12, m_sc, 2)
        num = torch.sum(cplx.cmul_conj(y, h_data), dim=1)
        den = torch.sum(cplx.cabs2(h_data), dim=1) + noise[:, None, None]
        x_eq = cplx.cdiv_real(num, den)                  # (n, 12, m_sc, 2)
        d = scfdma.dft_deprecode_ri(x_eq, m_sc)          # (n, 12, m_sc, 2)
        llr = demapper.llr(d.reshape(n, -1, 2), qm)      # (n, 12*m_sc*qm)
        # descramble FIRST (TX order: interleave -> scramble -> modulate)
        llr = _descramble(llr, c_init, 12 * m_sc * qm)
        # channel de-interleaver: out[r*12+c] groups <- in[c*R'+r]
        de = llr.reshape(n, 12, m_sc, qm).transpose(1, 2).reshape(n, -1)
        return de, snr_db, ta_us

    return run


@prof.factory(4096)
def _dmrs_ri(n_prb: int, sf_idx: int, n_id_cell: int, cyclic_shift_cfg: int,
             dmrs_field: int) -> np.ndarray:
    """(2, m_sc, 2) float32 DMRS of one subframe's two pilot symbols."""
    return cplx.to_ri(np.stack([
        ul_dmrs.pusch_dmrs(n_prb, 2 * sf_idx + s, n_id_cell,
                           cyclic_shift_cfg, dmrs_field)
        for s in range(2)]))


def _k0(cell: CellConfig, prb_start: int, n_prb: int) -> int:
    """First subcarrier of a grant's block, clamped into the grid as the
    reference's dynamic slice clamps it."""
    return min(max(12 * prb_start, 0), cell.n_sc - 12 * n_prb)


def _eq_fn(cell: CellConfig, n_prb: int, qm: int):
    """One grant's equalize+despread+demap: the batched function on a
    single row.

    (grid (RX,14,n_sc,2), dmrs (2,m_sc,2), k0, c_init) ->
      (llr (12*m_sc*qm,), snr_db (), ta_us ())
    """
    run = _eq_batch_ul_fn(cell, n_prb, qm)

    def one(grid, dmrs_ri, k0: int, c_init: int):
        dev = grid.device
        llr, snr_db, ta_us = run(grid[None], _t([0], dev), _t([k0], dev),
                                 dmrs_ri[None], _t([c_init], dev))
        return llr[0], snr_db[0], ta_us[0]

    return one


def decode_grant_ul(ul_grid_b, cell: CellConfig, sf_idx: int, rnti: int,
                    prb_start: int, n_prb: int, qm: int, tbs: int,
                    rv: int = 0, cyclic_shift_cfg: int = 0,
                    dmrs_field: int = 0,
                    soft_buffers: Optional[Dict] = None,
                    harq_key: Optional[Tuple] = None,
                    n_ri_syms: int = 0, n_ack_syms: int = 0,
                    n_cqi_syms: int = 0,
                    n_iter: int = 8) -> PuschResult:
    """Decode one PUSCH grant from an UL subframe grid (RX, 14, n_sc, 2)
    tensor.

    n_ri_syms/n_ack_syms: UCI symbol groups (from the UE config DB + the
    DL ACK matching, reference `UL_Sniffer_PUSCH.cc:429-450`): RI cells are
    removed from the data mapping, ACK cells are zero-LLR punctures."""
    if tbs <= 0 or not ra.valid_dft_prb(n_prb):
        return PuschResult(rnti, tbs, False, None, -99.0, 0.0, n_prb)
    m_sc = 12 * n_prb
    dev = ul_grid_b.device
    dmrs = _dmrs_ri(n_prb, sf_idx, cell.n_id_cell, cyclic_shift_cfg,
                    dmrs_field)
    c_init = pdsch_mod.scrambling_cinit(rnti, 0, sf_idx, cell.n_id_cell)
    llr, snr_db, ta_us = _eq_fn(cell, n_prb, qm)(
        ul_grid_b, torch.from_numpy(dmrs).to(dev),
        _k0(cell, prb_start, n_prb), c_init)
    llr = prof.host_read("ul_grant_llr", llr).numpy()
    if n_ri_syms or n_ack_syms or n_cqi_syms:
        cells_llr = llr.reshape(m_sc * 12, qm).copy()
        _, ack_cells = uci_mod.uci_positions(m_sc, qm, n_ri_syms, n_ack_syms)
        cells_llr[ack_cells] = 0.0           # punctured by HARQ-ACK
        # CQI occupies the head of the multiplexed stream (36.212 5.2.2.8)
        data_cells = uci_mod.data_group_map(m_sc, n_ri_syms)[n_cqi_syms:]
        llr = cells_llr[data_cells].reshape(-1)
        n_re_data = 12 * m_sc - n_ri_syms - n_cqi_syms
    else:
        n_re_data = 12 * m_sc
    res = _decode_tb_from_llrs(llr, rnti, tbs, qm, rv, n_re_data,
                               soft_buffers, harq_key, n_iter, dev)
    return PuschResult(rnti, tbs, res.crc_ok, res.tb_bits,
                       float(snr_db), float(ta_us), n_prb)


# ---------------------------------------------------------------------------
# Batched multi-grant UL decoding (the main path)
#
# The reference decodes every grant of every UL subframe sequentially inside
# the worker (`UL_Sniffer_PUSCH.cc:389-583`); here all grants collected over
# a subframe batch — including the 16/64/256QAM trial variants for
# unknown-table RNTIs — dispatch as grouped device calls (one eq/demap call
# per (n_prb, qm) group, one derm+turbo call per code-block sub-group), with
# every result the host needs in one fused tensor read in finish, mirroring
# the DL path's dispatch/finish split (`pdsch_rx.dispatch_grants_batch`).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class UlGrantJob:
    b: int                      # subframe index into the UL grid batch
    sf_idx: int
    rnti: int
    prb_start: int
    n_prb: int
    qm: int
    tbs: int
    rv: int = 0
    cyclic_shift_cfg: int = 0
    dmrs_field: int = 0
    n_ri_syms: int = 0
    n_ack_syms: int = 0
    n_cqi_syms: int = 0     # aperiodic CQI occupies the data stream's head
    tag: object = None


@dataclasses.dataclass
class PendingUlBatch:
    jobs: list
    results: list                      # pre-filled for degenerate jobs
    seg_of: Dict[int, object]
    group_rows: list                   # [(K, Wk, n, [(ji, ci)...])]
    # flat int64 device tensor: the (n_rows, 2) float32 [snr_db, ta_us]
    # scalars as bit patterns, then per-sub-group (n, 1+Wk) row blocks
    fused_dev: object
    n_scal: int                        # eq rows (scalar pairs) in fused_dev
    scalar_row: Dict[int, int]
    # (ji, ci) -> LazyRow into the combined-LLR outputs: CRC failures
    # re-decode from these at a higher turbo iteration count in finish
    # (the DL path's iteration-escalation scheme)
    d_of: Dict[Tuple[int, int], object] = dataclasses.field(
        default_factory=dict)


def _scalar_bits(scalars):
    """(n, 2) float32 -> (2n,) int64 words holding the float32 bit
    patterns (rides the int64 result tensor; the host undoes it with
    uint32 -> float32 views)."""
    return scalars.contiguous().view(torch.int32).reshape(-1).to(torch.int64)


def dispatch_grants_ul_batch(ul_grids, cell: CellConfig,
                             jobs: List[UlGrantJob],
                             n_iter: int = 8) -> PendingUlBatch:
    """Queue the grouped device decode of many UL grants; no host reads."""
    dev = ul_grids.device
    results: List[Optional[PuschResult]] = [None] * len(jobs)
    groups: Dict[Tuple[int, int], list] = {}
    for ji, j in enumerate(jobs):
        if j.tbs <= 0 or not ra.valid_dft_prb(j.n_prb):
            results[ji] = PuschResult(j.rnti, j.tbs, False, None, -99.0,
                                      0.0, j.n_prb)
            continue
        groups.setdefault((j.n_prb, j.qm), []).append(ji)
    eq_outs = []
    scalar_parts = []
    scalar_row: Dict[int, int] = {}
    row_of: Dict[int, int] = {}
    row_acc = 0
    for (n_prb, qm), jis in sorted(groups.items()):
        G = len(jis)
        bidx = np.zeros(G, np.int64)
        k0 = np.zeros(G, np.int64)
        cinit = np.zeros(G, np.int64)
        dmrs = np.empty((G, 2, 12 * n_prb, 2), np.float32)
        for row, ji in enumerate(jis):
            j = jobs[ji]
            bidx[row] = j.b
            k0[row] = _k0(cell, j.prb_start, n_prb)
            cinit[row] = pdsch_mod.scrambling_cinit(j.rnti, 0, j.sf_idx,
                                                    cell.n_id_cell)
            dmrs[row] = _dmrs_ri(n_prb, j.sf_idx, cell.n_id_cell,
                                 j.cyclic_shift_cfg, j.dmrs_field)
            row_of[ji] = scalar_row[ji] = row_acc + row
        fn = _eq_batch_ul_fn(cell, n_prb, qm)
        with prof.span("pu_eqdemap_call"):
            llr, snr_db, ta_us = fn(ul_grids, _t(bidx, dev), _t(k0, dev),
                                    _t(dmrs, dev, torch.float32),
                                    _t(cinit, dev))
        eq_outs.append(llr)
        scalar_parts.append(torch.stack([snr_db, ta_us], dim=-1))
        row_acc += G
    if not eq_outs:
        return PendingUlBatch(jobs, results, {}, [], None, 0, scalar_row)
    scalars = torch.cat(scalar_parts) if len(scalar_parts) > 1 \
        else scalar_parts[0]
    Wm = max(int(o.shape[1]) for o in eq_outs)
    rows_mat = _stack_rows(eq_outs, Wm)

    # --- collect code blocks grouped by K -------------------------------
    seg_of: Dict[int, object] = {}
    by_k: Dict[int, list] = {}
    for (n_prb, qm), jis in sorted(groups.items()):
        m_sc = 12 * n_prb
        for ji in jis:
            j = jobs[ji]
            has_uci = bool(j.n_ri_syms or j.n_ack_syms or j.n_cqi_syms)
            n_re_data = (12 * m_sc - j.n_ri_syms - j.n_cqi_syms
                         if has_uci else 12 * m_sc)
            seg = turbo_mod.segment_sizes(j.tbs)
            seg_of[ji] = seg
            es = pdsch_mod.cb_rate_match_sizes(n_re_data * qm, seg.C, qm)
            off = 0
            for ci_, (K, E) in enumerate(zip(seg.K, es)):
                F = seg.F if ci_ == 0 else 0
                # UCI data-cell maps are constant per key (rare UL shapes,
                # the offset folded in); the contiguous window takes the
                # offset as an argument, so one map serves every block
                src_key = (("uci", m_sc, qm, j.n_ri_syms, j.n_ack_syms,
                            j.n_cqi_syms, off) if has_uci else ("lin",))
                by_k.setdefault(K, []).append(
                    (ji, ci_, F, E, j.rv, src_key, off))
                off += E

    group_rows = []
    fused_parts = [_scalar_bits(scalars)]
    d_of: Dict[Tuple[int, int], LazyRow] = {}
    for K, rows in sorted(by_k.items()):
        Wk = (K + 31) // 32
        # sub-group by (F, laps, rv, src, off): one call per sub-group
        subs: Dict[tuple, list] = {}
        for r in rows:
            subs.setdefault((r[2], _derm_laps(K, r[2], r[3]), r[4], r[5],
                             r[6]), []).append(r)
        for (F, laps, rv, src_key, off), sub in sorted(subs.items()):
            rows_idx = np.array([row_of[r[0]] for r in sub], np.int64)
            e_true = np.array([r[3] for r in sub], np.int64)
            fn = _derm_turbo_static_fn(K, F, laps, rv, n_iter, src_key)
            with prof.span("pu_turbo_call"):
                fused, d = fn(rows_mat, _t(rows_idx, dev), _t(e_true, dev),
                              off)
            for r_i, r in enumerate(sub):
                d_of[(r[0], r[1])] = LazyRow(d, r_i)
            fused_parts.append(fused)
            group_rows.append((K, Wk, len(sub), [(r[0], r[1]) for r in sub]))
    return PendingUlBatch(jobs, results, seg_of, group_rows,
                          torch.cat(fused_parts), int(scalars.shape[0]),
                          scalar_row, d_of=d_of)


def _unpack_bits(words: np.ndarray, K: int) -> np.ndarray:
    """(n, Wk) uint32 packed words -> (n, K) uint8 bits."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((words[:, :, None] >> shifts) & 1).astype(np.uint8)
    return bits.reshape(words.shape[0], -1)[:, :K]


def finish_grants_ul_batch(pb: PendingUlBatch, n_iter_esc: int = 0):
    """Read the fused result tensor (one device -> host read); assemble
    PuschResults.

    n_iter_esc > 0: CRC failures whose grant has no passing table variant
    re-decode straight from the stored combined LLRs at this (higher)
    turbo iteration count — the DL path's escalation scheme (srsRAN-style
    per-CB early stop, batched; reference cap `SubframeWorker.cc:365`)."""
    jobs, results = pb.jobs, pb.results
    if pb.fused_dev is None:
        return results
    with prof.span("pu_d2h"):
        host = prof.host_read("pu_d2h", pb.fused_dev).numpy().astype(
            np.uint32)
    with prof.span("pu_assemble"):
        scal = host[:2 * pb.n_scal].view(np.float32).reshape(pb.n_scal, 2)
        bits_of: Dict[Tuple[int, int], np.ndarray] = {}
        rem_of: Dict[Tuple[int, int], int] = {}
        r0 = 2 * pb.n_scal
        for K, Wk, n, rows in pb.group_rows:
            sub = host[r0:r0 + n * (1 + Wk)].reshape(n, 1 + Wk)
            r0 += n * (1 + Wk)
            bits = _unpack_bits(sub[:, 1:], K)
            for r_i, key in enumerate(rows):
                bits_of[key] = bits[r_i]
                rem_of[key] = int(sub[r_i, 0])

        def result(ji, tb_ok, tb_with_crc):
            j = jobs[ji]
            sr = pb.scalar_row[ji]
            return PuschResult(
                j.rnti, j.tbs, bool(tb_ok),
                tb_with_crc[:j.tbs] if tb_ok else None,
                float(scal[sr, 0]), float(scal[sr, 1]), j.n_prb)

        def assemble(ji):
            seg = pb.seg_of[ji]
            cb_ok, parts = [], []
            for ci_, K in enumerate(seg.K):
                blk = bits_of[(ji, ci_)]
                F = seg.F if ci_ == 0 else 0
                if seg.C > 1:
                    cb_ok.append(rem_of[(ji, ci_)] == 0)
                    parts.append(blk[F:K - turbo_mod.SEG_CRC])
                else:
                    parts.append(blk[F:])
            tb_with_crc = np.concatenate(parts)[:seg.B]
            tb_ok = (all(cb_ok)
                     and crc.crc_bits(tb_with_crc, crc.CRC24A).sum() == 0)
            return result(ji, tb_ok, tb_with_crc)

        todo = [ji for ji in range(len(jobs))
                if results[ji] is None and ji in pb.seg_of]
        # single-code-block TBs (the common case) take a batched host CRC24A
        # (one matmul per (K, F, B) family), as the DL batch does
        singles: Dict[tuple, list] = {}
        for ji in todo:
            seg = pb.seg_of[ji]
            if seg.C == 1:
                singles.setdefault((seg.K[0], seg.F, seg.B), []).append(ji)
            else:
                results[ji] = assemble(ji)
        for (K, F, Bb), jis in singles.items():
            tbw = np.stack([bits_of[(ji, 0)] for ji in jis])[:, F:F + Bb]
            ok = crc.batched_crc_np(tbw, crc.CRC24A).sum(axis=1) == 0
            for r_i, ji in enumerate(jis):
                results[ji] = result(ji, ok[r_i], tbw[r_i])
    if n_iter_esc > 0:
        # escalate only grants where NO table variant passed (a sibling
        # variant's CRC pass means the failure is a wrong-table trial)
        gi_ok = {jobs[ji].tag["gi"] for ji in todo
                 if results[ji].crc_ok and isinstance(jobs[ji].tag, dict)
                 and "gi" in jobs[ji].tag}
        esc = [ji for ji in todo if not results[ji].crc_ok
               and not (isinstance(jobs[ji].tag, dict)
                        and jobs[ji].tag.get("gi") in gi_ok)]
        by_k: Dict[int, list] = {}
        for ji in esc:
            for ci_, K in enumerate(pb.seg_of[ji].K):
                ref = pb.d_of.get((ji, ci_))
                if ref is not None:
                    by_k.setdefault(K, []).append((ji, ci_, ref))
        if by_k:
            with prof.span("pu_escalate"):
                dev = pb.fused_dev.device
                for K, rows in sorted(by_k.items()):
                    d = _gather_lazy_rows([r[2] for r in rows], dev)
                    fused = _turbo_only_fn(K, n_iter_esc)(d)
                    fused = prof.host_read("pu_escalate",
                                           fused).numpy().astype(np.uint32)
                    bits = _unpack_bits(fused[:, 1:], K)
                    for r_i, (ji, ci_, _ref) in enumerate(rows):
                        bits_of[(ji, ci_)] = bits[r_i]
                        rem_of[(ji, ci_)] = int(fused[r_i, 0])
            for ji in esc:
                r2 = assemble(ji)
                if r2.crc_ok:
                    results[ji] = r2
    return results
