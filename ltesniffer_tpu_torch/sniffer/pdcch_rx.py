"""Batched device-side PDCCH blind-decode pipeline (torch).

Counterpart of `ltesniffer_tpu/sniffer/pdcch_rx.py`.  Where the reference
walks the CCE tree sequentially, decoding candidates on demand
(`src/src/DCISearch.cc:449-528`), this pipeline decodes *every* location at
*every* payload size for a whole batch of subframes in one pass:

  grids/h -> PDCCH RE gather -> SFBC/port0 equalize -> QPSK LLRs ->
  per-CCE power -> {every payload size D: de-rate-match -> ONE batched
  Viterbi -> payload bits + CRC-XOR RNTIs -> packed host words}

The tail after the per-CCE power runs on the card as two kernel launches
(`kernels/pdcch_tail.py`: the Viterbi's search entry with the de-rate-
match folded into it, `pdcch_pack`), on the CPU as the plain torch chain.

The host-side acceptance resolver (`dci_search.py`) then replays the
reference's sequential pruning semantics over these precomputed results.
The packed `cand_fused` word layout equals the JAX package's word for word.

Two searches: `make_unified_search` (the core's: the CFI rides as data)
and the fixed-CFI search (`make_pipeline`, `make_search_from_grids`:
the sharded path and the tests), which also returns every payload size's
bits and RNTIs.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import conv, dci as dci_mod, grid as grid_mod
from ltesniffer_tpu_torch.phy import search_space
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import chest, demapper, ofdm, pdcch_tail
from ltesniffer_tpu_torch.kernels.cplx import const, to_ri


@functools.lru_cache(maxsize=16)
def _static_maps(cell: CellConfig, cfi: int):
    """All constant index maps for one (cell, cfi)."""
    reg = grid_mod.control_region(cell, cfi)
    nof_cce = reg["nof_pdcch_regs"] // 9
    gather_idx = grid_mod.pdcch_llr_gather_index(cell, cfi)     # (4*m_quad,)
    locs = search_space.all_locations(nof_cce)                   # ((l, ncce)..)
    sizes = dci_mod.format_sizes(cell)
    # distinct payload sizes -> formats sharing them
    by_size: Dict[int, list] = {}
    for f in dci_mod.FORMATS:
        by_size.setdefault(sizes[f] + 16, []).append(f)   # D includes CRC16
    # per size D: candidate LLR gather (n_loc, E_max) + de-RM matmul (E_max, 3D)
    size_maps = {}
    for D, fmts in sorted(by_size.items()):
        cand_gather = []
        cand_mats = []
        for (l, ncce) in locs:
            E = 72 * (1 << l)
            g = 72 * ncce + np.arange(E, dtype=np.int64)
            maps = conv.rate_match_maps(D, E)
            W = np.zeros((E, 3 * D), dtype=np.float32)
            W[np.arange(E), maps["e_to_d"]] = 1.0
            cand_gather.append(g)
            cand_mats.append(W)
        size_maps[D] = {"formats": tuple(fmts), "gather": cand_gather,
                        "mats": cand_mats}
    return {
        "nof_cce": nof_cce,
        "gather_idx": gather_idx,
        "locs": locs,
        "sizes": sizes,
        "size_maps": size_maps,
        "size_order": tuple(sorted(by_size.keys())),
        "n_sc": cell.n_sc,
    }


def _candidate_decode_tail(llr, cce_power, size_consts, n_loc: int, B: int,
                           scalars=None, full: bool = True) -> dict:
    """Shared tail of the blind search: de-rate-match every payload size,
    ONE Viterbi call over all (size x location x subframe) candidates,
    CRC-XOR RNTIs, and the fused host word matrix (meta | payload words |
    cce power) whose single host read covers resolve + payloads.  On the
    card two kernel launches (`kernels/pdcch_tail.py`: the Viterbi's
    search entry, `pdcch_pack`), on the CPU the plain torch chain.

    Returns cand_fused (B, W) int32 and, with `full`, per payload size D
    bits_{D} (B, n_loc, D) uint8 and rnti_{D} (B, n_loc), cand_meta
    (B, n_loc, S) [rnti | bit0 << 16] and cand_pay (B, n_loc, S, 2) (u32
    payload words)."""
    return pdcch_tail.decode_tail(llr, cce_power, size_consts, n_loc, B,
                                  scalars, full)


def unpack_fused(fused: np.ndarray, n_loc: int, S: int, nof_cce: int,
                 with_scalars: bool = False, with_payloads: bool = False):
    """Host-side inverse of the packed candidate transfer: returns
    (cand_meta (B, n_loc, S) int32 [rnti | bit0<<16], cce_power (B,
    nof_cce) float32[, scalars (B, 4) float32 when the producer folded
    the frontend cfi/snr/cfo/rsrp columns in][, pay (B, n_loc, S, 2)
    uint32 packed payload words])."""
    m = n_loc * S
    mp2 = (m + 1) // 2
    mbw = -(-m // 32)
    ncw = (nof_cce + 1) // 2
    B = fused.shape[0]
    r_packed = fused[:, :mp2].view(np.uint32)
    rnti = np.empty((B, 2 * mp2), np.uint32)
    rnti[:, 0::2] = r_packed & 0xFFFF
    rnti[:, 1::2] = r_packed >> 16
    b_packed = fused[:, mp2:mp2 + mbw].view(np.uint32)
    bits = ((b_packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    bit0 = bits.reshape(B, -1)[:, :m]
    meta = (rnti[:, :m] | (bit0 << 16)).astype(np.int32)
    c_packed = fused[:, mp2 + mbw:mp2 + mbw + ncw].view(np.uint32)
    c16 = np.empty((B, 2 * ncw), np.uint16)
    c16[:, 0::2] = c_packed & 0xFFFF
    c16[:, 1::2] = c_packed >> 16
    cce = c16.view(np.float16)[:, :nof_cce].astype(np.float32)
    out = [meta.reshape(B, n_loc, S), cce]
    base = mp2 + mbw + ncw
    if with_scalars:
        s_packed = fused[:, base:base + 2].view(np.uint32)
        s16 = np.empty((B, 4), np.uint16)
        s16[:, 0::2] = s_packed & 0xFFFF
        s16[:, 1::2] = s_packed >> 16
        out.append(s16.view(np.float16).astype(np.float32))
        base += 2
    if with_payloads:
        out.append(fused[:, base:base + 2 * m].view(np.uint32)
                   .reshape(B, n_loc, S, 2))
    return tuple(out)


def _size_consts_of(st):
    """Per payload size D: {aggregation level: (loc sel, flat llr gather,
    de-RM matmul)} — grouped so every gather in the batch has uniform
    shape — with the search's locations (`pdcch_tail.SizeConsts`)."""
    locs = st["locs"]
    lvl_of = np.array([l for (l, _) in locs])
    size_consts = {}
    for D, m in st["size_maps"].items():
        per_lvl = {}
        for l in range(4):
            sel = np.nonzero(lvl_of == l)[0]
            if len(sel) == 0:
                continue
            g = np.stack([m["gather"][i] for i in sel]).astype(np.int64)
            W = m["mats"][sel[0]]                                 # same for all
            per_lvl[l] = (sel.astype(np.int64), g.reshape(-1), W)
        size_consts[D] = per_lvl
    return pdcch_tail.SizeConsts(size_consts, locs)


@functools.lru_cache(maxsize=8)
def make_unified_search(cell: CellConfig):
    """Blind search handling any per-subframe CFI as data: RE-gather
    tables and scrambling-sign masks for cfi 1..3 are stacked constants
    indexed by a per-subframe cfi_idx, the location list is the cfi=3
    superset, and stream bits beyond a subframe's actual control region get
    sign 0 -> zero LLRs -> zero CCE power, so the host resolver's power
    gate (+ explicit span check) rejects them.

    Returns (run_from_grids(grids, h, noise_var, snr_db, sf_idx, cfi_idx,
    scalars=None) -> dict with "cand_fused", static maps)."""
    st3 = _static_maps(cell, 3)
    n_loc = len(st3["locs"])
    nof_cce3 = st3["nof_cce"]
    M = len(st3["gather_idx"])
    n_bits_tot = 8 * (M // 4)
    gidx = np.zeros((3, M), np.int64)
    sign_mask = np.zeros((3, n_bits_tot), np.float32)
    nof_cce_of = []
    for c in (1, 2, 3):
        stc = _static_maps(cell, c)
        gc = stc["gather_idx"].astype(np.int64)
        gidx[c - 1, :len(gc)] = gc
        sign_mask[c - 1, :8 * (len(gc) // 4)] = 1.0
        nof_cce_of.append(stc["nof_cce"])
    # scrambling: c_init depends only on (sf, cell), so the cfi=3-length
    # sequence is a prefix-superset of every cfi's sequence
    scr_j = np.stack([
        1.0 - 2.0 * grid_mod.pdcch_scrambling(cell, sf, n_bits_tot)
        for sf in range(10)]).astype(np.float32)              # (10, n_bits)
    size_consts = _size_consts_of(st3)
    n_ports = cell.nof_ports

    def run_from_grids(grids, h, noise_var, snr_db, sf_idx, cfi_idx,
                       scalars=None):
        dev = grids.device
        B = grids.shape[0]
        gflat = grids.reshape(B, grids.shape[1], -1, 2)
        hflat = h.reshape(B, h.shape[1], h.shape[2], -1, 2)
        # per-subframe RE table row (cfi rides as data)
        idx = const(gidx, dev)[cfi_idx]                       # (B, M)
        y = torch.gather(gflat, 2, idx[:, None, :, None].expand(
            B, gflat.shape[1], M, 2))                         # (B, RX, M, 2)
        hh = torch.gather(hflat, 3, idx[:, None, None, :, None].expand(
            B, hflat.shape[1], hflat.shape[2], M, 2))         # (B,RX,P,M,2)
        x = chest.equalize_ports(y, hh, noise_var, n_ports)   # (B, M)
        signs = (const(scr_j, dev)[sf_idx]
                 * const(sign_mask, dev)[cfi_idx])            # (B, n_bits)
        llr = demapper.qpsk_llr(x) * signs
        cce_power = torch.mean(
            torch.abs(llr[:, :72 * nof_cce3]).reshape(B, nof_cce3, 72),
            dim=-1)
        # the core reads cand_fused alone: no per-size bits or words
        return {"cand_fused": _candidate_decode_tail(
            llr, cce_power, size_consts, n_loc, B, scalars=scalars,
            full=False)["cand_fused"]}

    st = dict(st3)
    st["nof_cce_of"] = tuple(nof_cce_of)
    return run_from_grids, st


def unpack_payload(words: np.ndarray, d_payload: int) -> np.ndarray:
    """(2,) u32 words -> (d_payload,) uint8 bit array (LSB-first packing)."""
    w = np.asarray(words, dtype=np.uint32)
    bits = ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)
    return bits.reshape(-1)[:d_payload]


@functools.lru_cache(maxsize=16)
def _build_pipeline(cell: CellConfig, cfi: int):
    """The fixed-CFI blind search, for callers that know the CFI (the
    sharded path, tests): every subframe of the batch is searched with
    cfi's control region.

    run(samples (B, RX, sf_len) complex or (B, RX, sf_len, 2) float
    pairs, sf_idx (B,), device="cuda") -> dict of snr_db (B,), noise_var
    (B,), cce_power (B, nof_cce), cfo (B,) zeros, grids, h, and per
    payload size D: bits_{D} (B, n_loc, D) uint8, rnti_{D} (B, n_loc)
    int32; cand_meta (B, n_loc, S) int32, cand_pay (B, n_loc, S, 2) int32
    (the u32 payload words' bit patterns), cand_fused (B, W) int32.
    from_grids: the same outputs, fed by the shared frontend; tensors on
    the grids' device.
    """
    st = _static_maps(cell, cfi)
    nof_cce = st["nof_cce"]
    n_loc = len(st["locs"])
    gather_idx = st["gather_idx"].astype(np.int64)
    # full PDCCH stream length incl. NIL-padded tail quadruplets
    n_bits_tot = 8 * (len(gather_idx) // 4)
    # descrambling signs per subframe index (+1 for bit 0, -1 for bit 1)
    scr_j = np.stack([
        1.0 - 2.0 * grid_mod.pdcch_scrambling(cell, sf, n_bits_tot)
        for sf in range(10)]).astype(np.float32)          # (10, n_bits)
    size_consts = _size_consts_of(st)
    n_ports = cell.nof_ports

    def from_grids(grids, h, noise_var, snr_db, sf_idx):
        dev = grids.device
        B = grids.shape[0]
        gflat = grids.reshape(B, grids.shape[1], -1, 2)
        hflat = h.reshape(B, h.shape[1], h.shape[2], -1, 2)
        gi = const(gather_idx, dev)
        y = gflat[:, :, gi, :]                                # (B,RX,M,2)
        hh = hflat[:, :, :, gi, :]                            # (B,RX,P,M,2)
        x = chest.equalize_ports(y, hh, noise_var, n_ports)   # (B, M)
        llr = demapper.qpsk_llr(x) * const(scr_j, dev)[sf_idx]
        cce_power = torch.mean(
            torch.abs(llr[:, :72 * nof_cce]).reshape(B, nof_cce, 72),
            dim=-1)                                           # (B, nof_cce)
        out = {"snr_db": snr_db, "noise_var": noise_var,
               "cce_power": cce_power,
               "cfo": torch.zeros((B,), dtype=torch.float32, device=dev),
               "grids": grids, "h": h}   # reused by the PDSCH phase
        tail = _candidate_decode_tail(llr, cce_power, size_consts, n_loc,
                                      B)
        for k, v in tail.items():            # the reference's int32 words
            if k == "cand_pay":
                v = pdcch_tail.u32_to_i32(v)
            elif not k.startswith("bits"):
                v = v.to(torch.int32)
            out[k] = v
        return out

    def run_ri(samples_ri, sf_idx):
        grids = ofdm.demodulate_ri(samples_ri, cell)   # (B,RX,14,n_sc,2)
        ch = chest.estimate(grids, sf_idx, cell)
        return from_grids(grids, ch["h"], ch["noise_var"], ch["snr_db"],
                          sf_idx)

    def run(samples, sf_idx, device="cuda"):
        if isinstance(samples, torch.Tensor):
            x = samples
        else:
            x = np.asarray(samples)
            x = torch.from_numpy(to_ri(x) if np.iscomplexobj(x) else
                                 np.ascontiguousarray(x, np.float32))
        sf = torch.as_tensor(np.asarray(sf_idx), dtype=torch.int64)
        return run_ri(x.to(device), sf.to(device))

    return {"run": run, "from_grids": from_grids, "st": st}


def make_pipeline(cell: CellConfig, cfi: int):
    """(run(samples, sf_idx, device="cuda"), static maps) — see
    `_build_pipeline`."""
    b = _build_pipeline(cell, cfi)
    return b["run"], b["st"]


def make_search_from_grids(cell: CellConfig, cfi: int):
    """(run(grids, h, noise_var, snr_db, sf_idx), static maps) for use after
    the shared frontend (`frontend.make_frontend`)."""
    b = _build_pipeline(cell, cfi)
    return b["from_grids"], b["st"]
