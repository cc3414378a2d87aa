"""The blind search's candidate tail: the hand-written CUDA kernels
around and inside the Viterbi, and their plain torch versions.

Counterpart of the tail of the JAX package's jitted search program,
`ltesniffer_tpu/sniffer/pdcch_rx.py:71 _candidate_decode_tail` (XLA inside
`:257 run_from_grids`' jit, no `pallas_call`): de-rate-match every payload
size of every location (`:81-87`), one Viterbi call, then the CRC-XOR
RNTIs, the payload words and the packed `cand_fused` row (`:89-149`).

`decode_tail` runs, for CUDA tensors, two launches and no host-to-device
copy: the Viterbi's search entry (`viterbi.viterbi_search_cuda`,
`csrc/viterbi_tb.cu`: the de-rate-match folded into its LLR staging, and
each codeword's two payload words and rnti | bit 0 << 16 written after
its traceback) and `pdcch_pack` (`csrc/pdcch_tail.cu`: the RNTIs, bit-0
bitmap, f16 CCE powers and scalars and payload words of the fused row
from those words, and on request the per-candidate RNTI, meta and payload
words).  `full=False` skips the per-candidate words and every size's u8
bits: the unified search reads `cand_fused` alone.  The sources are built with nvcc at first use into
`ltesniffer_tpu_torch/_build/` by `nvcc_build`; the tables
(`derm_tables_t`, `loc_table`, `crc_words`) are uploaded once per device.

`decode_tail_three` is the earlier route, kept as the fold's yardstick:
`pdcch_derm` (every size's (B n_loc, 3, D) LLRs into one buffer, 37 MB
at the 20 MHz cell), the Viterbi's plain entry on views of that buffer,
`pdcch_crc_pack` (the same row from the u8 bits).  For CPU tensors
`decode_tail` runs the plain version, the torch chain the port ran before
(`derm_plain`: a gather, an einsum against the 0/1 de-rate-match matrix
and a scatter per size and level; `crc_pack_plain`: the matmul CRC and
the shifts and sums of the packing; ~230 CUDA kernels and 30 copies a
call on an H100).  `route_plain` models the two-launch route in plain
torch (`search_plain`: `derm_plain`, the plain Viterbi, `compact_plain`;
then `pack_plain`).  `LAUNCHES[...]` counts kernel launches (the search
entry's in `viterbi.LAUNCHES["viterbi_search"]`) and `PLAIN_CUDA[...]`
plain versions run on a CUDA tensor (only a comparison with the kernels
does that).

Float order of the de-rate-match: each stream position's repetitions
are summed from +0 in increasing e, in blocks of KBLOCK e-offsets whose
partial sums are added in order -- the order the plain version's einsum
takes on the host (MKL's sgemm sums K = 576 as two blocks of 288), so the
kernel equals the plain version there bit for bit.  cuBLAS picks its
order by shape, so on the card the two may differ in the last bits of a
sum of three or more repetitions (`chip_smoke.py` phase 2d counts them).

What bounds the kernels on the card: the search entry operations
(`search_bytes`, `search_ops`), the packs and `pdcch_derm` bytes
(`words_bytes`, `pack_bytes`, `derm_bytes`); see the notes at the top of
the sources.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import conv, crc
from . import nvcc_build, viterbi
from .cplx import const

SRC = os.path.join(nvcc_build.CSRC, "pdcch_tail.cu")

LAUNCHES = {"pdcch_derm": 0, "pdcch_crc_pack": 0, "pdcch_pack": 0}
PLAIN_CUDA = {"pdcch_derm": 0, "pdcch_crc_pack": 0, "pdcch_pack": 0,
              "viterbi_search": 0}

MAX_SIZES = 8           # payload sizes a launch takes (the .cu's kMaxSizes)
CRC_LEN = 64            # payload bits the CRC table covers (kCrcLen): the
                        # two payload words of unpack_fused's layout
KBLOCK = 288            # e-offsets summed apart (MKL's K-block at K = 576)
LEVELS = 4

_W16 = np.array([1 << (15 - i) for i in range(16)], np.int64)
_W32 = (1 << np.arange(32, dtype=np.int64))


def reset_launches():
    for d in (LAUNCHES, PLAIN_CUDA):
        for k in d:
            d[k] = 0


class SizeConsts(dict):
    """Per payload size D: {aggregation level: (location indices, flat LLR
    gather, 0/1 de-rate-match matrix)} -- the plain version's constants --
    with the search's location list `locs` ((level, ncce) each), from
    which the kernels' tables come."""

    def __init__(self, items, locs):
        super().__init__(items)
        self.locs = tuple(locs)


# ---------------------------------------------------------------------------
# helpers of the plain version
# ---------------------------------------------------------------------------
def u32_to_i32(x):
    """Reinterpret int64 values holding u32 words as int32 (two's
    complement), explicitly: torch's uint32 has little CUDA support.
    int32 input is returned as it is."""
    if x.dtype == torch.int32:
        return x
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _pack_pairs16(v):
    """(B, m) int64 16-bit values -> (B, ceil(m/2)) u32 words (low | high
    << 16), in int64."""
    m = v.shape[1]
    if m & 1:
        v = torch.nn.functional.pad(v, (0, 1))
    return v[:, 0::2] | (v[:, 1::2] << 16)


def _f16_bits(x):
    """float32 -> float16 (round to nearest even) bit patterns, int64."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


# ---------------------------------------------------------------------------
# the plain version: the torch chain, op for op as the JAX program
# ---------------------------------------------------------------------------
def derm_plain(llr, size_consts, n_loc: int, B: int) -> list:
    """Plain version of `pdcch_derm` (torch ops, any device): every payload
    size's (B * n_loc, 3, D) de-rate-matched LLRs, one tensor per size."""
    dev = llr.device
    if dev.type == "cuda":
        PLAIN_CUDA["pdcch_derm"] += 1
    flats = []
    for D, per_lvl in size_consts.items():
        d_llrs = torch.zeros((B, n_loc, 3 * D), dtype=torch.float32,
                             device=dev)
        for l, (sel, g, W) in per_lvl.items():
            cand = llr[:, const(g, dev)].reshape(B, len(sel), -1)
            d = torch.einsum("bne,ek->bnk", cand, const(W, dev))
            d_llrs[:, const(sel, dev)] = d
        # e_to_d maps into stream-major (3, D) flat layout
        flats.append(d_llrs.reshape(B * n_loc, 3, D))
    return flats


def crc_pack_plain(all_bits, cce_power, ds, n_loc: int, B: int,
                   scalars=None) -> dict:
    """Plain version of `pdcch_crc_pack` (torch ops, any device): from each
    payload size's (B * n_loc, D) Viterbi bits, bits_{D} (B, n_loc, D)
    uint8 and rnti_{D} (B, n_loc) int64; cand_meta (B, n_loc, S) int64
    [rnti | bit0 << 16]; cand_pay (B, n_loc, S, 2) int64 (u32 payload
    words); cand_fused (B, W) int32."""
    dev = cce_power.device
    if dev.type == "cuda":
        PLAIN_CUDA["pdcch_crc_pack"] += 1
    w16 = const(_W16, dev)
    w32 = const(_W32, dev)
    out = {}
    metas = []
    pays = []
    for D, bits in zip(ds, all_bits):
        bits = bits.reshape(B, n_loc, D)
        payload = bits[..., :D - 16]
        calc = crc.batched_crc_to_int(payload, crc.CRC16)
        rx16 = torch.sum(bits[..., D - 16:].to(torch.int64) * w16, dim=-1)
        rnti = calc ^ rx16
        out[f"bits_{D}"] = bits
        out[f"rnti_{D}"] = rnti
        # candidate meta word: rnti (16 bit) | payload bit0 << 16 — all
        # the host resolver needs pre-acceptance (0/1A flag per
        # `falcon_pdcch.c:146-152`)
        metas.append(rnti | (payload[..., 0].to(torch.int64) << 16))
        # packed payload words (u32 values in int64)
        pad = torch.nn.functional.pad(payload, (0, 64 - (D - 16)))
        pays.append(torch.sum(pad.reshape(B, n_loc, 2, 32).to(torch.int64)
                              * w32, dim=-1))
    cand_meta = out["cand_meta"] = torch.stack(metas, dim=-1)
    cand_pay = out["cand_pay"] = torch.stack(pays, dim=-2)  # (B,n_loc,S,2)
    out["cand_fused"] = _fused_row(cand_meta, cand_pay, cce_power, scalars)
    return out


def _fused_row(cand_meta, cand_pay, cce_power, scalars):
    """The packed `cand_fused` row (B, W) int32 from the (B, n_loc, S)
    meta words and (B, n_loc, S, 2) payload words (u32 values in int64)."""
    B, n_loc, S = cand_meta.shape
    w32 = const(_W32, cce_power.device)
    # the fused host transfer is PACKED tight: RNTIs two per word, the
    # format-0/1A discriminator bits as a bitmap, CCE powers as f16
    # pairs.  `unpack_fused` reverses all of it.
    m = n_loc * S
    meta_flat = cand_meta.reshape(B, -1)                # (B, n_loc*S)
    r_packed = _pack_pairs16(meta_flat & 0xFFFF)        # (B, mp/2)
    bit0 = (meta_flat >> 16) & 1
    mb = -(-m // 32) * 32
    b0 = torch.nn.functional.pad(bit0, (0, mb - m))
    b_packed = torch.sum(b0.reshape(B, -1, 32) * w32, dim=-1)
    c_packed = _pack_pairs16(_f16_bits(cce_power))
    parts = [r_packed, b_packed, c_packed]
    if scalars is not None:
        # frontend per-subframe scalars (cfi/snr/cfo/rsrp) fold into the
        # SAME transfer
        parts.append(_pack_pairs16(_f16_bits(scalars)))    # (B, 2)
    parts.append(cand_pay.reshape(B, -1))                   # (B, m*2)
    return u32_to_i32(torch.cat(parts, dim=1))


def decode_tail_plain(llr, cce_power, size_consts, n_loc: int, B: int,
                      scalars=None) -> dict:
    """Plain version of `decode_tail`: `derm_plain`, ONE Viterbi call over
    all (size x location x subframe) candidates, `crc_pack_plain`."""
    flats = derm_plain(llr, size_consts, n_loc, B)
    all_bits = viterbi.viterbi_decode_tb_multi(flats)
    return crc_pack_plain(all_bits, cce_power, tuple(size_consts), n_loc, B,
                          scalars)


def compact_plain(all_bits) -> torch.Tensor:
    """Plain version of the Viterbi search entry's epilogue: from each
    payload size's (N, D) bits, (S, N, 3) int32 holding the u32 words
    payload bits 0-31, payload bits 32-63 (LSB first, as `crc_pack_plain`
    packs them) and rnti | bit 0 << 16."""
    dev = all_bits[0].device
    w16 = const(_W16, dev)
    w32 = const(_W32, dev)
    words = []
    for bits in all_bits:
        N, D = bits.shape
        payload = bits[:, :D - 16]
        rnti = crc.batched_crc_to_int(payload, crc.CRC16) ^ torch.sum(
            bits[:, D - 16:].to(torch.int64) * w16, dim=-1)
        pad = torch.nn.functional.pad(payload, (0, 64 - (D - 16)))
        pay = torch.sum(pad.reshape(N, 2, 32).to(torch.int64) * w32, dim=-1)
        meta = rnti | (payload[:, 0].to(torch.int64) << 16)
        words.append(torch.cat([pay, meta[:, None]], dim=1))
    return u32_to_i32(torch.stack(words))


def search_plain(llr, size_consts, n_loc: int, B: int):
    """Plain version of `viterbi.viterbi_search_cuda` (any device):
    `derm_plain`, the Viterbi's plain step loop, `compact_plain`.  Returns
    ((S, B n_loc, 3) int32 words, every size's (B n_loc, D) uint8 bits)."""
    if llr.device.type == "cuda":
        PLAIN_CUDA["viterbi_search"] += 1
    bits = viterbi.viterbi_decode_tb_multi_plain(
        derm_plain(llr, size_consts, n_loc, B))
    return compact_plain(bits), bits


def pack_plain(compact, cce_power, n_loc: int, B: int,
               scalars=None) -> dict:
    """Plain version of `pdcch_pack` (torch ops, any device): from the
    (S, B n_loc, 3) words, rnti (B, n_loc, S), cand_meta (B, n_loc, S) and
    cand_pay (B, n_loc, S, 2) int32 (the u32 words' bit patterns) and
    cand_fused (B, W) int32."""
    dev = compact.device
    if dev.type == "cuda":
        PLAIN_CUDA["pdcch_pack"] += 1
    S = compact.shape[0]
    c = compact.to(torch.int64) & 0xFFFFFFFF
    c = c.reshape(S, B, n_loc, 3).permute(1, 2, 0, 3)      # (B, n_loc, S, 3)
    meta, pay = c[..., 2], c[..., :2]
    return {"rnti": (meta & 0xFFFF).to(torch.int32),
            "cand_meta": meta.to(torch.int32),
            "cand_pay": u32_to_i32(pay.contiguous()),
            "cand_fused": _fused_row(meta, pay, cce_power, scalars)}


def _tail_dict(size_consts, n_loc: int, B: int, bits, p: dict) -> dict:
    """`decode_tail`'s dict, in `decode_tail_plain`'s key order, from every
    size's (B n_loc, D) bits (or None) and a pack's outputs."""
    out = {}
    for s, D in enumerate(size_consts):
        if bits is not None:
            out[f"bits_{D}"] = bits[s].reshape(B, n_loc, D)
        if "rnti" in p:
            out[f"rnti_{D}"] = p["rnti"][..., s]
    for k in ("cand_meta", "cand_pay", "cand_fused"):
        if k in p:
            out[k] = p[k]
    return out


def route_plain(llr, cce_power, size_consts, n_loc: int, B: int,
                scalars=None) -> dict:
    """The two-launch route in plain torch (any device): `search_plain`,
    then `pack_plain`; the keys of `decode_tail_plain`, the per-candidate
    words as int32."""
    compact, bits = search_plain(llr, size_consts, n_loc, B)
    return _tail_dict(size_consts, n_loc, B, bits,
                      pack_plain(compact, cce_power, n_loc, B, scalars))


# ---------------------------------------------------------------------------
# the kernels' tables (numpy, cached; uploaded once per device by `const`)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def derm_tables_t(ds: tuple):
    """(tab_t, off_t, nrep) for payload sizes ds: `derm_tables`
    transposed, per (size s, level l) a (reps, 3 D) int16 table at
    tab_t[off_t[s, l]:] whose row r holds the r-th e-offset of every
    stream position (increasing along r, -1 past the last), so that at a
    fixed r a warp's lanes (consecutive positions) read consecutive
    int16s; each table starts on a 16-byte boundary (off_t a multiple of
    8), padded with -1, so that the kernel copies it in 16-byte pieces;
    nrep[s, l] (int32) the rows that hold any e-offset."""
    tab, tab_off, reps = derm_tables(ds)
    parts = []
    off_t = np.zeros((len(ds), LEVELS), np.int32)
    nrep = np.zeros((len(ds), LEVELS), np.int32)
    off = 0
    for s, D in enumerate(ds):
        for l in range(LEVELS):
            t = tab[tab_off[s, l]:tab_off[s, l] + 3 * D * reps].reshape(
                3 * D, reps)
            nrep[s, l] = int((t >= 0).any(0).sum())
            n = -(-t.size // 8) * 8
            parts.append(np.pad(t.T.reshape(-1), (0, n - t.size),
                                constant_values=-1))
            off_t[s, l] = off
            off += n
    return np.concatenate(parts), off_t, nrep


@functools.lru_cache(maxsize=16)
def derm_tables(ds: tuple):
    """(tab, tab_off, reps) for payload sizes ds: per (size s, level l) a
    (3 D, reps) int16 table at tab[tab_off[s, l]:], row k the e-offsets
    (E = 72 << l) whose rate-matched bit is stream position k
    (`conv.rate_match_maps`), increasing, -1 past the last; reps the
    most repetitions of any position."""
    rows = {}
    for D in ds:
        for l in range(LEVELS):
            e_to_d = conv.rate_match_maps(D, 72 << l)["e_to_d"]
            order = np.argsort(e_to_d, kind="stable")     # e ascending per k
            counts = np.bincount(e_to_d, minlength=3 * D)
            rows[D, l] = (order, counts)
    reps = max(int(c.max()) for _, c in rows.values())
    parts, tab_off, off = [], np.zeros((len(ds), LEVELS), np.int32), 0
    for s, D in enumerate(ds):
        for l in range(LEVELS):
            order, counts = rows[D, l]
            t = np.full((3 * D, reps), -1, np.int16)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            for r in range(reps):
                has = counts > r
                t[has, r] = order[starts[has] + r]
            tab_off[s, l] = off
            off += t.size
            parts.append(t.reshape(-1))
    return np.concatenate(parts), tab_off, reps


@functools.lru_cache(maxsize=16)
def loc_table(locs: tuple):
    """((n_loc,) int32 words 72 ncce << 2 | level, the LLR bits the
    locations reach) for a search's (level, ncce) list."""
    tab = np.array([(72 * n) << 2 | l for l, n in locs], np.int32)
    reach = max(72 * n + (72 << l) for l, n in locs)
    return tab, reach


@functools.lru_cache(maxsize=1)
def crc_words() -> np.ndarray:
    """(CRC_LEN,) int32: word k is D^(k+16) mod g(D) of LTE's CRC16, MSB
    first (`phy/crc.py`'s remainder table as integers)."""
    rows = crc.crc_remainder_table(crc.CRC16, CRC_LEN).astype(np.int64)
    return (rows @ (1 << np.arange(15, -1, -1, dtype=np.int64))).astype(
        np.int32)


def fused_layout(n_loc: int, S: int, nof_cce: int,
                 with_scalars: bool) -> dict:
    """Word counts of one `cand_fused` row (`unpack_fused`'s layout)."""
    m = n_loc * S
    lay = dict(m=m, mp2=(m + 1) // 2, mbw=-(-m // 32),
               ncw=(nof_cce + 1) // 2, sw=2 if with_scalars else 0)
    lay["W"] = lay["mp2"] + lay["mbw"] + lay["ncw"] + lay["sw"] + 2 * m
    return lay


# ---------------------------------------------------------------------------
# bounds: what the functions must move and compute
# ---------------------------------------------------------------------------
def derm_bytes(B: int, n_bits: int, ds: tuple, n_loc: int) -> int:
    """Bytes `pdcch_derm` must move: the (B, n_bits) LLRs, the tables and
    the location words read once, every size's outputs written once."""
    tab = derm_tables(tuple(ds))[0]
    return 4 * B * n_bits + tab.nbytes + 4 * n_loc + \
        4 * B * n_loc * 3 * sum(ds)


def derm_ops(B: int, ds: tuple, locs: tuple) -> int:
    """Float32 adds of `pdcch_derm`: one per repetition summed and one per
    block partial added to an output's total, over B subframes."""
    tab, tab_off, reps = derm_tables(tuple(ds))
    lvl = np.bincount([l for l, _ in locs], minlength=LEVELS)
    n = 0
    for s, D in enumerate(ds):
        for l in range(LEVELS):
            t = tab[tab_off[s, l]:tab_off[s, l] + 3 * D * reps].reshape(
                3 * D, reps)
            blk = np.where(t >= 0, t // KBLOCK, -1)
            n_blk = sum((blk == k).any(-1).astype(np.int64)
                        for k in range(-(-(72 << l) // KBLOCK)))
            n += int(lvl[l]) * int(((t >= 0).sum(-1)
                                    + np.maximum(1, n_blk)).sum())
    return B * n


def pack_bytes(B: int, ds: tuple, n_loc: int, nof_cce: int,
               with_scalars: bool) -> int:
    """Bytes `pdcch_crc_pack` must move for the fused rows alone: the
    Viterbi's bits, the CCE powers, the scalars and the CRC table read
    once, the rows written once."""
    lay = fused_layout(n_loc, len(ds), nof_cce, with_scalars)
    return B * n_loc * sum(ds) + 4 * B * nof_cce + 4 * CRC_LEN + \
        4 * B * lay["W"] + (16 * B if with_scalars else 0)


def pack_ops(B: int, ds: tuple, n_loc: int) -> int:
    """Integer operations of `pdcch_crc_pack`: per candidate, a test and
    an XOR for each payload bit of the CRC, a shift and an OR for each
    received CRC bit and for each payload bit packed, over B subframes."""
    return B * n_loc * sum(2 * (D - 16) + 32 + 2 * (D - 16) for D in ds)


def words_bytes(B: int, S: int, n_loc: int, nof_cce: int,
                with_scalars: bool) -> int:
    """Bytes `pdcch_pack` must move for the fused rows alone: every
    candidate's three words, the CCE powers and the scalars read once, the
    rows written once."""
    lay = fused_layout(n_loc, S, nof_cce, with_scalars)
    return 12 * B * lay["m"] + 4 * B * nof_cce + \
        (16 * B if with_scalars else 0) + 4 * B * lay["W"]


def words_ops(B: int, S: int, n_loc: int) -> int:
    """Integer operations of `pdcch_pack`: per candidate a mask, a shift
    and an OR for its RNTI and a shift, a mask, a shift and an OR for its
    bit 0, over B subframes."""
    return 7 * B * n_loc * S


def search_bytes(B: int, n_bits: int, ds: tuple, n_loc: int) -> int:
    """Bytes the Viterbi's search entry must move for the unified search:
    the (B, n_bits) LLRs, the transposed tables, the location words and
    the CRC table read once, every codeword's three words written once."""
    tab = derm_tables_t(tuple(ds))[0]
    return 4 * B * n_bits + tab.nbytes + 4 * n_loc + 4 * CRC_LEN + \
        12 * B * n_loc * len(ds)


def search_ops(B: int, ds: tuple, locs: tuple) -> int:
    """Operations of the Viterbi's search entry: the plain entry's float32
    operations on its codewords (`viterbi.ops`), the de-rate-match's adds
    (`derm_ops`) and the epilogue's integer work (`pack_ops`)."""
    n_loc = len(locs)
    return viterbi.ops([(B * n_loc, D) for D in ds]) + \
        derm_ops(B, ds, locs) + pack_ops(B, ds, n_loc)


# ---------------------------------------------------------------------------
# the kernels: build + bind (kernels/nvcc_build.py: nvcc by hand, plain C
# ABI, ctypes) and their wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library():
    """Build csrc/pdcch_tail.cu (at first use) and return its entries."""
    lib = nvcc_build.load("pdcch_tail", SRC)
    lib.pdcch_tail_max_sizes.restype = ctypes.c_int
    lib.pdcch_tail_crc_len.restype = ctypes.c_int
    if lib.pdcch_tail_max_sizes() != MAX_SIZES or \
            lib.pdcch_tail_crc_len() != CRC_LEN:
        raise RuntimeError(
            f"pdcch_tail: the kernels take {lib.pdcch_tail_max_sizes()} "
            f"sizes and {lib.pdcch_tail_crc_len()} CRC bits, the wrapper "
            f"{MAX_SIZES} and {CRC_LEN}")
    lib.pdcch_derm_launch.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.pdcch_derm_launch.restype = ctypes.c_int
    lib.pdcch_crc_pack_launch.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    lib.pdcch_crc_pack_launch.restype = ctypes.c_int
    lib.pdcch_pack_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pdcch_pack_launch.restype = ctypes.c_int
    return lib


def build():
    """Build and load the kernel library now (else it happens at first
    launch).  Returns the build time in seconds (0.0 if it was cached)."""
    _library()
    return nvcc_build.BUILD_SECONDS.get("pdcch_tail", 0.0)


def _check_derm(llr, size_consts, n_loc: int, B: int,
                what: str = "pdcch_derm"):
    """The checks of the search head's LLRs, shared by `derm_cuda` and the
    Viterbi's search entry; returns the payload sizes."""
    if not isinstance(size_consts, SizeConsts):
        raise TypeError(f"{what}: size_consts must be a SizeConsts "
                        "(it carries the search's locations)")
    if llr.dtype != torch.float32:
        raise TypeError(f"{what}: llr must be float32, got {llr.dtype}")
    if llr.dim() != 2 or llr.shape[0] != B or B < 1:
        raise ValueError(f"{what}: llr has shape {tuple(llr.shape)}, "
                         f"expected ({B}, n_bits)")
    if not llr.is_contiguous():
        raise ValueError(f"{what}: llr must be contiguous")
    ds = tuple(size_consts)
    if not 1 <= len(ds) <= MAX_SIZES:
        raise ValueError(f"{what}: {len(ds)} payload sizes, the kernel "
                         f"takes 1 to {MAX_SIZES}")
    if n_loc != len(size_consts.locs):
        raise ValueError(f"{what}: n_loc={n_loc}, the search has "
                         f"{len(size_consts.locs)} locations")
    if loc_table(size_consts.locs)[1] > llr.shape[1]:
        raise ValueError(f"{what}: the locations reach "
                         f"{loc_table(size_consts.locs)[1]} LLRs, llr has "
                         f"{llr.shape[1]}")
    return ds


def derm_cuda(llr, size_consts, n_loc: int, B: int) -> list:
    """Launch `pdcch_derm` once on the current stream of llr's device, with
    that device made current for the launch (CUDA tensors only).  Returns
    every size's (B * n_loc, 3, D) LLRs: contiguous views of one buffer."""
    ds = _check_derm(llr, size_consts, n_loc, B)
    dev = llr.device
    if dev.type != "cuda":
        raise ValueError(f"derm_cuda: llr on {dev}, not a CUDA device")
    tab, tab_off, reps = derm_tables(ds)
    loc = loc_table(size_consts.locs)[0]
    fn = _library().pdcch_derm_launch
    ints = ctypes.c_int * len(ds)
    # the launch goes to the current device's context: make it llr's
    with torch.cuda.device(dev):
        tab_t, loc_t = const(tab, dev), const(loc, dev)
        buf = torch.empty(B * n_loc * 3 * sum(ds), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(llr.data_ptr(), loc_t.data_ptr(), tab_t.data_ptr(),
                 buf.data_ptr(), tab_off.ctypes.data, ints(*ds), len(ds), B,
                 n_loc, llr.shape[1], reps, KBLOCK, stream)
    if err != 0:
        raise RuntimeError(f"pdcch_derm kernel launch failed: cudaError "
                           f"{err} (B {B}, n_loc {n_loc}, D {list(ds)})")
    LAUNCHES["pdcch_derm"] += 1
    groups, off = [], 0
    for D in ds:
        n = B * n_loc * 3 * D
        groups.append(buf[off:off + n].view(B * n_loc, 3, D))
        off += n
    return groups


def _check_pack(all_bits, cce_power, scalars, n_loc: int, B: int):
    if not 1 <= len(all_bits) <= MAX_SIZES:
        raise ValueError(f"pdcch_crc_pack: {len(all_bits)} payload sizes, "
                         f"the kernel takes 1 to {MAX_SIZES}")
    ds = []
    for bits in all_bits:
        if bits.dtype != torch.uint8:
            raise TypeError(f"pdcch_crc_pack: bits must be uint8, got "
                            f"{bits.dtype}")
        if bits.dim() != 2 or bits.shape[0] != B * n_loc or \
                not 17 <= bits.shape[1] <= 16 + CRC_LEN:
            raise ValueError(f"pdcch_crc_pack: bits have shape "
                             f"{tuple(bits.shape)}, expected ({B * n_loc}, "
                             f"D) with 17 <= D <= {16 + CRC_LEN}")
        ds.append(int(bits.shape[1]))
    _check_rows("pdcch_crc_pack", (*all_bits, cce_power, scalars),
                cce_power, scalars, B)
    return tuple(ds)


def _check_rows(what: str, ins, cce_power, scalars, B: int):
    """The checks both packs make of the CCE powers and the scalars, and
    of every input's contiguity."""
    for name, x, shape in (("cce_power", cce_power, None),
                           ("scalars", scalars, (B, 4))):
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{x.dtype}")
        if x.dim() != 2 or x.shape[0] != B or x.shape[1] < 1 or \
                (shape and tuple(x.shape) != shape):
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(x.shape)}, expected "
                             f"{shape or (B, 'nof_cce')}")
    for x in ins:
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def crc_pack_cuda(all_bits, cce_power, n_loc: int, B: int, scalars=None,
                  outputs: bool = True) -> dict:
    """Launch `pdcch_crc_pack` once on the current stream of the inputs'
    device, with that device made current for the launch (CUDA tensors
    only).  all_bits: each payload size's (B * n_loc, D) uint8 Viterbi
    bits.  Returns cand_fused (B, W) int32 and, with `outputs`, rnti
    (B, n_loc, S) int32, cand_meta (B, n_loc, S) int32 and cand_pay
    (B, n_loc, S, 2) int32 (the u32 words' bit patterns)."""
    ds = _check_pack(all_bits, cce_power, scalars, n_loc, B)
    dev = cce_power.device
    ins = [*all_bits, cce_power] + ([scalars] if scalars is not None else [])
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError(f"crc_pack_cuda: inputs on "
                         f"{sorted({str(x.device) for x in ins})}, not one "
                         "CUDA device")
    S, nof_cce = len(ds), int(cce_power.shape[1])
    W = fused_layout(n_loc, S, nof_cce, scalars is not None)["W"]
    fn = _library().pdcch_crc_pack_launch
    ptrs = ctypes.c_void_p * S
    with torch.cuda.device(dev):
        crc_t = const(crc_words(), dev)
        out = {"cand_fused": torch.empty((B, W), dtype=torch.int32,
                                         device=dev)}
        if outputs:
            for k, shape in (("rnti", (B, n_loc, S)),
                             ("cand_meta", (B, n_loc, S)),
                             ("cand_pay", (B, n_loc, S, 2))):
                out[k] = torch.empty(shape, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptrs(*[b.data_ptr() for b in all_bits]),
                 (ctypes.c_int * S)(*ds), S, cce_power.data_ptr(),
                 None if scalars is None else scalars.data_ptr(),
                 crc_t.data_ptr(), out["cand_fused"].data_ptr(),
                 *[out[k].data_ptr() if outputs else None
                   for k in ("rnti", "cand_meta", "cand_pay")],
                 B, n_loc, nof_cce, W, stream)
    if err != 0:
        raise RuntimeError(f"pdcch_crc_pack kernel launch failed: cudaError"
                           f" {err} (B {B}, n_loc {n_loc}, D {list(ds)})")
    LAUNCHES["pdcch_crc_pack"] += 1
    return out


def _check_words(compact, cce_power, scalars, n_loc: int, B: int) -> int:
    if compact.dtype != torch.int32:
        raise TypeError(f"pdcch_pack: the words must be int32, got "
                        f"{compact.dtype}")
    if compact.dim() != 3 or compact.shape[1] != B * n_loc or \
            compact.shape[2] != 3 or B < 1 or n_loc < 1:
        raise ValueError(f"pdcch_pack: the words have shape "
                         f"{tuple(compact.shape)}, expected (S, {B * n_loc}"
                         ", 3)")
    S = int(compact.shape[0])
    if not 1 <= S <= MAX_SIZES:
        raise ValueError(f"pdcch_pack: {S} payload sizes, the kernel takes "
                         f"1 to {MAX_SIZES}")
    _check_rows("pdcch_pack", (compact, cce_power, scalars), cce_power,
                scalars, B)
    return S


def pack_cuda(compact, cce_power, n_loc: int, B: int, scalars=None,
              outputs: bool = False) -> dict:
    """Launch `pdcch_pack` once on the current stream of the inputs'
    device, with that device made current for the launch (CUDA tensors
    only).  compact: the (S, B * n_loc, 3) int32 words of the Viterbi's
    search entry.  Returns cand_fused (B, W) int32 and, with `outputs`,
    rnti (B, n_loc, S), cand_meta (B, n_loc, S) and cand_pay (B, n_loc, S,
    2) int32 (the u32 words' bit patterns)."""
    S = _check_words(compact, cce_power, scalars, n_loc, B)
    dev = compact.device
    ins = [compact, cce_power] + ([scalars] if scalars is not None else [])
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError(f"pack_cuda: inputs on "
                         f"{sorted({str(x.device) for x in ins})}, not one "
                         "CUDA device")
    nof_cce = int(cce_power.shape[1])
    W = fused_layout(n_loc, S, nof_cce, scalars is not None)["W"]
    fn = _library().pdcch_pack_launch
    with torch.cuda.device(dev):
        out = {"cand_fused": torch.empty((B, W), dtype=torch.int32,
                                         device=dev)}
        if outputs:
            for k, shape in (("rnti", (B, n_loc, S)),
                             ("cand_meta", (B, n_loc, S)),
                             ("cand_pay", (B, n_loc, S, 2))):
                out[k] = torch.empty(shape, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(compact.data_ptr(), S, cce_power.data_ptr(),
                 None if scalars is None else scalars.data_ptr(),
                 out["cand_fused"].data_ptr(),
                 *[out[k].data_ptr() if outputs else None
                   for k in ("rnti", "cand_meta", "cand_pay")],
                 B, n_loc, nof_cce, W, stream)
    if err != 0:
        raise RuntimeError(f"pdcch_pack kernel launch failed: cudaError "
                           f"{err} (B {B}, n_loc {n_loc}, {S} sizes)")
    LAUNCHES["pdcch_pack"] += 1
    return out


def decode_tail_cuda(llr, cce_power, size_consts, n_loc: int, B: int,
                     scalars=None, full: bool = True) -> dict:
    """The tail in two launches on llr's device (CUDA tensors only): the
    Viterbi's search entry, `pdcch_pack`.  With `full` the keys of
    `decode_tail_plain` (rnti_{D}, cand_meta and cand_pay hold the int32
    words the fixed-CFI search returns), else cand_fused alone."""
    compact, bits = viterbi.viterbi_search_cuda(llr, size_consts, n_loc, B,
                                                want_bits=full)
    p = pack_cuda(compact, cce_power, n_loc, B, scalars, outputs=full)
    return _tail_dict(size_consts, n_loc, B, bits, p)


def decode_tail_three(llr, cce_power, size_consts, n_loc: int, B: int,
                      scalars=None) -> dict:
    """The earlier route, the fold's yardstick, in three launches on llr's
    device (CUDA tensors only): `pdcch_derm`, the Viterbi's plain entry on
    views of its buffer, `pdcch_crc_pack`.  The keys of
    `decode_tail_plain`; rnti_{D}, cand_meta and cand_pay hold int32
    words."""
    groups = derm_cuda(llr, size_consts, n_loc, B)
    # the kernel's bits are contiguous; the plain step loop's (put in its
    # place to compare the two) are views
    all_bits = [b.contiguous()
                for b in viterbi.viterbi_decode_tb_multi(groups)]
    p = crc_pack_cuda(all_bits, cce_power, n_loc, B, scalars)
    return _tail_dict(size_consts, n_loc, B, all_bits, p)


def decode_tail(llr, cce_power, size_consts, n_loc: int, B: int,
                scalars=None, full: bool = True) -> dict:
    """The blind search's tail from the per-CCE LLRs to the fused host
    words: the kernels for CUDA tensors, the plain version for CPU
    tensors.

    Args:
      llr: (B, n_bits) float32 descrambled LLRs of the PDCCH stream.
      cce_power: (B, nof_cce) float32 mean |LLR| per CCE.
      size_consts: a SizeConsts (`sniffer/pdcch_rx._size_consts_of`).
      n_loc: the search's locations; B: subframes.
      scalars: optional (B, 4) float32 frontend scalars folded into
        cand_fused.
      full: return bits_{D}, rnti_{D}, cand_meta and cand_pay too (the
        fixed-CFI search); else cand_fused alone (the unified search).

    Returns:
      dict: per payload size D bits_{D} (B, n_loc, D) uint8 and rnti_{D}
      (B, n_loc); cand_meta (B, n_loc, S); cand_pay (B, n_loc, S, 2);
      cand_fused (B, W) int32 (`unpack_fused`'s layout).  Without `full`
      the kernels allocate and write cand_fused alone.
    """
    if llr.device.type == "cuda":
        return decode_tail_cuda(llr, cce_power, size_consts, n_loc, B,
                                scalars, full)
    if llr.device.type != "cpu":
        raise ValueError(f"pdcch_tail: unsupported device {llr.device}")
    out = decode_tail_plain(llr, cce_power, size_consts, n_loc, B, scalars)
    return out if full else {"cand_fused": out["cand_fused"]}
