"""The blind search's candidate tail (`kernels/pdcch_tail.py`): its plain
version against the JAX package's `sniffer/pdcch_rx.py:
_candidate_decode_tail`, numpy models of the two CUDA kernels
(`csrc/pdcch_tail.cu`: `pdcch_derm`, `pdcch_crc_pack`) against the plain
version, the kernels' tables, the wrapper's CPU dispatch and checks, and
the repaired `cplx.const` cache.

Both models read the numpy tables the wrapper uploads (`derm_tables`,
`loc_table`, `crc_words`).  The de-rate-match model sums in the kernel's
order (from +0, increasing e, blocks of `KBLOCK`) in float32 and must
equal the plain version's einsum on the host bit for bit; the packing
model is integer work plus one f32 -> f16 rounding and must equal the
plain version word for word.
"""
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch

from ltesniffer_tpu_torch.kernels import cplx, pdcch_tail
from ltesniffer_tpu_torch.phy import conv, crc, dci as dci_mod
from ltesniffer_tpu_torch.phy import grid as grid_mod, search_space
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, pdcch_rx

from tests import test_golden_replay as golden

torch.set_num_threads(1)

CELL20 = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
SIZES20 = (31, 44, 46, 55, 64, 67)     # its payload sizes (DCI + CRC16)
KB = pdcch_tail.KBLOCK


def consts_of(cell, cfi=3):
    """(static maps, SizeConsts) of the search over cfi's region (the
    unified search uses cfi 3's)."""
    st = pdcch_rx._static_maps(cell, cfi)
    return st, pdcch_rx._size_consts_of(st)


def only(sc, ds):
    return pdcch_tail.SizeConsts({D: sc[D] for D in ds}, sc.locs)


def f32_equal(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    n = int((got.view(np.int32) != want.view(np.int32)).sum())
    assert n == 0, f"{what}: {n} of {got.size} floats differ in their bits"


# ---------------------------------------------------------------------------
# numpy models of the kernels
# ---------------------------------------------------------------------------
def derm_model(llr: np.ndarray, sc) -> list:
    """pdcch_derm, every output thread at once, in float32 numpy: each
    stream position's repetitions from +0 in increasing e, the partial sum
    of each block of KBLOCK e-offsets added to the total when the next
    block starts and at the end."""
    ds = tuple(sc)
    tab, tab_off, reps = pdcch_tail.derm_tables(ds)
    loc = pdcch_tail.loc_table(sc.locs)[0]
    B, n_loc = llr.shape[0], len(sc.locs)
    outs = []
    for s, D in enumerate(ds):
        out = np.empty((B, n_loc, 3 * D), np.float32)
        for l in range(4):
            js = np.nonzero((loc & 3) == l)[0]
            if len(js) == 0:
                continue
            t = tab[tab_off[s, l]:tab_off[s, l] + 3 * D * reps].reshape(
                3 * D, reps).astype(np.int64)
            base = (loc[js] >> 2).astype(np.int64)
            total = np.zeros((B, len(js), 3 * D), np.float32)
            part = np.zeros_like(total)
            blk = np.zeros(3 * D, np.int64)
            for r in range(reps):
                e = t[:, r]
                ok = e >= 0
                eb = np.where(ok, e // KB, blk)
                new = ok & (eb != blk)
                total = np.where(new, total + part, total)
                part = np.where(new, np.float32(0.0), part)
                blk = np.where(new, eb, blk)
                x = llr[:, base[:, None] + np.where(ok, e, 0)[None, :]]
                part = np.where(ok, part + x, part)
            out[:, js] = total + part
        outs.append(out.reshape(B * n_loc, 3, D))
    return outs


def _f16(x: np.ndarray) -> np.ndarray:
    """float32 -> float16 bits, rounding to nearest even (past 65504: inf)."""
    with np.errstate(over="ignore"):
        h = np.asarray(x, np.float32).astype(np.float16)
    return h.view(np.uint16).astype(np.uint32)


def _pairs(v: np.ndarray) -> np.ndarray:
    if v.shape[1] & 1:
        v = np.pad(v, ((0, 0), (0, 1)))
    return v[:, 0::2] | (v[:, 1::2] << np.uint32(16))


def pack_model(all_bits, cce, scal, n_loc: int, B: int) -> dict:
    """pdcch_crc_pack in numpy integers: the CRC as the XOR of crc_words
    over the set payload bits, the received CRC MSB first, and the fused
    row's words in unpack_fused's order."""
    words = pdcch_tail.crc_words().view(np.uint32)
    ds = [b.shape[1] for b in all_bits]
    S = len(ds)
    rnti = np.zeros((B, n_loc, S), np.uint32)
    bit0 = np.zeros((B, n_loc, S), np.uint32)
    pay = np.zeros((B, n_loc, S, 2), np.uint32)
    for s, D in enumerate(ds):
        bits = np.asarray(all_bits[s]).reshape(B, n_loc, D).astype(np.uint32)
        L = D - 16
        c = np.zeros((B, n_loc), np.uint32)
        for i in range(L):
            c ^= bits[..., i] * words[L - 1 - i]
        rx = np.zeros((B, n_loc), np.uint32)
        for i in range(16):
            rx = (rx << np.uint32(1)) | bits[..., L + i]
        rnti[..., s] = (c ^ rx) & np.uint32(0xFFFF)
        bit0[..., s] = bits[..., 0]
        for h in range(2):
            for t in range(32):
                if 32 * h + t < L:
                    pay[..., s, h] |= bits[..., 32 * h + t] << np.uint32(t)
    m = n_loc * S
    r = rnti.reshape(B, m)
    b0 = np.pad(bit0.reshape(B, m), ((0, 0), (0, -(-m // 32) * 32 - m)))
    bmp = np.zeros((B, b0.shape[1] // 32), np.uint32)
    for t in range(32):
        bmp |= b0[:, t::32] << np.uint32(t)
    parts = [_pairs(r), bmp, _pairs(_f16(cce))]
    if scal is not None:
        parts.append(_pairs(_f16(scal)))
    parts.append(pay.reshape(B, 2 * m))
    return dict(cand_fused=np.concatenate(parts, 1).view(np.int32),
                rnti=rnti, cand_meta=rnti | (bit0 << np.uint32(16)), pay=pay)


def random_bits(ds, n_loc, B, rng):
    return [rng.integers(0, 2, (B * n_loc, D)).astype(np.uint8) for D in ds]


def random_floats(shape, rng):
    """Floats over many binades, some at f16's rounding ties and limits."""
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 5, shape)
    x = x.astype(np.float32).reshape(-1)
    x[:4] = [1.0 + 2.0 ** -11, 65520.0, 6e-8, -0.0][:len(x[:4])]
    return x.reshape(shape)


def pack_plain(all_bits, cce, scal, ds, n_loc, B) -> dict:
    return pdcch_tail.crc_pack_plain(
        [torch.from_numpy(b) for b in all_bits], torch.from_numpy(cce), ds,
        n_loc, B, None if scal is None else torch.from_numpy(scal))


def assert_pack_equal(got: dict, want: dict, ds):
    np.testing.assert_array_equal(got["cand_fused"].numpy(),
                                  want["cand_fused"])
    np.testing.assert_array_equal(got["cand_meta"].numpy(),
                                  want["cand_meta"].astype(np.int64))
    np.testing.assert_array_equal(got["cand_pay"].numpy(),
                                  want["pay"].astype(np.int64))
    for s, D in enumerate(ds):
        np.testing.assert_array_equal(got[f"rnti_{D}"].numpy(),
                                      want["rnti"][..., s].astype(np.int64))


# ---------------------------------------------------------------------------
# the kernels' tables
# ---------------------------------------------------------------------------
def test_the_20mhz_cell_has_the_search_sizes():
    st, sc = consts_of(CELL20)
    assert tuple(sc) == SIZES20 == st["size_order"]
    assert sc.locs == tuple(st["locs"]) and len(sc.locs) == 157


@pytest.mark.parametrize("D", SIZES20)
def test_derm_tables_are_the_rate_match_maps(D):
    """Row k of (D, level)'s table lists, in increasing e, the e-offsets
    `conv.rate_match_maps` sends to stream position k: the 0/1 matrix of
    the plain version, nothing else."""
    tab, tab_off, reps = pdcch_tail.derm_tables((D,))
    for l in range(4):
        E = 72 << l
        t = tab[tab_off[0, l]:tab_off[0, l] + 3 * D * reps].reshape(
            3 * D, reps)
        W = np.zeros((E, 3 * D), np.float32)
        for k in range(3 * D):
            es = t[k][t[k] >= 0]
            assert (np.diff(es) > 0).all() and (t[k][len(es):] == -1).all()
            W[es, k] = 1.0
        want = np.zeros_like(W)
        want[np.arange(E), conv.rate_match_maps(D, E)["e_to_d"]] = 1.0
        np.testing.assert_array_equal(W, want)


def test_derm_tables_at_20mhz():
    """The most repetitions of any position is 7 (D = 31 at level 3); level
    0, and level 1 for D >= 55, leave some positions without any."""
    tab, tab_off, reps = pdcch_tail.derm_tables(SIZES20)
    assert reps == 7
    for s, D in enumerate(SIZES20):
        for l in range(4):
            t = tab[tab_off[s, l]:tab_off[s, l] + 3 * D * reps].reshape(
                3 * D, reps)
            empty = int(((t >= 0).sum(-1) == 0).sum())
            assert (empty > 0) == (l == 0 or (l == 1 and D >= 55)), (D, l)


def test_loc_table_and_crc_words():
    st, sc = consts_of(CELL20)
    loc, reach = pdcch_tail.loc_table(sc.locs)
    assert [(int(w) & 3, int(w) >> 2) for w in loc] == \
        [(l, 72 * n) for l, n in st["locs"]]
    assert reach == 72 * st["nof_cce"]
    rng = np.random.default_rng(3)
    words = pdcch_tail.crc_words().view(np.uint32)
    for L in (1, 15, 28, 51, 64):
        msg = rng.integers(0, 2, L).astype(np.uint8)
        want = crc.bits_to_int(crc.crc_bits(msg, crc.CRC16))
        got = 0
        for i in range(L):
            if msg[i]:
                got ^= int(words[L - 1 - i])
        assert got == want


# ---------------------------------------------------------------------------
# pdcch_derm: the model against the plain einsum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", SIZES20)
def test_derm_model_equals_plain_random(D):
    """Every level of payload size D of the 20 MHz cell, seeded random
    LLRs (LLRs beyond a subframe's region are +-0 in the search: some are
    -0 here too): bit for bit, +0 where no e maps."""
    _, sc = consts_of(CELL20)
    sc = only(sc, (D,))
    rng = np.random.default_rng(D)
    n_bits = pdcch_tail.loc_table(sc.locs)[1] + 8
    llr = (3.0 * rng.standard_normal((4, n_bits))).astype(np.float32)
    llr[:, ::7] *= np.float32(0.0)
    got = derm_model(llr, sc)
    want = pdcch_tail.derm_plain(torch.from_numpy(llr), sc, len(sc.locs), 4)
    for g, w in zip(got, want):
        f32_equal(g, w.numpy(), f"D={D}")
    assert not np.signbit(got[0][got[0] == 0]).any()


@pytest.fixture(scope="module")
def loaded_chunk():
    """The tail's inputs of the loaded cell's search over its first 64
    subframes (its frontend and search head on the CPU)."""
    from ltesniffer_tpu_torch.sniffer import frontend
    from ltesniffer_tpu_torch.testing import loaded_cell
    cell = loaded_cell.CELL
    x, _, _ = loaded_cell.build_stream(n_sf=64)
    sf = torch.arange(64) % 10
    fe = frontend.make_frontend(cell).run(x.reshape(64, 1, -1), sf, "cpu")
    run, _ = pdcch_rx.make_unified_search(cell)
    seen = {}
    real = pdcch_rx._candidate_decode_tail

    def spy(*a, **k):
        seen["args"] = a + (k.get("scalars"),)
        seen["full"] = k.get("full")
        seen["out"] = real(*a, **k)
        return seen["out"]
    pdcch_rx._candidate_decode_tail = spy
    try:
        run(fe["grids"], fe["h"], fe["noise_var"], fe["snr_db"], sf,
            fe["cfi"] - 1, fe["scalars"])
    finally:
        pdcch_rx._candidate_decode_tail = real
    return seen


@pytest.mark.parametrize("D", SIZES20)
def test_derm_model_equals_plain_loaded_chunk(loaded_chunk, D):
    """The loaded cell's real LLRs of one search call: bit for bit."""
    llr, _, sc, n_loc, B, _ = loaded_chunk["args"]
    assert tuple(sc) == SIZES20 and B == 64
    sub = only(sc, (D,))
    got = derm_model(llr.numpy(), sub)[0]
    want = pdcch_tail.derm_plain(llr, sub, n_loc, B)[0]
    f32_equal(got, want.numpy(), f"D={D}")


def test_models_give_the_tail_of_the_loaded_chunk(loaded_chunk):
    """The kernels' route, modelled end to end on the CPU (derm model, the
    Viterbi's plain version, pack model), gives the plain tail's
    cand_fused word for word."""
    from ltesniffer_tpu_torch.kernels import viterbi
    llr, cce, sc, n_loc, B, scal = loaded_chunk["args"]
    groups = [torch.from_numpy(g) for g in derm_model(llr.numpy(), sc)]
    bits = [b.numpy() for b in viterbi.viterbi_decode_tb_multi(groups)]
    got = pack_model(bits, cce.numpy(), scal.numpy(), n_loc, B)
    np.testing.assert_array_equal(got["cand_fused"],
                                  loaded_chunk["out"]["cand_fused"].numpy())


# ---------------------------------------------------------------------------
# pdcch_crc_pack: the model against the plain packing
# ---------------------------------------------------------------------------
def search_shape(n_prb: int, cfi: int, ports: int):
    """(payload sizes, n_loc, nof_cce) of the fixed-CFI search."""
    cell = CellConfig(n_id_cell=7, n_prb=n_prb, nof_ports=ports)
    nof_cce = grid_mod.control_region(cell, cfi)["nof_pdcch_regs"] // 9
    n_loc = len(search_space.all_locations(nof_cce))
    ds = tuple(sorted({s + 16 for s in dci_mod.format_sizes(cell).values()}))
    return ds, n_loc, nof_cce


SWEEP = [(n, c, p) for n in (6, 15, 25, 50, 100) for c in (1, 2, 3)
         for p in (1, 2, 4)]


def test_sweep_has_odd_counts():
    shapes = [search_shape(*c) for c in SWEEP]
    assert any(n_loc * len(ds) % 2 for ds, n_loc, _ in shapes)
    assert any(nof_cce % 2 for _, _, nof_cce in shapes)
    assert any((n_loc * len(ds)) % 32 for ds, n_loc, _ in shapes)


@pytest.mark.parametrize("n_prb,cfi,ports", SWEEP,
                         ids=[f"{n}prb-cfi{c}-{p}port" for n, c, p in SWEEP])
def test_pack_model_equals_plain(n_prb, cfi, ports):
    """Every output of the packing -- cand_fused with and without the
    scalars, rnti_{D}, cand_meta, cand_pay -- word for word."""
    ds, n_loc, nof_cce = search_shape(n_prb, cfi, ports)
    rng = np.random.default_rng(n_prb * 100 + cfi * 10 + ports)
    B = 3
    bits = random_bits(ds, n_loc, B, rng)
    cce = np.abs(random_floats((B, nof_cce), rng))
    scal = random_floats((B, 4), rng)
    for sc_ in (None, scal):
        want = pack_model(bits, cce, sc_, n_loc, B)
        got = pack_plain(bits, cce, sc_, ds, n_loc, B)
        assert got["cand_fused"].shape[1] == pdcch_tail.fused_layout(
            n_loc, len(ds), nof_cce, sc_ is not None)["W"]
        assert_pack_equal(got, want, ds)


def test_pack_outputs_unpack():
    """The packed row decodes (`unpack_fused`) to the model's meta words,
    payload words, f16 CCE powers and scalars."""
    ds, n_loc, nof_cce = search_shape(15, 2, 2)
    rng = np.random.default_rng(1)
    B = 2
    bits = random_bits(ds, n_loc, B, rng)
    cce = np.abs(random_floats((B, nof_cce), rng))
    scal = random_floats((B, 4), rng)
    want = pack_model(bits, cce, scal, n_loc, B)
    meta, c16, s16, pay = pdcch_rx.unpack_fused(
        want["cand_fused"], n_loc, len(ds), nof_cce, True, True)
    np.testing.assert_array_equal(meta, want["cand_meta"].astype(np.int32))
    np.testing.assert_array_equal(pay, want["pay"])
    np.testing.assert_array_equal(c16, _f16(cce).astype(np.uint16)
                                  .view(np.float16).astype(np.float32))
    np.testing.assert_array_equal(s16, _f16(scal).astype(np.uint16)
                                  .view(np.float16).astype(np.float32))


# ---------------------------------------------------------------------------
# the plain version against the JAX program
# ---------------------------------------------------------------------------
def test_plain_tail_equals_jax():
    """The same LLRs, CCE powers and scalars through the JAX package's tail
    and the port's plain tail (the kernels' yardstick): every output equal.
    The LLRs are half-integers, so every de-rate-match sum is exact in any
    order (XLA's CPU dot, MKL's and cuBLAS's orders all differ)."""
    cell = CellConfig(n_id_cell=11, n_prb=15, nof_ports=2)
    ref_cell = RefCell(n_id_cell=11, n_prb=15, nof_ports=2)
    st, sc = consts_of(cell)
    ref_st = ref_pdcch._static_maps(ref_cell, 3)
    ref_sc = ref_pdcch._size_consts_of(ref_st)
    assert tuple(ref_sc) == tuple(sc)
    rng = np.random.default_rng(5)
    B, n_loc = 3, len(st["locs"])
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    llr = (rng.integers(-12, 13, (B, n_bits)) / 2.0).astype(np.float32)
    cce = np.abs(rng.standard_normal((B, st["nof_cce"]))).astype(np.float32)
    scal = rng.standard_normal((B, 4)).astype(np.float32)
    want = jax.jit(lambda a, c, s: ref_pdcch._candidate_decode_tail(
        {}, a, c, ref_sc, n_loc, B, s))(jnp.asarray(llr), jnp.asarray(cce),
                                        jnp.asarray(scal))
    got = pdcch_tail.decode_tail_plain(torch.from_numpy(llr),
                                       torch.from_numpy(cce), sc, n_loc, B,
                                       torch.from_numpy(scal))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k == "cand_pay":
            g = g.astype(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    # and the packing model on the same Viterbi bits
    bits = [got[f"bits_{D}"].numpy().reshape(B * n_loc, D) for D in sc]
    np.testing.assert_array_equal(
        pack_model(bits, cce, scal, n_loc, B)["cand_fused"],
        np.asarray(want["cand_fused"]))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def test_decode_tail_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version: the same outputs, no launch
    and no plain run on a card counted; `_candidate_decode_tail`
    dispatches to it."""
    st, sc = consts_of(CellConfig(n_id_cell=3, n_prb=6, nof_ports=1))
    rng = np.random.default_rng(2)
    B, n_loc = 2, len(st["locs"])
    llr = torch.from_numpy((2.0 * rng.standard_normal(
        (B, 8 * (len(st["gather_idx"]) // 4)))).astype(np.float32))
    cce = torch.rand((B, st["nof_cce"]))
    pdcch_tail.reset_launches()
    got = pdcch_rx._candidate_decode_tail(llr, cce, sc, n_loc, B)
    want = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert all(v == 0 for v in pdcch_tail.LAUNCHES.values())
    assert all(v == 0 for v in pdcch_tail.PLAIN_CUDA.values())


def test_decode_tail_refuses_other_devices():
    _, sc = consts_of(CellConfig(n_id_cell=3, n_prb=6, nof_ports=1))
    x = torch.zeros((2, 100), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdcch_tail.decode_tail(x, x, sc, len(sc.locs), 2)


def _derm_args():
    st, sc = consts_of(CellConfig(n_id_cell=3, n_prb=6, nof_ports=1))
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    return torch.zeros((2, n_bits)), sc, len(sc.locs), 2


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("strided", ValueError), ("shape", ValueError),
    ("consts", TypeError), ("n_loc", ValueError), ("short", ValueError),
    ("sizes", ValueError), ("cpu", ValueError)])
def test_derm_wrapper_checks_before_a_launch(what, err):
    """derm_cuda refuses what the kernel does not take before it builds or
    launches anything (so it runs here on CPU tensors)."""
    llr, sc, n_loc, B = _derm_args()
    if what == "dtype":
        llr = llr.to(torch.float64)
    elif what == "strided":
        llr = torch.zeros((2, 2 * llr.shape[1]))[:, ::2]
    elif what == "shape":
        llr = llr[0]
    elif what == "consts":
        sc = dict(sc)
    elif what == "n_loc":
        n_loc += 1
    elif what == "short":
        llr = llr[:, :-8].contiguous()
    elif what == "sizes":
        sc = pdcch_tail.SizeConsts({}, sc.locs)
    with pytest.raises(err):
        pdcch_tail.derm_cuda(llr, sc, n_loc, B)
    n0 = dict(pdcch_tail.LAUNCHES)
    pdcch_tail._check_derm(*_derm_args())
    assert pdcch_tail.LAUNCHES == n0


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("d_small", ValueError), ("d_large", ValueError),
    ("rows", ValueError), ("cce", TypeError), ("scalars", ValueError),
    ("strided", ValueError), ("sizes", ValueError), ("cpu", ValueError),
    ("devices", ValueError)])
def test_pack_wrapper_checks_before_a_launch(what, err):
    """crc_pack_cuda refuses what the kernel does not take, inputs off a
    CUDA device or on two devices, before it builds or launches."""
    B, n_loc = 2, 10
    bits = [torch.zeros((B * n_loc, D), dtype=torch.uint8) for D in (31, 44)]
    cce = torch.zeros((B, 9))
    scal = torch.zeros((B, 4))
    if what == "dtype":
        bits[0] = bits[0].to(torch.int32)
    elif what == "d_small":
        bits[1] = torch.zeros((B * n_loc, 16), dtype=torch.uint8)
    elif what == "d_large":
        bits[1] = torch.zeros((B * n_loc, 81), dtype=torch.uint8)
    elif what == "rows":
        bits[0] = bits[0][:-1]
    elif what == "cce":
        cce = cce.to(torch.float16)
    elif what == "scalars":
        scal = torch.zeros((B, 3))
    elif what == "strided":
        cce = torch.zeros((B, 18))[:, ::2]
    elif what == "sizes":
        bits = bits * 5
    elif what == "devices":
        cce = cce.to("meta")
    with pytest.raises(err):
        pdcch_tail.crc_pack_cuda(bits, cce, n_loc, B, scal)
    assert pdcch_tail._check_pack(
        [torch.zeros((B * n_loc, D), dtype=torch.uint8) for D in (31, 44)],
        torch.zeros((B, 9)), torch.zeros((B, 4)), n_loc, B) == (31, 44)


def test_bytes_and_ops_at_the_search_call():
    """The bounds' counts at one search call of the 20 MHz cell: 37.0 MB
    written and 1.55 MB of LLRs read by pdcch_derm, 3.09 MB of bits read
    and 0.62 MB written by pdcch_crc_pack."""
    st, sc = consts_of(CELL20)
    B, n_loc, n_bits = 64, 157, 6056
    assert 8 * (len(st["gather_idx"]) // 4) == n_bits
    out = 4 * B * n_loc * 3 * sum(SIZES20)
    assert out == 37_016_832
    assert pdcch_tail.derm_bytes(B, n_bits, SIZES20, n_loc) - out - \
        4 * B * n_bits == pdcch_tail.derm_tables(SIZES20)[0].nbytes + 4 * 157
    lay = pdcch_tail.fused_layout(n_loc, 6, 84, True)
    assert lay["W"] == 2429
    assert pdcch_tail.pack_bytes(B, SIZES20, n_loc, 84, True) == \
        B * n_loc * 307 + 4 * B * 84 + 4 * 64 + 4 * B * 2429 + 16 * B
    # each output at least one add (+0 plus its repetitions)
    assert pdcch_tail.derm_ops(B, SIZES20, sc.locs) >= out // 4
    assert pdcch_tail.pack_ops(B, SIZES20, n_loc) > 0


# ---------------------------------------------------------------------------
# cplx.const: device copies live as long as their host arrays
# ---------------------------------------------------------------------------
def test_const_entry_goes_with_its_array():
    a = np.arange(7, dtype=np.float32)
    key = (id(a), "cpu", None)
    n0 = cplx.UPLOADS["n"]
    t = cplx.const(a, "cpu")
    assert cplx._CONST_CACHE[key] is t and cplx.UPLOADS["n"] == n0 + 1
    assert cplx.const(a, "cpu") is t and cplx.UPLOADS["n"] == n0 + 1
    assert t.data_ptr() != a.ctypes.data      # a copy: `a` is not kept
    np.testing.assert_array_equal(t.numpy(), a)
    t2 = cplx.const(a, "cpu", torch.float64)
    assert t2.dtype == torch.float64
    del a
    gc.collect()
    assert key not in cplx._CONST_CACHE
    assert not any(k[0] == key[0] and k[2] == torch.float64
                   for k in cplx._CONST_CACHE)
    del t, t2


def test_const_frees_a_cleared_table_cache():
    """A table dropped from its cache (as pdsch_rx clears _RE_TAB_CACHE)
    takes its device copy with it."""
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    cell = CellConfig(n_id_cell=5, n_prb=6, nof_ports=1)
    mask = np.zeros(6, bool)
    mask[1:4] = True
    combo = ((3, 2, mask.tobytes(), None),)
    tab = pdsch_rx._re_tab(cell, 1024, combo)
    assert pdsch_rx._re_tab(cell, 1024, combo) is tab
    key = (id(tab), "cpu", None)
    cplx.const(tab, "cpu")
    assert key in cplx._CONST_CACHE
    pdsch_rx._RE_TAB_CACHE.clear()
    del tab
    gc.collect()
    assert key not in cplx._CONST_CACHE


def test_const_cache_stops_growing_dl_golden():
    """Two passes of `run_packed` over the DL golden scenario (a new core
    each): the second uploads nothing and leaves as many entries as the
    first."""
    stream = golden._build_stream()
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    n = cell.sf_len
    T = len(stream) // n
    words, scales = cplx.to_i8_packed(stream[:T * n].reshape(T, 1, n))
    counts = []
    for _ in range(2):
        c = core.LTESnifferCore(core.SnifferConfig(
            cell=cell, batch_size=8, device="cpu"))
        c.run_packed(words, scales)
        c.close()
        gc.collect()
        counts.append((len(cplx._CONST_CACHE), cplx.UPLOADS["n"]))
    assert counts[0][0] > 0
    assert counts[1] == counts[0]


def test_const_cache_stops_growing_ul_golden():
    """The same for `run_dual_packed` over the UL golden scenario."""
    dl, ul = golden._build_dual()
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    n = cell.sf_len
    T = min(len(dl), len(ul)) // n
    dlp = cplx.to_i8_packed(dl[:T * n].reshape(T, 1, n))
    ulp = cplx.to_i8_packed(ul[:T * n].reshape(T, 1, n))
    counts = []
    for _ in range(2):
        c = core.LTESnifferCoreUL(core.SnifferConfig(
            cell=cell, batch_size=8, acquire_sfn=False, device="cpu"))
        c.run_dual_packed(dlp, ulp)
        c.close()
        gc.collect()
        counts.append((len(cplx._CONST_CACHE), cplx.UPLOADS["n"]))
    assert counts[0][0] > 0
    assert counts[1] == counts[0]


# ---------------------------------------------------------------------------
# the two-launch route: the Viterbi's search entry (the de-rate-match in
# its staging, the per-codeword words after its traceback) and pdcch_pack
# ---------------------------------------------------------------------------
CELL25 = CellConfig(n_id_cell=7, n_prb=25, nof_ports=4)
TAIL_CELLS = {"20mhz": CELL20, "25prb_4port": CELL25}
CELL_SIZES = [(name, D) for name, cell in TAIL_CELLS.items()
              for D in consts_of(cell)[1]]


def test_the_25prb_4port_cell_has_odd_counts():
    """7 payload sizes, 31 locations, 17 CCEs: odd m and odd nof_cce."""
    st, sc = consts_of(CELL25)
    assert (len(sc), len(sc.locs), st["nof_cce"]) == (7, 31, 17)


@pytest.mark.parametrize("cell,D", CELL_SIZES,
                         ids=[f"{c}-{D}" for c, D in CELL_SIZES])
def test_derm_tables_t_is_the_transpose(cell, D):
    """Each (size, level) block of the transposed table is its block of
    `derm_tables` transposed, starting on a 16-byte boundary and padded
    with -1 to the next; nrep counts the rows that hold an e-offset, and
    the rows past it hold none."""
    ds = tuple(consts_of(TAIL_CELLS[cell])[1])
    tab, tab_off, reps = pdcch_tail.derm_tables(ds)
    tab_t, off_t, nrep = pdcch_tail.derm_tables_t(ds)
    assert tab_t.dtype == np.int16 and (off_t % 8 == 0).all()
    assert len(tab_t) == sum(-(-3 * d * reps // 8) * 8 for d in ds) * 4
    s = ds.index(D)
    for l in range(4):
        n = 3 * D * reps
        t = tab[tab_off[s, l]:tab_off[s, l] + n].reshape(3 * D, reps)
        tt = tab_t[off_t[s, l]:off_t[s, l] + n].reshape(reps, 3 * D)
        np.testing.assert_array_equal(tt, t.T)
        assert (tab_t[off_t[s, l] + n:off_t[s, l] - (-n // 8) * 8] == -1).all()
        assert (tt[:nrep[s, l]] >= 0).any(1).all()
        assert (tt[nrep[s, l]:] == -1).all()
        assert nrep[s, l] == -(-(72 << l) // (3 * D))


def search_stage_model(llr: np.ndarray, sc) -> list:
    """The search entry's staging in float32 numpy: codeword row = b n_loc
    + j of each size reads its own location's level table (transposed:
    row r, every stream position k at once, as a warp's lanes do) for its
    level's nrep rows and its own subframe's window; each position's
    e-offsets below KBLOCK and from KBLOCK on summed apart from +0 in
    increasing e, then the two sums added.  Returns every size's
    (B n_loc, 3, D) staged LLRs."""
    ds = tuple(sc)
    tab_t, off_t, nrep = pdcch_tail.derm_tables_t(ds)
    reps = pdcch_tail.derm_tables(ds)[2]
    loc = pdcch_tail.loc_table(sc.locs)[0].astype(np.int64)
    B, n_loc = llr.shape[0], len(sc.locs)
    rows = np.arange(B * n_loc)
    b, j = rows // n_loc, rows % n_loc
    lvl, base = loc[j] & 3, loc[j] >> 2
    outs = []
    for s, D in enumerate(ds):
        out = np.empty((B * n_loc, 3 * D), np.float32)
        for l in range(4):
            sel = np.nonzero(lvl == l)[0]
            if len(sel) == 0:
                continue
            t = tab_t[off_t[s, l]:off_t[s, l] + reps * 3 * D].reshape(
                reps, 3 * D).astype(np.int64)
            assert (t < 2 * KB).all()       # two blocks at most
            p0 = np.zeros((len(sel), 3 * D), np.float32)
            p1 = np.zeros_like(p0)
            for r in range(nrep[s, l]):
                e = t[r]
                x = llr[b[sel, None], base[sel, None] +
                        np.where(e >= 0, e, 0)[None, :]]
                p0 = np.where((e >= 0) & (e < KB), p0 + x, p0)
                p1 = np.where(e >= KB, p1 + x, p1)
            out[sel] = p0 + p1
        outs.append(out.reshape(B * n_loc, 3, D))
    return outs


def random_llrs(cell, B, rng):
    st = pdcch_rx._static_maps(cell, 3)
    llr = (3.0 * rng.standard_normal((B, 8 * (len(st["gather_idx"]) // 4)))
           ).astype(np.float32)
    llr[:, ::7] *= np.float32(0.0)          # +-0, as beyond a region
    return llr


@pytest.mark.parametrize("cell,D", CELL_SIZES,
                         ids=[f"{c}-{D}" for c, D in CELL_SIZES])
def test_search_stage_model_equals_plain(cell, D):
    """Every level of size D, seeded random LLRs with +-0 among them, three
    subframes (so some warps of 32 codewords span two): the staged floats
    equal the plain einsum's on the host bit for bit, none is -0."""
    _, sc = consts_of(TAIL_CELLS[cell])
    sub = only(sc, (D,))
    n_loc, B = len(sc.locs), 3
    assert any(w // n_loc != min(w + 31, B * n_loc - 1) // n_loc
               for w in range(0, B * n_loc, 32))
    assert {l for l, _ in sc.locs} == {0, 1, 2, 3}
    llr = random_llrs(TAIL_CELLS[cell], B, np.random.default_rng(D))
    got = search_stage_model(llr, sub)[0]
    want = pdcch_tail.derm_plain(torch.from_numpy(llr), sub, n_loc, B)[0]
    f32_equal(got, want.numpy(), f"{cell} D={D}")
    assert not np.signbit(got[got == 0]).any()


@pytest.mark.parametrize("D", SIZES20)
def test_search_stage_model_equals_plain_loaded_chunk(loaded_chunk, D):
    """The loaded cell's real LLRs of one search call: bit for bit with the
    plain version and with pdcch_derm's model."""
    llr, _, sc, n_loc, B, _ = loaded_chunk["args"]
    sub = only(sc, (D,))
    got = search_stage_model(llr.numpy(), sub)[0]
    f32_equal(got, pdcch_tail.derm_plain(llr, sub, n_loc, B)[0].numpy(),
              f"D={D}")
    f32_equal(got, derm_model(llr.numpy(), sub)[0], f"D={D} (derm model)")


def epilogue_model(bits: np.ndarray) -> np.ndarray:
    """The search entry's epilogue in numpy integers, every lane at once:
    from (N, D) bytes, (N, 3) u32 words: payload bits i < 32 and 32 <= i <
    L (L = D - 16) shifted in LSB first, then rnti | bit 0 << 16 with the
    CRC the XOR of crc_words[L - 1 - i] over the set payload bits i and
    the 16 received bits shifted in MSB first."""
    words = pdcch_tail.crc_words().view(np.uint32)
    bits = bits.astype(np.uint32)
    N, D = bits.shape
    L = D - 16
    p0, p1, c, rx = (np.zeros(N, np.uint32) for _ in range(4))
    for i in range(L):
        c ^= (np.uint32(0) - bits[:, i]) & words[L - 1 - i]
        if i < 32:
            p0 |= bits[:, i] << np.uint32(i)
        else:
            p1 |= bits[:, i] << np.uint32(i - 32)
    for i in range(16):
        rx = (rx << np.uint32(1)) | bits[:, L + i]
    meta = ((c ^ rx) & np.uint32(0xFFFF)) | (bits[:, 0] << np.uint32(16))
    return np.stack([p0, p1, meta], 1)


def pack_words_model(compact: np.ndarray, cce, scal, n_loc: int,
                     B: int) -> dict:
    """pdcch_pack in numpy integers, one value per fused word: candidate c
    = loc S + s reads words [s, b n_loc + loc]; an RNTI pair word two
    metas' low halves, a bitmap word 32 metas' bit 16, a payload word one
    payload word; the f16 words as pdcch_crc_pack's."""
    comp = compact.view(np.uint32)
    S = comp.shape[0]
    m = n_loc * S
    c = np.arange(m)
    rows = np.arange(B)[:, None] * n_loc + c[None, :] // S
    w = comp[c[None, :] % S, rows]                    # (B, m, 3)
    meta, pay = w[..., 2], w[..., :2]
    lay = pdcch_tail.fused_layout(n_loc, S, cce.shape[1], scal is not None)
    fused = np.zeros((B, lay["W"]), np.uint32)
    for k in range(lay["mp2"]):
        fused[:, k] = meta[:, 2 * k] & np.uint32(0xFFFF)
        if 2 * k + 1 < m:
            fused[:, k] |= (meta[:, 2 * k + 1] & np.uint32(0xFFFF)) << \
                np.uint32(16)
    for k in range(lay["mbw"]):
        for t in range(min(32, m - 32 * k)):
            fused[:, lay["mp2"] + k] |= ((meta[:, 32 * k + t] >> np.uint32(
                16)) & np.uint32(1)) << np.uint32(t)
    o = lay["mp2"] + lay["mbw"]
    fused[:, o:o + lay["ncw"]] = _pairs(_f16(cce))
    o += lay["ncw"]
    if scal is not None:
        fused[:, o:o + 2] = _pairs(_f16(scal))
        o += 2
    fused[:, o:] = pay.reshape(B, 2 * m)
    return dict(cand_fused=fused.view(np.int32),
                rnti=(meta & np.uint32(0xFFFF)).reshape(B, n_loc, S),
                cand_meta=meta.reshape(B, n_loc, S),
                pay=pay.reshape(B, n_loc, S, 2))


@pytest.mark.parametrize("n_prb", (6, 15, 25, 50, 100))
def test_epilogue_model_equals_compact_plain(n_prb):
    """The epilogue's words from random bits at every payload size of a
    4-port cell's fixed-CFI search (CFI 3): word for word."""
    ds, n_loc, _ = search_shape(n_prb, 3, 4)
    rng = np.random.default_rng(n_prb)
    bits = random_bits(ds, n_loc, 3, rng)
    got = pdcch_tail.compact_plain([torch.from_numpy(b) for b in bits])
    assert got.dtype == torch.int32 and tuple(got.shape) == (
        len(ds), 3 * n_loc, 3)
    want = np.stack([epilogue_model(b) for b in bits])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n_prb,cfi,ports", SWEEP,
                         ids=[f"{n}prb-cfi{c}-{p}port" for n, c, p in SWEEP])
def test_compact_then_pack_equals_crc_pack_plain(n_prb, cfi, ports):
    """compact_plain then pack_plain gives crc_pack_plain's cand_fused (with
    and without the scalars), RNTIs, meta and payload words word for word
    on the same bits: the two-launch route's packing is the earlier one."""
    ds, n_loc, nof_cce = search_shape(n_prb, cfi, ports)
    rng = np.random.default_rng(n_prb * 100 + cfi * 10 + ports + 7)
    B = 3
    bits = random_bits(ds, n_loc, B, rng)
    cce = np.abs(random_floats((B, nof_cce), rng))
    scal = random_floats((B, 4), rng)
    compact = pdcch_tail.compact_plain([torch.from_numpy(b) for b in bits])
    for sc_ in (None, scal):
        want = pack_plain(bits, cce, sc_, ds, n_loc, B)
        got = pdcch_tail.pack_plain(
            compact, torch.from_numpy(cce), n_loc, B,
            None if sc_ is None else torch.from_numpy(sc_))
        assert all(v.dtype == torch.int32 for v in got.values())
        np.testing.assert_array_equal(got["cand_fused"].numpy(),
                                      want["cand_fused"].numpy())
        np.testing.assert_array_equal(got["cand_meta"].numpy(),
                                      want["cand_meta"].numpy())
        np.testing.assert_array_equal(
            got["cand_pay"].numpy().view(np.uint32),
            want["cand_pay"].numpy().astype(np.uint32))
        for s, D in enumerate(ds):
            np.testing.assert_array_equal(got["rnti"][..., s].numpy(),
                                          want[f"rnti_{D}"].numpy())


@pytest.mark.parametrize("n_prb,cfi,ports", SWEEP,
                         ids=[f"{n}prb-cfi{c}-{p}port" for n, c, p in SWEEP])
def test_pack_words_model_equals_pack_plain(n_prb, cfi, ports):
    """The model of pdcch_pack (one value per fused word, every input a
    4-byte word) against pack_plain on random words (random metas, not
    only those a CRC gives): every output word for word."""
    ds, n_loc, nof_cce = search_shape(n_prb, cfi, ports)
    rng = np.random.default_rng(n_prb * 100 + cfi * 10 + ports + 9)
    B, S = 3, len(ds)
    comp = rng.integers(0, 1 << 32, (S, B * n_loc, 3), dtype=np.uint64)
    comp[..., 2] &= 0x1FFFF                 # rnti | bit 0 << 16
    comp = comp.astype(np.uint32).view(np.int32)
    cce = np.abs(random_floats((B, nof_cce), rng))
    scal = random_floats((B, 4), rng)
    for sc_ in (None, scal):
        want = pack_words_model(comp, cce, sc_, n_loc, B)
        got = pdcch_tail.pack_plain(
            torch.from_numpy(comp), torch.from_numpy(cce), n_loc, B,
            None if sc_ is None else torch.from_numpy(sc_))
        np.testing.assert_array_equal(got["cand_fused"].numpy(),
                                      want["cand_fused"])
        np.testing.assert_array_equal(got["rnti"].numpy(), want["rnti"])
        np.testing.assert_array_equal(
            got["cand_meta"].numpy().view(np.uint32), want["cand_meta"])
        np.testing.assert_array_equal(
            got["cand_pay"].numpy().view(np.uint32), want["pay"])


def test_route_models_give_the_tail_of_the_loaded_chunk(loaded_chunk):
    """The two-launch route, modelled end to end on the CPU (the staging
    model, the Viterbi's plain version, the epilogue model, the pack
    model), gives the plain tail's cand_fused word for word."""
    from ltesniffer_tpu_torch.kernels import viterbi
    llr, cce, sc, n_loc, B, scal = loaded_chunk["args"]
    staged = [torch.from_numpy(g) for g in search_stage_model(llr.numpy(),
                                                              sc)]
    bits = [b.numpy() for b in viterbi.viterbi_decode_tb_multi(staged)]
    comp = np.stack([epilogue_model(b) for b in bits]).view(np.int32)
    got = pack_words_model(comp, cce.numpy(), scal.numpy(), n_loc, B)
    np.testing.assert_array_equal(got["cand_fused"],
                                  loaded_chunk["out"]["cand_fused"].numpy())


def test_unified_search_reads_cand_fused_only(loaded_chunk):
    """The unified search asks the tail for cand_fused alone: no
    per-candidate words, no bits."""
    assert loaded_chunk["full"] is False
    assert list(loaded_chunk["out"]) == ["cand_fused"]


def _jax_tail(cell, ref_cell, seed):
    """Half-integer LLRs (every sum exact in any order), CCE powers and
    scalars of one small search call, and the JAX package's tail on
    them."""
    st, sc = consts_of(cell)
    ref_sc = ref_pdcch._size_consts_of(ref_pdcch._static_maps(ref_cell, 3))
    assert tuple(ref_sc) == tuple(sc)
    rng = np.random.default_rng(seed)
    B, n_loc = 3, len(st["locs"])
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    llr = (rng.integers(-12, 13, (B, n_bits)) / 2.0).astype(np.float32)
    cce = np.abs(rng.standard_normal((B, st["nof_cce"]))).astype(np.float32)
    scal = rng.standard_normal((B, 4)).astype(np.float32)
    want = jax.jit(lambda a, c, s: ref_pdcch._candidate_decode_tail(
        {}, a, c, ref_sc, n_loc, B, s))(jnp.asarray(llr), jnp.asarray(cce),
                                        jnp.asarray(scal))
    return [torch.from_numpy(x) for x in (llr, cce, scal)], sc, n_loc, B, \
        {k: np.asarray(v) for k, v in want.items()}


def test_route_plain_equals_jax():
    """The two-launch route's plain model (`route_plain`: derm_plain, the
    plain Viterbi, compact_plain, pack_plain) against the JAX package's
    tail on the same inputs: every output equal."""
    (llr, cce, scal), sc, n_loc, B, want = _jax_tail(
        CellConfig(n_id_cell=11, n_prb=15, nof_ports=2),
        RefCell(n_id_cell=11, n_prb=15, nof_ports=2), 5)
    got = pdcch_tail.route_plain(llr, cce, sc, n_loc, B, scal)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        if k in ("cand_pay", "cand_meta") or k.startswith("rnti_"):
            g = g.view(np.uint32).astype(np.int64)
            w = w.astype(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_route_plain_equals_decode_tail_plain():
    """route_plain against decode_tail_plain at the 25-PRB 4-port cell on
    random LLRs: the same keys in the same order, every word equal."""
    _, sc = consts_of(CELL25)
    B, n_loc = 4, len(sc.locs)
    rng = np.random.default_rng(25)
    llr = torch.from_numpy(random_llrs(CELL25, B, rng))
    cce = torch.from_numpy(np.abs(random_floats((B, 17), rng)))
    scal = torch.from_numpy(random_floats((B, 4), rng))
    got = pdcch_tail.route_plain(llr, cce, sc, n_loc, B, scal)
    want = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B, scal)
    assert list(got) == list(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if g.dtype == np.int32 and w.dtype == np.int64:
            g = g.view(np.uint32).astype(np.int64) if k != "cand_fused" \
                else g
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("full", [True, False])
def test_decode_tail_switch_on_cpu(full):
    """Without `full` the tail returns cand_fused alone; what it returns
    equals the plain tail's."""
    st, sc = consts_of(CellConfig(n_id_cell=3, n_prb=6, nof_ports=1))
    rng = np.random.default_rng(4)
    B, n_loc = 2, len(st["locs"])
    llr = torch.from_numpy((2.0 * rng.standard_normal(
        (B, 8 * (len(st["gather_idx"]) // 4)))).astype(np.float32))
    cce = torch.rand((B, st["nof_cce"]))
    got = pdcch_rx._candidate_decode_tail(llr, cce, sc, n_loc, B, full=full)
    want = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B)
    keys = list(want) if full else ["cand_fused"]
    assert list(got) == keys
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def _search_args():
    st, sc = consts_of(CellConfig(n_id_cell=3, n_prb=6, nof_ports=1))
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    return torch.zeros((2, n_bits)), sc, len(sc.locs), 2


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("strided", ValueError), ("shape", ValueError),
    ("consts", TypeError), ("n_loc", ValueError), ("short", ValueError),
    ("sizes", ValueError), ("d_small", ValueError), ("d_large", ValueError),
    ("unaligned", ValueError), ("cpu", ValueError)])
def test_search_wrapper_checks_before_a_launch(what, err):
    """viterbi_search_cuda refuses what the search entry does not take
    before it builds or launches anything (so it runs here on CPU
    tensors)."""
    from ltesniffer_tpu_torch.kernels import viterbi
    llr, sc, n_loc, B = _search_args()
    if what == "dtype":
        llr = llr.to(torch.float64)
    elif what == "strided":
        llr = torch.zeros((2, 2 * llr.shape[1]))[:, ::2]
    elif what == "shape":
        llr = llr[0]
    elif what == "consts":
        sc = dict(sc)
    elif what == "n_loc":
        n_loc += 1
    elif what == "short":
        llr = llr[:, :-8].contiguous()
    elif what == "sizes":
        sc = pdcch_tail.SizeConsts({}, sc.locs)
    elif what == "d_small":
        sc = pdcch_tail.SizeConsts({16: {}}, sc.locs)
    elif what == "d_large":
        sc = pdcch_tail.SizeConsts({17 + pdcch_tail.CRC_LEN: {}}, sc.locs)
    elif what == "unaligned":
        llr = torch.zeros(llr.numel() + 1)[1:].view(llr.shape)
    n0 = dict(viterbi.LAUNCHES)
    with pytest.raises(err, match="16-byte" if what == "unaligned" else None):
        viterbi.viterbi_search_cuda(llr, sc, n_loc, B)
    assert viterbi.LAUNCHES == n0


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("rows", ValueError), ("width", ValueError),
    ("sizes", ValueError), ("cce", TypeError), ("scalars", ValueError),
    ("strided", ValueError), ("cpu", ValueError), ("devices", ValueError)])
def test_pack_words_wrapper_checks_before_a_launch(what, err):
    """pack_cuda refuses what pdcch_pack does not take, inputs off a CUDA
    device or on two devices, before it builds or launches."""
    B, n_loc, S = 2, 10, 2
    comp = torch.zeros((S, B * n_loc, 3), dtype=torch.int32)
    cce = torch.zeros((B, 9))
    scal = torch.zeros((B, 4))
    if what == "dtype":
        comp = comp.to(torch.int64)
    elif what == "rows":
        comp = comp[:, :-1]
    elif what == "width":
        comp = comp[..., :2]
    elif what == "sizes":
        comp = torch.zeros((9, B * n_loc, 3), dtype=torch.int32)
    elif what == "cce":
        cce = cce.to(torch.float16)
    elif what == "scalars":
        scal = torch.zeros((B, 3))
    elif what == "strided":
        comp = torch.zeros((S, B * n_loc, 6), dtype=torch.int32)[..., ::2]
    elif what == "devices":
        cce = cce.to("meta")
    n0 = dict(pdcch_tail.LAUNCHES)
    with pytest.raises(err):
        pdcch_tail.pack_cuda(comp, cce, n_loc, B, scal)
    assert pdcch_tail.LAUNCHES == n0
    assert pdcch_tail._check_words(
        torch.zeros((S, B * n_loc, 3), dtype=torch.int32),
        torch.zeros((B, 9)), torch.zeros((B, 4)), n_loc, B) == S


def test_search_and_words_bounds_at_the_search_call():
    """The bounds' counts at one search call of the 20 MHz cell: the search
    entry reads the 1.55 MB of LLRs (not pdcch_derm's 37 MB buffer) and
    writes 2.9 MB of words; pdcch_pack reads 0.72 MB of words and writes
    the 0.62 MB of rows; the search entry's operations are the plain
    entry's plus the de-rate-match's adds and the epilogue's integer
    work."""
    from ltesniffer_tpu_torch.kernels import viterbi
    _, sc = consts_of(CELL20)
    B, n_loc, n_bits = 64, 157, 6056
    n = B * n_loc
    assert 4 * B * n_bits == 1_550_336
    tab = pdcch_tail.derm_tables_t(SIZES20)[0]
    assert pdcch_tail.search_bytes(B, n_bits, SIZES20, n_loc) == \
        1_550_336 + tab.nbytes + 4 * 157 + 4 * 64 + 12 * n * 6
    assert pdcch_tail.search_bytes(B, n_bits, SIZES20, n_loc) < 5_000_000
    assert pdcch_tail.search_ops(B, SIZES20, sc.locs) == \
        viterbi.ops([(n, D) for D in SIZES20]) + \
        pdcch_tail.derm_ops(B, SIZES20, sc.locs) + \
        pdcch_tail.pack_ops(B, SIZES20, n_loc)
    m = n_loc * 6
    assert pdcch_tail.words_bytes(B, 6, n_loc, 84, True) == \
        12 * B * m + 4 * B * 84 + 16 * B + 4 * B * 2429
    assert pdcch_tail.words_ops(B, 6, n_loc) == 7 * B * m
