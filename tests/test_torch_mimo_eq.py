"""The two-codeword grant's equalize + demap + descramble
(`kernels/mimo_eq.py`): its plain version against the JAX package's
`sniffer/pdsch_rx.py:_eq_demap_mimo_fn`, a numpy model of the CUDA
kernel's per-RE arithmetic (`csrc/mimo_eq_demap.cu`) and of its Gold
table against the plain version, the wrapper's CPU dispatch and checks,
and `decode_grant_mimo` through the wrapper.

The grants and the tolerance are `testing/mimo_grants.py`'s: rtol 1e-4
plus atol 5e-4 of the peak, as tests/test_torch_mimo.py states for the
decode's LLRs (the 2x2 MMSE solve amplifies rounding differences on
ill-conditioned REs).  Gold bits are integer arithmetic and equal
exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdsch_rx as ref_pdsch

from ltesniffer_tpu_torch.kernels import mimo, mimo_eq
from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod, sequences
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx
from ltesniffer_tpu_torch.testing import mimo_grants

torch.set_num_threads(1)

RTOL, ATOL = mimo_grants.RTOL, mimo_grants.ATOL_PEAK
N_SC = 72                      # 6 PRB: L = 14 * 72 = 1008 REs a plane
L = 14 * N_SC

CASES = mimo_grants.VARIANTS
IDS = [mimo_grants.variant_id(c) for c in CASES]


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * peak)


def make_inputs(tm, ports, pmi, qm0, qm1, n_re, rx, seed=0):
    return mimo_grants.random_grant((tm, ports, pmi, qm0, qm1, n_re, rx),
                                    seed, N_SC)


def plain(inp, tm, pmi, qm0, qm1):
    grid, h, nv, idx, ci = inp
    return mimo_eq.eq_demap_mimo_plain(
        torch.from_numpy(grid), torch.from_numpy(h), torch.tensor(nv),
        torch.from_numpy(idx), ci[0], ci[1], tm, pmi, qm0,
        qm1).numpy()


# ---------------------------------------------------------------------------
# the plain version against the JAX program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tm,ports,pmi,qm0,qm1,n_re,rx", CASES, ids=IDS)
def test_plain_matches_jax(tm, ports, pmi, qm0, qm1, n_re, rx):
    inp = make_inputs(tm, ports, pmi, qm0, qm1, n_re, rx)
    grid, h, nv, idx, ci = inp
    ref_cell = RefCell(n_id_cell=301, n_prb=N_SC // 12, nof_ports=ports,
                       nof_rx_ant=rx)
    fn = ref_pdsch._eq_demap_mimo_fn(ref_cell, qm0, qm1, len(idx), tm, pmi)
    want = fn(jnp.asarray(grid), jnp.asarray(h), jnp.asarray(nv),
              jnp.asarray(idx.astype(np.int32)),
              jnp.asarray(np.uint32(ci[0])), jnp.asarray(np.uint32(ci[1])))
    want = np.concatenate([np.asarray(w) for w in want])
    got = plain(inp, tm, pmi, qm0, qm1)
    assert got.shape == (len(idx) * (qm0 + qm1),)
    close(got, want)
    # the descramble is sign for sign the same
    big = np.abs(want) > 1e-3 * np.max(np.abs(want))
    np.testing.assert_array_equal(np.sign(got[big]), np.sign(want[big]))


# ---------------------------------------------------------------------------
# a numpy model of the kernel's per-RE arithmetic
# ---------------------------------------------------------------------------
def _apply(hr, hi, wr, wi):
    """The kernel's apply<P>: hr, hi (P, n); wr, wi (P, 2, n) ->
    (out_r (2, n), out_i (2, n)); sums over p in order, then rr - ii,
    ri + ir, every operation rounded to float32."""
    outr, outi = [], []
    for l in range(2):
        rr, ii = hr[0] * wr[0, l], hi[0] * wi[0, l]
        ri, ir = hr[0] * wi[0, l], hi[0] * wr[0, l]
        for p in range(1, hr.shape[0]):
            rr = rr + hr[p] * wr[p, l]
            ii = ii + hi[p] * wi[p, l]
            ri = ri + hr[p] * wi[p, l]
            ir = ir + hi[p] * wr[p, l]
        outr.append(rr - ii)
        outi.append(ri + ir)
    return np.stack(outr), np.stack(outi)


def gold_bits_model(c_init: int, n_bits: int) -> np.ndarray:
    """The kernel's Gold bits: popc((c_init | 1 << 31) & word) & 1."""
    words = mimo_eq.gold_words(n_bits)
    c = np.uint32((c_init & 0x7FFFFFFF) | 0x80000000)
    x = words & c
    bits = np.zeros(n_bits, np.uint32)
    for k in range(32):
        bits ^= (x >> np.uint32(k)) & np.uint32(1)
    return bits.astype(np.uint8)


def _demap_model(xr, xi, qm, scale, inv, divide=False):
    """The kernel's demap_store before the sign: (n, qm) LLRs.  `divide`:
    divide by the scale, as PyTorch does on the CPU, instead of the
    kernel's multiply by its float32 reciprocal (PyTorch's form for a CUDA
    tensor divided by a scalar)."""
    s = qm // 2 - 1
    re, im = xr * scale[s], xi * scale[s]
    if qm == 2:
        return np.stack([re, im], -1)
    top = np.float32({4: 2.0, 6: 4.0, 8: 8.0}[qm])
    v = [re, im, top - np.abs(re), top - np.abs(im)]
    if qm >= 6:
        mid = np.float32(2.0 if qm == 6 else 4.0)
        v += [mid - np.abs(v[2]), mid - np.abs(v[3])]
    if qm == 8:
        v += [np.float32(2.0) - np.abs(v[4]), np.float32(2.0) - np.abs(v[5])]
    if divide:
        return np.stack(v, -1) / scale[s]
    return np.stack(v, -1) * inv[s]


def kernel_model(inp, tm, pmi, qm0, qm1, divide=False):
    """mimo_eq_demap_kernel, thread by thread (vectorized over the REs),
    in float32 numpy: one rounding per operation, as under --fmad=false
    (`divide`: see _demap_model)."""
    grid, h, nv, idx, ci = inp
    rx, ports = h.shape[0], h.shape[1]
    n_pad = len(idx)
    consts, n_cycle, cdd = mimo_eq.constants(tm, pmi, ports)
    mats = consts[:6 * 16].reshape(6, 2, 4, 2)       # [mat][re|im][p][l]
    scale, inv = consts[96:100], consts[100:104]
    i = np.arange(n_pad)
    k = (i >> 1) & 3 if n_cycle == 4 else np.zeros(n_pad, np.int64)
    sign = np.where(i & 1, np.float32(-1.0), np.float32(1.0))
    wr = np.moveaxis(mats[k, 0, :ports], 0, -1)       # (P, 2, n)
    wi = np.moveaxis(mats[k, 1, :ports], 0, -1)
    t0 = [np.repeat(mats[4, c, :2, :, None], n_pad, -1) for c in (0, 1)]
    t1 = [np.repeat(mats[5, c, :2, :, None], n_pad, -1) for c in (0, 1)]
    h0, h1, y = [], [], []
    for r in range(rx):
        y.append((grid[r, idx, 0], grid[r, idx, 1]))
        er, ei = _apply(h[r, :, idx, 0].T, h[r, :, idx, 1].T, wr, wi)
        if cdd:
            ar, ai = _apply(er, ei, *t0)
            br, bi = _apply(er, ei, *t1)
            er, ei = ar + br * sign, ai + bi * sign
        h0.append((er[0], ei[0]))
        h1.append((er[1], ei[1]))
    acc = None
    for r in range(rx):
        (yr, yi), (ar_, ai_), (br_, bi_) = y[r], h0[r], h1[r]
        v = [ar_ * ar_ + ai_ * ai_, br_ * br_ + bi_ * bi_,
             br_ * ar_ + bi_ * ai_, bi_ * ar_ - br_ * ai_,
             yr * ar_ + yi * ai_, yi * ar_ - yr * ai_,
             yr * br_ + yi * bi_, yi * br_ - yr * bi_]
        acc = v if acc is None else [s + t for s, t in zip(acc, v)]
    a, d, b_r, b_i, z0r, z0i, z1r, z1i = acc
    a, d = a + nv, d + nv
    det = a * d - (b_r * b_r + b_i * b_i)
    inv_det = np.float32(1.0) / np.where(det < np.float32(1e-12),
                                         np.float32(1e-12), det)
    x0r = (z0r * d - (b_r * z1r - b_i * z1i)) * inv_det
    x0i = (z0i * d - (b_r * z1i + b_i * z1r)) * inv_det
    nbi = -b_i
    x1r = (z1r * a - (b_r * z0r - nbi * z0i)) * inv_det
    x1i = (z1i * a - (b_r * z0i + nbi * z0r)) * inv_det
    outs = []
    for (xr, xi), qm, c in (((x0r, x0i), qm0, ci[0]),
                            ((x1r, x1i), qm1, ci[1])):
        v = _demap_model(xr, xi, qm, scale, inv, divide).reshape(-1)
        bits = gold_bits_model(c, n_pad * qm)
        outs.append(np.where(bits == 1, -v, v))
    return np.concatenate(outs).astype(np.float32)


@pytest.mark.parametrize("tm,ports,pmi,qm0,qm1,n_re,rx", CASES, ids=IDS)
def test_kernel_model_matches_plain(tm, ports, pmi, qm0, qm1, n_re, rx):
    inp = make_inputs(tm, ports, pmi, qm0, qm1, n_re, rx, seed=1)
    got = kernel_model(inp, tm, pmi, qm0, qm1)
    close(got, plain(inp, tm, pmi, qm0, qm1))


TWO_PORT = [(c, i) for c, i in zip(CASES, IDS) if c[1] == 2]


@pytest.mark.parametrize("case", [c for c, _ in TWO_PORT],
                         ids=[i for _, i in TWO_PORT])
def test_kernel_model_bit_exact_on_two_ports(case):
    """With 2 ports every constant-matrix sum has at most one inexact
    product, so the kernel's order of operations gives the plain
    version's floats exactly: the model, dividing by the demapper's scale
    as PyTorch does on the CPU, equals the plain version bit for bit."""
    tm, ports, pmi, qm0, qm1, n_re, rx = case
    inp = make_inputs(*case, seed=3)
    np.testing.assert_array_equal(
        kernel_model(inp, tm, pmi, qm0, qm1, divide=True),
        plain(inp, tm, pmi, qm0, qm1))


@pytest.mark.parametrize("n_bits", [1, 31, 512, 2048 * 8, 6144 + 5])
def test_kernel_gold_bits_equal(n_bits):
    """The kernel's table-and-parity Gold bits equal the plain version's
    `gold_sequence_torch` bit for bit, for c_init with bit 30 set too."""
    for c in (0, 1, 0x5151 << 14 | 3 << 9 | 301, 0x7FFFFFFF,
              pdsch_mod.scrambling_cinit(0xFFF3, 1, 9, 503)):
        want = sequences.gold_sequence_torch(
            torch.tensor(c, dtype=torch.int64), n_bits).numpy()
        np.testing.assert_array_equal(gold_bits_model(c, n_bits), want)


def test_gold_words_are_the_basis():
    x1, basis = sequences.gold_basis(4000)
    w = mimo_eq.gold_words(4000)
    m = np.zeros(4000, np.uint32)
    for k in range(31):
        m |= basis[k].astype(np.uint32) << np.uint32(k)
    np.testing.assert_array_equal(w & np.uint32(0x7FFFFFFF), m)
    np.testing.assert_array_equal(w >> np.uint32(31), x1)


def test_gold_table_grows_once_per_device():
    mimo_eq._GOLD.pop("cpu", None)
    t1 = mimo_eq.gold_table(1000, "cpu")
    assert t1.dtype == torch.int32 and t1.numel() == 4096
    assert mimo_eq.gold_table(4096, "cpu") is t1
    t2 = mimo_eq.gold_table(5000, "cpu")
    assert t2.numel() == 8192
    np.testing.assert_array_equal(t2[:4096].numpy(), t1.numpy())
    np.testing.assert_array_equal(t2.numpy().view(np.uint32),
                                  mimo_eq.gold_words(8192))


@pytest.mark.parametrize("tm,ports,pmi", [(4, 2, 0), (4, 2, 2), (4, 4, 7),
                                          (3, 2, 0), (3, 4, 0)])
def test_constants_are_the_port_precoders(tm, ports, pmi):
    """The kernel's constant block holds the matrices kernels/mimo.py
    applies, and the demapper's scales and their float32 reciprocals."""
    consts, n_cycle, cdd = mimo_eq.constants(tm, pmi, ports)
    mats = consts[:96].reshape(6, 2, 4, 2)
    if tm == 4:
        want = [mimo.pmi_matrix_2layer_4tx(pmi) if ports == 4
                else mimo.pmi_matrix_2layer(pmi)]
    elif ports == 4:
        want = [mimo.pmi_matrix_2layer_4tx(12 + k) for k in range(4)]
    else:
        want = [mimo._W_CDD]
    assert (n_cycle, cdd) == (len(want), int(tm == 3))
    for k in range(4):
        # kernels/mimo.py applies each matrix as complex64
        w = np.asarray(want[k % len(want)], np.complex64)
        np.testing.assert_array_equal(mats[k, 0, :ports], np.real(w))
        np.testing.assert_array_equal(mats[k, 1, :ports], np.imag(w))
        np.testing.assert_array_equal(mats[k, :, ports:], 0.0)
    for t, row in ((4, 0), (5, 1)):
        want_t = np.zeros((2, 2), np.complex64)
        want_t[row] = mimo._U_CDD[row]
        np.testing.assert_array_equal(mats[t, 0, :2], np.real(want_t))
        np.testing.assert_array_equal(mats[t, 1, :2], np.imag(want_t))
    np.testing.assert_array_equal(consts[96:100], mimo_eq.SCALES)
    np.testing.assert_array_equal(consts[100:104],
                                  np.float32(1.0) / mimo_eq.SCALES)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [CASES[1], CASES[8]],
                         ids=[IDS[1], IDS[8]])
def test_wrapper_takes_plain_version_on_cpu(case):
    """A CPU tensor takes the plain version: the same floats, no launch
    and no plain run on a card counted."""
    tm, ports, pmi, qm0, qm1, n_re, rx = case
    inp = make_inputs(*case, seed=2)
    grid, h, nv, idx, ci = inp
    mimo_eq.reset_launches()
    got = mimo_eq.eq_demap_mimo(torch.from_numpy(grid), torch.from_numpy(h),
                                torch.tensor(nv), torch.from_numpy(idx),
                                ci[0], ci[1], tm, pmi, qm0, qm1)
    np.testing.assert_array_equal(got.numpy(), plain(inp, tm, pmi, qm0, qm1))
    assert mimo_eq.LAUNCHES["mimo_eq_demap"] == 0
    assert mimo_eq.PLAIN_CUDA["mimo_eq_demap"] == 0


def test_wrapper_refuses_other_devices():
    x = torch.zeros((2, L, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mimo_eq.eq_demap_mimo(x, x, x, x, 0, 0, 4, 0, 2, 2)


@pytest.mark.parametrize("what,err", [
    ("tm", ValueError), ("qm", ValueError), ("rx", ValueError),
    ("ports", ValueError), ("pmi", ValueError), ("dtype", TypeError),
    ("strided", ValueError), ("noise", ValueError), ("index", ValueError)])
def test_wrapper_checks_what_the_kernel_does_not_take(what, err):
    """The checks the CUDA route makes before a launch (run here on CPU
    tensors: they need no card)."""
    grid = torch.zeros((2, L, 2))
    h = torch.zeros((2, 2, L, 2))
    nv = torch.tensor(0.1)
    idx = torch.zeros(256, dtype=torch.int64)
    args = dict(tm=4, pmi=0, qm0=2, qm1=4)
    if what == "tm":
        args["tm"] = 2
    elif what == "qm":
        args["qm1"] = 3
    elif what == "rx":
        grid, h = torch.zeros((3, L, 2)), torch.zeros((3, 2, L, 2))
    elif what == "ports":
        h = torch.zeros((2, 1, L, 2))
    elif what == "pmi":
        args["pmi"] = 3
    elif what == "dtype":
        idx = idx.to(torch.int32)
    elif what == "strided":
        h = torch.zeros((2, 2, 2 * L, 2))[:, :, ::2]
    elif what == "noise":
        nv = torch.zeros(2)
    elif what == "index":
        idx = torch.zeros((2, 128), dtype=torch.int64)
    with pytest.raises(err):
        mimo_eq._check(grid, h, nv, idx, **args)
    # and the inputs as they should be pass
    mimo_eq._check(torch.zeros((2, L, 2)), torch.zeros((2, 4, L, 2)),
                   torch.tensor(0.1), torch.zeros(256, dtype=torch.int64),
                   tm=4, pmi=15, qm0=8, qm1=2)


def test_bytes_moved():
    # 2 RX x (1 + 2 ports) complex values of 8 bytes per RE, the index,
    # the noise, and 4 bytes per LLR written
    assert mimo_eq.bytes_moved(1000, 1024, 2, 2, 4, 6) == \
        2 * 3 * 8 * 1000 + 8 * 1024 + 4 + 4 * 1024 * 10


# ---------------------------------------------------------------------------
# decode_grant_mimo through the wrapper
# ---------------------------------------------------------------------------
def test_mimo_re_index_cached_per_grant_shape():
    """The grant's padded RE index is built and uploaded once per
    (subframe, CFI, PRB mask, device), and equals grant_re_indices."""
    cell = CellConfig(n_id_cell=93, n_prb=50, nof_ports=2, nof_rx_ant=2)
    mask = np.zeros(50, bool)
    mask[5:25] = True
    pdsch_rx._mimo_index.cache_clear()
    n_re, n_pad, idx = pdsch_rx._mimo_re_index(cell, 2, 2, mask, "cpu")
    want = pdsch_mod.grant_re_indices(cell, 2, 2, mask)
    assert n_re == len(want) and n_pad == pdsch_rx._bucket(n_re)
    assert n_pad % pdsch_rx.RE_BUCKET == 0
    np.testing.assert_array_equal(idx[:n_re].numpy(), want)
    assert (idx[n_re:] == int(want[-1])).all()
    assert pdsch_rx._mimo_re_index(cell, 2, 2, mask.copy(), "cpu")[2] is idx
    other = pdsch_rx._mimo_re_index(cell, 3, 2, mask, "cpu")
    assert other[2] is not idx
    assert pdsch_rx._mimo_index.cache_info().currsize == 2


def test_decode_grant_mimo_uses_one_buffer(monkeypatch):
    """decode_grant_mimo makes one eq/demap call per grant and splits its
    one buffer at n_pad * qm0 (the JAX package's two outputs)."""
    calls = []
    real = mimo_eq.eq_demap_mimo

    def spy(*a):
        out = real(*a)
        calls.append((a, out))
        return out
    monkeypatch.setattr(mimo_eq, "eq_demap_mimo", spy)
    cell = CellConfig(n_id_cell=93, n_prb=25, nof_ports=2, nof_rx_ant=2)
    rng = np.random.default_rng(4)
    grids = torch.from_numpy(rng.normal(size=(1, 2, 14, 300, 2))
                             .astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(1, 2, 2, 14, 300, 2))
                         .astype(np.float32))
    nv = torch.tensor([0.05])
    mask = np.zeros(25, bool)
    mask[3:9] = True
    res = pdsch_rx.decode_grant_mimo(grids, h, nv, 0, cell, 4, 2,
                                     rnti=0x4242, prb_mask=mask, qms=(2, 6),
                                     tbss=(200, 400), tm=4, pmi=1)
    assert len(calls) == 1 and len(res) == 2
    args, out = calls[0]
    n_pad = args[3].shape[0]
    assert out.shape == (n_pad * 8,)
    assert args[4:] == (pdsch_mod.scrambling_cinit(0x4242, 0, 4, 93),
                        pdsch_mod.scrambling_cinit(0x4242, 1, 4, 93),
                        4, 1, 2, 6)
    assert not any(r.crc_ok for r in res)     # noise: both codewords fail


def test_max_err_holds_the_tolerance():
    """mimo_grants.max_err, which phase 2c and the card tests hold the
    kernel with: rtol 1e-4 of each value plus atol 5e-4 of the peak."""
    want = np.array([10.0, -2.0, 0.0], np.float32)
    edge = 5e-4 * 10.0 + 1e-4 * 2.0
    got = want + np.array([0.0, edge * 0.99, 0.0], np.float32)
    err, ok = mimo_grants.max_err(torch.from_numpy(got), want)
    assert ok and err == pytest.approx(edge * 0.99, rel=1e-3)
    got = want + np.array([0.0, edge * 1.01, 0.0], np.float32)
    assert not mimo_grants.max_err(got, want)[1]
    assert mimo_grants.max_err(got[:2], want) == (float("inf"), False)
