"""Port parity, tail-biting Viterbi: the port's `kernels/viterbi.py` against
the JAX package's (mirrors `tests/test_conv_viterbi.py`), and the contract
the CUDA kernel `csrc/viterbi_tb.cu` relies on, held on the plain version:
bits equal to the JAX package's at the blind search's payload sizes and on
ties, and front-pad invariance (a fused multi-size scan decodes each size
as its own call would, which lets the kernel run each codeword's own step
count), and a numpy model of the kernel's per-thread loop held equal to
the plain version.  The kernel itself is held against the plain version
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py` phase 2b)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.kernels import viterbi as ref_viterbi
from ltesniffer_tpu.phy import conv as ref_conv

from ltesniffer_tpu_torch.kernels import viterbi
from ltesniffer_tpu_torch.phy import conv, crc

torch.set_num_threads(1)

# the loaded cell's blind-search payload sizes (DCI + CRC16) and the MIB's
SEARCH_SIZES = (31, 44, 46, 55, 64, 67)
D_MIB = 40


def _ref_decode(llrs):
    return np.asarray(ref_viterbi.viterbi_decode_tb(jnp.asarray(llrs)))


def _decode(llrs):
    return viterbi.viterbi_decode_tb(torch.from_numpy(llrs)).numpy()


def test_encoder_matches_reference():
    """The port's batched encoder equals the JAX package's
    `conv_encode_tb_jax` and the numpy encoder, row by row."""
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, 2, size=(5, 43)).astype(np.uint8)
    got = viterbi.conv_encode_tb(torch.from_numpy(msgs))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (5, 3, 43)
    want = np.asarray(ref_viterbi.conv_encode_tb_jax(jnp.asarray(msgs)))
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(5):
        np.testing.assert_array_equal(got[i].numpy(),
                                      ref_conv.conv_encode_tb(msgs[i]))


def test_noiseless_roundtrip():
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 2, size=(8, 43)).astype(np.uint8)
    coded = viterbi.conv_encode_tb(torch.from_numpy(msgs)).numpy()
    llrs = (1.0 - 2.0 * coded.astype(np.float32))
    np.testing.assert_array_equal(_decode(llrs), msgs)


def test_rate_matching_with_noise():
    rng = np.random.default_rng(3)
    B, D, E = 16, 59, 4 * 72   # aggregation L=4
    msgs = rng.integers(0, 2, size=(B, D)).astype(np.uint8)
    rows = []
    for m in msgs:
        e = conv.rate_match(conv.conv_encode_tb(m), E)
        rows.append(1.0 - 2.0 * e.astype(np.float32))
    tx = np.stack(rows)
    noisy = tx + 0.5 * rng.standard_normal(tx.shape).astype(np.float32)
    llrs = np.stack([conv.de_rate_match(r, D) for r in noisy])
    np.testing.assert_array_equal(_decode(llrs), msgs)
    np.testing.assert_array_equal(_ref_decode(llrs), msgs)


def test_dci_crc_chain():
    """payload + CRC(rnti) -> conv -> RM -> decode -> RNTI."""
    rng = np.random.default_rng(4)
    payload_len, E = 27, 2 * 72
    rnti = 0xC0FE
    payload = rng.integers(0, 2, payload_len).astype(np.uint8)
    tb = crc.attach_crc(payload, crc.CRC16, mask=rnti)
    D = len(tb)
    e = conv.rate_match(conv.conv_encode_tb(tb), E)
    llr = (1.0 - 2.0 * e.astype(np.float32)) + \
        0.3 * rng.standard_normal(E).astype(np.float32)
    bits = _decode(conv.de_rate_match(llr, D)[None])[0]
    got_rnti = crc.bits_to_int(crc.crc_bits(bits[:payload_len], crc.CRC16)
                               ^ bits[payload_len:])
    assert got_rnti == rnti
    np.testing.assert_array_equal(bits[:payload_len], payload)


def test_wrong_bits_fail_crc():
    """Random noise must not produce the target RNTI."""
    rng = np.random.default_rng(5)
    llr = rng.standard_normal((32, 3, 43)).astype(np.float32)
    bits = _decode(llr)
    hits = sum(crc.bits_to_int(crc.crc_bits(row[:27], crc.CRC16) ^ row[27:])
               == 0x1234 for row in bits)
    assert hits == 0


@pytest.mark.parametrize("D", SEARCH_SIZES + (D_MIB,))
def test_plain_equals_reference_at_main_sizes(D):
    """Noisy codewords and pure noise at each payload size of the loaded
    cell's search (D = 31 clamps the wrap to 31) and at the MIB's: bits
    equal to the JAX package's."""
    rng = np.random.default_rng(D)
    msgs = rng.integers(0, 2, size=(12, D)).astype(np.uint8)
    coded = viterbi.conv_encode_tb(torch.from_numpy(msgs)).numpy()
    noisy = (1.0 - 2.0 * coded.astype(np.float32)) + \
        1.2 * rng.standard_normal(coded.shape).astype(np.float32)
    llrs = np.concatenate([noisy, 2.0 * rng.standard_normal(
        (12, 3, D)).astype(np.float32)])
    np.testing.assert_array_equal(_decode(llrs), _ref_decode(llrs))


@pytest.mark.parametrize("fill", [0.0, 1.0, -0.75])
def test_plain_equals_reference_on_ties(fill):
    """Zero and constant LLRs (every state or every path ties): the
    tie-break (j = 0, first maximum) equals the JAX package's."""
    for D in (D_MIB, 31):
        llrs = np.full((3, 3, D), fill, np.float32)
        np.testing.assert_array_equal(_decode(llrs), _ref_decode(llrs))


@pytest.mark.parametrize("seed", range(6))
def test_front_pad_invariance(seed):
    """The fused multi-size scan (shorter codewords zero-padded at the
    front) equals each group decoded on its own, for random payload sizes
    of 8-80: the property that lets the kernel skip the pad."""
    rng = np.random.default_rng(100 + seed)
    ds = rng.integers(8, 81, size=3)
    groups = [torch.from_numpy((rng.standard_normal((int(n), 3, int(d)))
                                * rng.uniform(0.5, 3.0)).astype(np.float32))
              for n, d in zip(rng.integers(1, 9, size=3), ds)]
    fused = viterbi.viterbi_decode_tb_multi(groups)
    for g, got in zip(groups, fused):
        np.testing.assert_array_equal(got.numpy(),
                                      viterbi.viterbi_decode_tb(g).numpy())


def test_cpu_tensor_runs_plain_version():
    """A CPU tensor takes the plain step loop: no kernel launch, no build,
    and the plain-on-CUDA counter stays put."""
    rng = np.random.default_rng(7)
    groups = [torch.from_numpy(rng.standard_normal((4, 3, d)).astype(
        np.float32)) for d in (31, 67)]
    n0, p0 = viterbi.LAUNCHES["viterbi"], viterbi.PLAIN_CUDA["viterbi"]
    out = viterbi.viterbi_decode_tb_multi(groups)
    viterbi.viterbi_decode_tb(groups[0])
    assert [tuple(o.shape) for o in out] == [(4, 31), (4, 67)]
    assert viterbi.LAUNCHES["viterbi"] == n0
    assert viterbi.PLAIN_CUDA["viterbi"] == p0


def test_kernel_wrapper_refuses_bad_input():
    """The kernel's wrapper rejects what the kernel does not take before
    it builds or launches anything."""
    viterbi._library.cache_clear()
    x = torch.zeros((4, 3, 40), dtype=torch.float32)
    n0 = viterbi.LAUNCHES["viterbi"]
    with pytest.raises(TypeError, match="float32"):
        viterbi.viterbi_tb_cuda([x.double()])
    with pytest.raises(ValueError, match="contiguous"):
        viterbi.viterbi_tb_cuda([torch.zeros((4, 40, 3)).transpose(1, 2)])
    with pytest.raises(ValueError, match="groups"):
        viterbi.viterbi_tb_cuda([x] * (viterbi.MAX_GROUPS + 1))
    with pytest.raises(ValueError, match="shape"):
        viterbi.viterbi_tb_cuda([torch.zeros((4, 2, 40))])
    with pytest.raises(ValueError, match="not one CUDA device"):
        viterbi.viterbi_tb_cuda([x])
    assert viterbi.LAUNCHES["viterbi"] == n0
    assert viterbi._library.cache_info().currsize == 0


def test_bound_counts():
    """bytes_moved / ops of one search call at the main shape (64
    subframes x 157 locations per size)."""
    shapes = [(10048, d) for d in SEARCH_SIZES]
    steps = sum(n * (d + 2 * min(32, d)) for n, d in shapes)
    assert steps == 10048 * (93 + 108 + 110 + 119 + 128 + 131)
    assert viterbi.ops(shapes) == viterbi.OPS_PER_STEP * steps
    assert viterbi.bytes_moved(shapes) == 13 * 10048 * sum(SEARCH_SIZES)


# ---------------------------------------------------------------------------
# a numpy model of one thread's loop in csrc/viterbi_tb.cu (one codeword per
# thread), vectorised over the codewords of a group
# ---------------------------------------------------------------------------
def _kernel_branches():
    """For each (input b, pair m, j) of the butterfly: the index of the
    branch sum among base = [(l0+l1)+l2, (l0+l1)-l2, (l0-l1)+l2,
    (l0-l1)-l2] and whether the branch is its negation (the kernel then
    subtracts it), from the register (b << 6) | (2m + j)."""
    reg = (np.arange(2)[:, None, None] << 6) | \
        (2 * np.arange(32)[None, :, None] + np.arange(2)[None, None, :])
    o0, o1, o2 = (np.vectorize(lambda r, g=g: bin(r & g).count("1") & 1)(reg)
                  for g in (0o133, 0o171, 0o165))
    return ((o1 ^ o0) << 1) | (o2 ^ o0), o0.astype(bool)


def _kernel_model(llr, wrap=32):
    """bits (N, D) of the kernel's loop for llr (N, 3, D) float32: the
    codeword's own T = D + 2w steps over columns (s - w) mod D, 4 branch
    sums and their negations, the step's maximum from the entering
    metrics (max over branch sums i of Q_i + |base_i|), the select as a
    maximum and the decision as the sign bit of cand0 - cand1, decisions
    packed into two u32 words and kept only from step w, the first zero
    metric as the start state, the traceback over the kept decisions."""
    N, _, D = llr.shape
    w = min(wrap, D)
    idx, neg = _kernel_branches()                      # (2, 32, 2)
    groups = [idx[0, :, 0] == i for i in range(4)]     # butterflies on sum i
    shift = np.arange(32, dtype=np.uint64)
    pm = np.zeros((N, 64), np.float32)
    dec = np.zeros((D + w, N, 2), np.uint32)
    for s in range(D + 2 * w):
        c = (s - w) % D
        l0, l1, l2 = llr[:, 0, c], llr[:, 1, c], llr[:, 2, c]
        a, b = l0 + l1, l0 - l1
        base = np.stack([a + l2, a - l2, b + l2, b - l2], axis=1)
        pair = pm.reshape(N, 32, 2).max(-1)            # per butterfly
        mx = np.stack([pair[:, g].max(-1) + np.abs(base[:, i])
                       for i, g in enumerate(groups)], axis=1).max(-1)
        bv = base[:, idx]                              # (N, 2, 32, 2)
        p = pm.reshape(N, 1, 32, 2)
        cand = np.where(neg, p - bv, p + bv)
        e = np.signbit(cand[..., 0] - cand[..., 1])    # (N, 2, 32)
        nw = np.maximum(cand[..., 0], cand[..., 1]).reshape(N, 64)
        pm = nw - mx[:, None]
        if s >= w:
            dec[s - w] = (e.astype(np.uint64) << shift).sum(-1) \
                .astype(np.uint32)
    st = np.argmax(pm == 0, axis=1)                    # first zero
    bits = np.zeros((N, D), np.uint8)
    for t in range(D + 2 * w - 1, w - 1, -1):
        if t < w + D:
            bits[:, t - w] = st >> 5
        word = np.where(st >= 32, dec[t - w, :, 1], dec[t - w, :, 0])
        st = ((st & 31) << 1) | ((word >> (st & 31)) & 1)
    return bits


def _model_vs_plain(groups):
    want = viterbi.viterbi_decode_tb_multi_plain(
        [torch.from_numpy(g) for g in groups])
    for g, b in zip(groups, want):
        np.testing.assert_array_equal(_kernel_model(g), b.numpy())


@pytest.mark.parametrize("D", SEARCH_SIZES + (D_MIB,))
def test_kernel_model_equals_plain(D):
    """The kernel's per-thread loop, modelled in numpy float32, equals the
    plain fused scan bit for bit at each search size and the MIB's, on
    noisy codewords and pure noise, in a call with a second size."""
    rng = np.random.default_rng(500 + D)
    msgs = rng.integers(0, 2, size=(24, D)).astype(np.uint8)
    coded = viterbi.conv_encode_tb(torch.from_numpy(msgs)).numpy()
    noisy = (1.0 - 2.0 * coded.astype(np.float32)) + \
        1.2 * rng.standard_normal(coded.shape).astype(np.float32)
    llrs = np.concatenate([noisy, 2.0 * rng.standard_normal(
        (40, 3, D)).astype(np.float32)]).astype(np.float32)
    other = (2.0 * rng.standard_normal((9, 3, 67 if D != 67 else 31))) \
        .astype(np.float32)
    _model_vs_plain([llrs, other])


@pytest.mark.parametrize("fill", [0.0, 1.0, -0.75])
def test_kernel_model_on_ties(fill):
    """Constant LLRs (every state or every path ties) at the search sizes,
    the MIB's and D = 5 (a wrap too short to hide the start state) in one
    call: the model's strict compare and first zero metric give the plain
    version's bits."""
    _model_vs_plain([np.full((3, 3, d), fill, np.float32)
                     for d in SEARCH_SIZES + (D_MIB, 5)])


@pytest.mark.parametrize("name", ["warps2", "warps4", "unsorted", "l1"])
def test_variants_patch_the_source(name):
    """Each variant of `kernels/viterbi_variants.py` still finds what it
    changes in the kernel's source (it raises where an edit moved it), and
    changes nothing else: the kernel's launch entry stays."""
    from ltesniffer_tpu_torch.kernels import viterbi_variants
    src = open(viterbi.SRC).read()
    out = viterbi_variants.VARIANTS[name](src)
    assert out != src
    assert 'extern "C" int viterbi_tb_launch(' in out
    assert viterbi_variants.VARIANTS["kernel"](src) == src
