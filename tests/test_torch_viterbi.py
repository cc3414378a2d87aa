"""Port parity, tail-biting Viterbi: the port's `kernels/viterbi.py` against
the JAX package's (mirrors `tests/test_conv_viterbi.py`), and the contract
the CUDA kernel `csrc/viterbi_tb.cu` relies on, held on the plain version:
bits equal to the JAX package's at the blind search's payload sizes and on
ties, and front-pad invariance (a fused multi-size scan decodes each size
as its own call would, which lets the kernel run each codeword's own step
count).  The kernel itself is held against the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 2b)."""
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
