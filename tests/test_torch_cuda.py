"""Tests of the port that need a CUDA card (marker `cuda`); they skip
without one.  This file imports neither JAX nor the reference package, so
it also runs on the card's machine, which has no JAX (tests/conftest.py
imports JAX, hence --noconftest there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8, 16, 32])
def test_bcjr_kernel_matches_twin(card, W):
    """One pass: kernel vs plain twin on the same card tensors, and one
    launch counted per call."""
    g = torch.Generator().manual_seed(W)
    L = 1024
    ins = [(torch.randn((W, L), generator=g) * 3.0).to(card)
           for _ in range(3)]
    ins += [torch.randn((8, L), generator=g).to(card) for _ in range(2)]
    n0 = bcjr.LAUNCHES["bcjr"]
    got = bcjr.bcjr(*ins)
    torch.cuda.synchronize()
    assert bcjr.LAUNCHES["bcjr"] == n0 + 1
    for a, b in zip(got, bcjr.bcjr_plain(*ins)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _coded(K, B, rng):
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    sent = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.stack([turbo_host.turbo_encode(b) for b in sent])
    x = 1.0 - 2.0 * d
    llr = (1.5 * x + rng.normal(size=d.shape)).astype(np.float32)
    prior = (0.8 * x + rng.normal(size=d.shape)).astype(np.float32)
    return sent, llr, prior


@pytest.mark.cuda
def test_decoder_on_card_equals_host(card):
    """The main-path decoder on the card (the fused kernel) and the lane
    decoder through the per-pass kernel decide the same bits as the
    decoder through the plain twin on the host."""
    rng = np.random.default_rng(0)
    K, B = 512, 16
    sent, llr, _ = _coded(K, B, rng)
    on_host, _ = turbo.make_decoder(K, 8)(torch.from_numpy(llr))
    np.testing.assert_array_equal(on_host.numpy(), sent)
    for dec in (turbo.make_decoder(K, 8), turbo.make_decoder_lanes(K, 8)):
        on_card, _ = dec(torch.from_numpy(llr).to(card))
        np.testing.assert_array_equal(on_card.cpu().numpy(), on_host.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [40, 512, 1824, 6144])
def test_fused_decode_equals_plain(card, K):
    """The fused whole-decode kernel against its plain version (the lane
    decoder over the plain twin, on the host): equal bits and LLRs, n_iter
    2 and 12, with and without a HARQ prior; one launch per call."""
    rng = np.random.default_rng(K)
    B = 3 if K == 6144 else 24
    sent, llr, prior = _coded(K, B, rng)
    for n_iter in (2, 12):
        for d in (llr, llr + prior):
            want_bits, want_llr = turbo.make_decoder(K, n_iter)(
                torch.from_numpy(d))
            n0 = turbo_decode.LAUNCHES["turbo_decode"]
            bits, out = turbo.make_decoder(K, n_iter)(
                torch.from_numpy(d).to(card))
            torch.cuda.synchronize()
            assert turbo_decode.LAUNCHES["turbo_decode"] == n0 + 1
            np.testing.assert_array_equal(bits.cpu().numpy(),
                                          want_bits.numpy())
            torch.testing.assert_close(out.cpu(), want_llr, rtol=0, atol=0)
        np.testing.assert_array_equal(bits.cpu().numpy(), sent)
