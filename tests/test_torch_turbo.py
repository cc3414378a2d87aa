"""Port parity, turbo decoder: the plain twin of the hand-written CUDA BCJR
kernel against the TPU kernel it replaces (`turbo_pallas.make_bcjr`, run
in interpret mode), and the port's lane decoder (the plain version of the
fused whole-decode kernel) against the JAX package's Pallas-driven and
default windowed decoders and the sent bits.  What of the CUDA kernels
can be checked without a card is checked here: their trellis tables, the
fused kernel's QPP walk and launch geometry, the build flags, and the
wrappers' input checks.

Tolerance: one BCJR pass agrees within 1e-5 (the twin forms every sum in
the TPU kernel's order); decoded bits are equal.  The CUDA kernels
themselves run only on the card: tests/test_torch_cuda.py and
chip_smoke.py.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.kernels import turbo as ref_turbo, turbo_pallas
from ltesniffer_tpu.phy import turbo as ref_turbo_host

from ltesniffer_tpu_torch.kernels import bcjr, nvcc_build, turbo
from ltesniffer_tpu_torch.kernels import turbo_decode
from ltesniffer_tpu_torch.phy import tables, tables_data

torch.set_num_threads(1)


def _rand(rng, *shape, scale=3.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("W", [8, 16, 32])
def test_bcjr_twin_matches_pallas_kernel(W):
    rng = np.random.default_rng(W)
    L = 128
    ins = [_rand(rng, W, L) for _ in range(3)] + \
        [_rand(rng, 8, L, scale=1.0) for _ in range(2)]
    want = turbo_pallas.make_bcjr(W, L, interpret=True)(*ins)
    got = bcjr.bcjr(*[torch.from_numpy(x) for x in ins])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def _coded(K, B, rng):
    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.stack([ref_turbo_host.turbo_encode(b) for b in bits])
    x = 1.0 - 2.0 * d.astype(np.float32)
    llr = (1.6 * x + rng.normal(size=x.shape)).astype(np.float32)
    prior = (0.8 * x + rng.normal(size=x.shape)).astype(np.float32)
    return bits, llr, prior


@pytest.mark.parametrize("K", [40, 512, 352])
@pytest.mark.parametrize("n_iter", [2, 12])
def test_decoder_bits_match_reference(K, n_iter):
    """K=352 is a loaded-cell grant size; each case runs with and without
    a HARQ prior (a second, weaker observation of the same code words)."""
    rng = np.random.default_rng(K + n_iter)
    sent, llr, prior = _coded(K, 3, rng)
    for d in (llr, llr + prior):
        got, got_llr = turbo.make_decoder(K, n_iter)(torch.from_numpy(d))
        pal, pal_llr = ref_turbo._make_decoder_pallas(
            K, n_iter, interpret=True)(jnp.asarray(d))
        pw, _ = ref_turbo._make_decoder_pw(K, n_iter)(jnp.asarray(d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pw))
        np.testing.assert_array_equal(got.numpy(), sent)
        np.testing.assert_allclose(got_llr.numpy(), np.asarray(pal_llr),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("K,B", [(40, 3), (512, 2), (1824, 5)])
def test_lane_consts_match_reference(K, B):
    want = ref_turbo._lane_consts(K, B)
    got = turbo._lane_consts(K, B)
    assert (got["L"], got["W"], got["NW"]) == (want["L"], want["W"],
                                               want["NW"])
    for k in ("pi_w", "de_w", "sia", "mask_a", "const_a", "mask_b",
              "lane_b", "pi", "de"):
        np.testing.assert_array_equal(np.asarray(got[k]).reshape(-1),
                                      np.asarray(want[k]).reshape(-1), k)
    np.testing.assert_array_equal(got["is_last"].reshape(-1),
                                  want["is_last"])


def test_kernel_source_tables_match_trellis():
    """The trellis tables hard-coded in csrc/bcjr_step.cuh (the recurrence
    both CUDA kernels include) are the RSC code's."""
    src = open(bcjr.HEADER).read()
    for name, want in bcjr.trellis_lanes().items():
        m = re.search(r"const int %s\[8\] = \{([^}]*)\}" % name, src)
        assert m, name
        got = [int(v) for v in m.group(1).split(",")]
        assert got == want.tolist(), name


def test_kernel_build_flags():
    assert "-gencode" in bcjr.NVCC_FLAGS and "--fmad=false" in bcjr.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in bcjr.NVCC_FLAGS
    assert bcjr.BUILD_DIR.endswith(os.path.join("ltesniffer_tpu_torch",
                                                "_build"))


def test_wrapper_checks_before_launch():
    """The CUDA path validates its inputs (here on CPU tensors, before any
    build): window, dtype and shape."""
    W, L = 16, 128
    ok = [torch.zeros((W, L))] * 3 + [torch.zeros((8, L))] * 2
    with pytest.raises(ValueError):
        bcjr.bcjr_cuda(*([torch.zeros((12, L))] * 3 + ok[3:]))
    with pytest.raises(TypeError):
        bcjr.bcjr_cuda(ok[0].double(), *ok[1:])
    with pytest.raises(ValueError):
        bcjr.bcjr_cuda(*ok[:3], torch.zeros((8, L + 1)), ok[4])
    with pytest.raises(ValueError):
        bcjr.bcjr_cuda(*ok)                      # host tensors
    with pytest.raises(ValueError):
        bcjr.bcjr(*[x.to("meta") for x in ok])
    assert bcjr.bytes_moved(W, L) == (4 * W + 32) * L * 4


def test_kernels_share_one_trellis_header():
    """Both CUDA sources take the recurrence from bcjr_step.cuh and define
    no trellis table of their own."""
    assert bcjr.HEADER == turbo_decode.HEADER
    for path in (bcjr.SRC, turbo_decode.SRC):
        src = open(path).read()
        assert '#include "bcjr_step.cuh"' in src, path
        assert not re.search(r"const int \w+\[8\] =", src), path
        assert "bcjr_alpha_step" in src and "bcjr_beta_step" in src, path


def _qpp_walk(K: int, W: int, S: int, f1: int, f2: int):
    """The fused kernel's walk over one code block (struct Qpp and
    half_pass in csrc/turbo_decode.cu), mirrored with the same 32-bit
    integer steps.  Yields, per window w, the positions its thread loads
    (the forward sweep over segments 0..NS-2, then, last segment first,
    each segment walked up again from `at`) and the positions of its
    backward steps (each segment walked down)."""
    d2 = (2 * f2) % K

    def i32(x):
        assert -2 ** 31 <= x < 2 ** 31, x
        return x

    def at(i):
        p = i32(i32(f1 + i32(f2 * i) % K) * i) % K
        g = (f1 + i32(f2 * (2 * i + 1)) % K) % K
        return p, g

    def up(p, g):
        p += g
        p = p - K if p >= K else p
        g += d2
        return p, (g - K if g >= K else g)

    def down(p, g):
        g -= d2
        g = g + K if g < 0 else g
        p -= g
        return (p + K if p < 0 else p), g

    NS = W // S
    for w in range(K // W):
        loads, back = [], []
        p, g = at(w * W)
        for _ in range((NS - 1) * S):
            loads.append(p)
            p, g = up(p, g)
        for seg in range(NS - 1, -1, -1):
            p, g = at(w * W + seg * S)
            for _ in range(S):
                loads.append(p)
                p, g = up(p, g)
            for _ in range(S):
                p, g = down(p, g)
                back.append(p)
        yield w, loads, back


def test_qpp_walk_matches_interleaver():
    """The fused kernel's on-the-fly QPP walk, mirrored with its 32-bit
    integer steps, visits pi(i) for every LTE K (decoder 2) and i itself
    with (f1, f2) = (1, 0) (decoder 1): up the window in the forward
    sweep and in each segment's recomputation, down it backward."""
    assert len(tables_data.QPP_F1_F2) == 188
    for K in sorted(tables_data.QPP_F1_F2):
        geo = turbo_decode.launch_geometry(K, 1)
        W, S = geo["W"], geo["S"]
        NS = W // S
        for (f1, f2), perm in ((tables_data.QPP_F1_F2[K],
                                tables.qpp_interleave_indices(K).tolist()),
                               ((1, 0), list(range(K)))):
            n = 0
            for w, loads, back in _qpp_walk(K, W, S, f1, f2):
                win = perm[w * W:(w + 1) * W]
                redo = [x for seg in range(NS - 1, -1, -1)
                        for x in win[seg * S:(seg + 1) * S]]
                assert loads == win[:(NS - 1) * S] + redo, (K, w)
                assert back == win[::-1], (K, w)
                n += 1
            assert n == K // W


@pytest.mark.parametrize("B", [1, 7, 729, 5000])
def test_fused_launch_geometry_fits_the_card(B):
    """For every LTE K the fused kernel's CTA stays within its launch bound
    (<= 1024 threads on the card) and a block's dynamic shared memory
    (232,448 bytes), packs code blocks up to 64 threads, and covers B."""
    for K in sorted(tables_data.QPP_F1_F2):
        g = turbo_decode.launch_geometry(K, B)
        assert g["W"] in (8, 16, 32) and K % g["W"] == 0
        assert g["NW"] == K // g["W"] and g["threads"] == g["G"] * g["NW"]
        assert g["threads"] <= turbo_decode.MAX_THREADS <= 1024, K
        assert g["smem"] <= turbo_decode.MAX_SMEM == 232448, K
        assert g["G"] <= B and (g["threads"] >= 64 or g["G"] == B
                                or g["G"] == 1), K
        assert (g["ctas"] - 1) * g["G"] < B <= g["ctas"] * g["G"]
        assert g["S"] == min(g["W"], turbo_decode.SEG)


def test_fused_kernel_build_flags(tmp_path, monkeypatch):
    """turbo_decode.cu and bcjr.cu build through nvcc_build with sm_90a and
    --fmad=false, keyed by the shared header as well as the source (nvcc
    and the library load are stubbed: no nvcc here)."""
    assert "arch=compute_90a,code=sm_90a" in nvcc_build.NVCC_FLAGS
    assert "--fmad=false" in nvcc_build.NVCC_FLAGS
    assert bcjr.NVCC_FLAGS is nvcc_build.NVCC_FLAGS
    cmds = []

    class Done:
        returncode, stdout = 0, ""
        stderr = ("ptxas info    : Compiling entry function '_Z3fooi' for "
                  "'sm_90a'\nptxas info    : Function properties for "
                  "_Z3fooi\n    8 bytes stack frame, 4 bytes spill stores, "
                  "12 bytes spill loads\nptxas info    : Used 168 registers\n")

    def run(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(nvcc_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nvcc_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc_build.subprocess, "run", run)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    nvcc_build.load.cache_clear()
    try:
        so = nvcc_build.load("turbo_decode", turbo_decode.SRC,
                             (turbo_decode.HEADER,))
        assert so.startswith(str(tmp_path)) and "libturbo_decode_" in so
        (cmd,) = cmds
        assert cmd[-1] == turbo_decode.SRC
        assert tuple(cmd[1:1 + len(nvcc_build.NVCC_FLAGS)]) == \
            nvcc_build.NVCC_FLAGS
        assert nvcc_build.ptxas_report("turbo_decode") == [
            ("_Z3fooi", 168, 4, 12)]
        nvcc_build.load("turbo_decode", turbo_decode.SRC,
                        (turbo_decode.HEADER,))
        assert len(cmds) == 1                  # cached
    finally:
        nvcc_build.load.cache_clear()


def test_fused_wrapper_checks_before_build(monkeypatch):
    """turbo_decode_cuda raises on what the kernel does not take before it
    builds anything: a CPU tensor, a wrong dtype, a wrong shape, a
    non-contiguous input, a K that is no LTE size, n_iter < 1."""
    def no_build():
        raise AssertionError("built before checking its input")
    monkeypatch.setattr(turbo_decode, "_library", no_build)
    K, B = 40, 3
    ok = torch.zeros((B, 3, K + 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        turbo_decode.turbo_decode_cuda(ok, K, 2)
    with pytest.raises(TypeError):
        turbo_decode.turbo_decode_cuda(ok.double(), K, 2)
    with pytest.raises(ValueError, match="shape"):
        turbo_decode.turbo_decode_cuda(torch.zeros((B, 3, K + 3)), K, 2)
    with pytest.raises(ValueError, match="shape"):
        turbo_decode.turbo_decode_cuda(torch.zeros((3, K + 4)), K, 2)
    with pytest.raises(ValueError, match="contiguous"):
        turbo_decode.turbo_decode_cuda(
            torch.zeros((B, K + 4, 3)).transpose(1, 2), K, 2)
    with pytest.raises(ValueError, match="LTE"):
        turbo_decode.turbo_decode_cuda(torch.zeros((B, 3, 48)), 44, 2)
    with pytest.raises(ValueError, match="n_iter"):
        turbo_decode.turbo_decode_cuda(ok, K, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        turbo.make_decoder(K, 2)(ok.to("meta"))
    assert turbo_decode.LAUNCHES["turbo_decode"] == 0


def test_fused_bound_counts():
    """The bound's inputs: bytes read and written once, float32
    operations of the algorithm (chip_smoke.py divides them by the card's
    rates)."""
    K, B = 1824, 729
    assert turbo_decode.bytes_moved(K, B) == B * (3 * (K + 4) * 4 + 5 * K)
    assert turbo_decode.ops(K, B, 12) == 107 * 24 * K * B + 2 * K * B
    assert turbo_decode.ops(K, B, 2) < turbo_decode.ops(K, B, 12)


@pytest.mark.parametrize("n_iter", [2, 12])
def test_decoder_largest_block_matches_reference(n_iter):
    """K=6144 (the fused kernel's largest shared-memory case) and K=40 (its
    smallest block, 13 packed per CTA): the port's decoder on the CPU (the
    fused kernel's plain version) decides the bits of the JAX package's
    default decoder, with and without a HARQ prior."""
    for K in (6144, 40):
        rng = np.random.default_rng(K + n_iter)
        sent, llr, prior = _coded(K, 1, rng)
        for d in (llr, llr + prior):
            got, got_llr = turbo.make_decoder(K, n_iter)(torch.from_numpy(d))
            pw, pw_llr = ref_turbo._make_decoder_pw(K, n_iter)(
                jnp.asarray(d))
            np.testing.assert_array_equal(got.numpy(), np.asarray(pw))
            np.testing.assert_array_equal(got.numpy(), sent)
            np.testing.assert_allclose(got_llr.numpy(), np.asarray(pw_llr),
                                       rtol=1e-5, atol=1e-3)
