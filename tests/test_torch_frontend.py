"""Port parity, frontend: cplx, OFDM, channel estimate, equalizers,
demappers and the batched frontend of `ltesniffer_tpu_torch` against the
JAX package on the same seeded inputs.

Tolerance: float32 results agree within rtol 1e-4 plus atol 1e-4 of the
tensor's peak (the two packages sum matmuls and reductions in different
orders); integer results (CFI) are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.kernels import chest as ref_chest, cplx as ref_cplx
from ltesniffer_tpu.kernels import demapper as ref_demapper, ofdm as ref_ofdm
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import frontend as ref_frontend
from ltesniffer_tpu.testing import encoder as ref_encoder

from ltesniffer_tpu_torch.kernels import chest, cplx, demapper, ofdm
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import frontend

torch.set_num_threads(1)

CFG = dict(n_id_cell=123, n_prb=25, nof_ports=2, nof_rx_ant=1)


def close(got, want, rtol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * peak)


def _iq(rng, n_sf=3, cfg=CFG, noise=0.05):
    cell = RefCell(**cfg)
    out = []
    for sf in range(n_sf):
        g = ref_encoder.build_control_subframe(cell, sf, 2, [])
        h = ref_encoder.flat_channel(cell, cell.nof_rx_ant, rng)
        rxg = ref_encoder.apply_channel(g, h, noise_std=noise, rng=rng)
        out.append(ref_encoder.subframe_iq(cell, rxg))
    return np.stack(out).astype(np.complex64)        # (B, RX, sf_len)


def test_cplx_host_helpers_equal():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 1, 64)) + 1j * rng.normal(size=(3, 1, 64))
         ).astype(np.complex64)
    np.testing.assert_array_equal(cplx.to_ri(x), ref_cplx.to_ri(x))
    w, s = cplx.to_i8_packed(x)
    rw, rs = ref_cplx.to_i8_packed(x)
    np.testing.assert_array_equal(w, rw)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(cplx.view_i64(w), ref_cplx.view_i64(rw))
    a = rng.normal(size=(5, 2)).astype(np.float32)
    b = rng.normal(size=(5, 2)).astype(np.float32)
    close(cplx.cmul(torch.from_numpy(a), torch.from_numpy(b)),
          ref_cplx.cmul(a, b))
    close(cplx.cmul_conj(torch.from_numpy(a), torch.from_numpy(b)),
          ref_cplx.cmul_conj(a, b))


def test_ofdm_demodulate_matches():
    rng = np.random.default_rng(1)
    iq = _iq(rng, 2)
    ri = ref_cplx.to_ri(iq)
    want = ref_ofdm.demodulate_ri(jnp.asarray(ri), RefCell(**CFG))
    got = ofdm.demodulate_ri(torch.from_numpy(ri), CellConfig(**CFG))
    close(got, want)


def test_ofdm_modulate_np_equal():
    rng = np.random.default_rng(2)
    cell = CellConfig(**CFG)
    grid = (rng.normal(size=(14, cell.n_sc)) + 1j * rng.normal(
        size=(14, cell.n_sc))).astype(np.complex64)
    np.testing.assert_array_equal(ofdm.modulate_np(grid, cell),
                                  ref_ofdm.modulate_np(grid, RefCell(**CFG)))


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_chest_estimate_matches(ports):
    cfg = dict(CFG, nof_ports=ports)
    rng = np.random.default_rng(3 + ports)
    iq = _iq(rng, 2, cfg)
    ri = ref_cplx.to_ri(iq)
    sf = np.array([0, 1], np.int64)
    grids = ref_ofdm.demodulate_ri(jnp.asarray(ri), RefCell(**cfg))
    want = ref_chest.estimate(grids, jnp.asarray(sf, jnp.int32),
                              RefCell(**cfg))
    got = chest.estimate(torch.from_numpy(np.array(grids)),
                         torch.from_numpy(sf), CellConfig(**cfg))
    for k in ("h", "noise_var", "rsrp", "snr_db"):
        close(got[k], want[k])
    np.testing.assert_allclose(got["cfo"].numpy(), np.asarray(want["cfo"]),
                               atol=1e-5)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_equalize_ports_matches(ports):
    rng = np.random.default_rng(10 + ports)
    y = rng.normal(size=(2, 1, 32, 2)).astype(np.float32)
    h = rng.normal(size=(2, 1, ports, 32, 2)).astype(np.float32)
    nv = np.abs(rng.normal(size=(2,))).astype(np.float32)
    want = ref_chest.equalize_ports(jnp.asarray(y), jnp.asarray(h),
                                    jnp.asarray(nv), ports)
    got = chest.equalize_ports(torch.from_numpy(y), torch.from_numpy(h),
                               torch.from_numpy(nv), ports)
    close(got, want)


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_demapper_llr_matches(qm):
    rng = np.random.default_rng(20 + qm)
    x = rng.normal(size=(3, 40, 2)).astype(np.float32)
    want = ref_demapper.llr(jnp.asarray(x), qm)
    got = demapper.llr(torch.from_numpy(x), qm)
    close(got, want, rtol=1e-5)


@pytest.mark.parametrize("ports", [1, 2])
def test_frontend_i8c64_matches(ports):
    """The packed-int8 ingest the pipelined driver uses: int64 carrier ->
    bytes -> scale -> CFO de-rotation -> demod -> chest -> PCFICH."""
    _frontend_i8c64_matches(dict(CFG, nof_ports=ports), 30 + ports)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_frontend_i8c64_matches_2rx(ports):
    """The same at two RX antennas (the RX axis rides through the unpack,
    the DFT, the channel estimate and the PCFICH combining)."""
    _frontend_i8c64_matches(dict(CFG, nof_ports=ports, nof_rx_ant=2),
                            40 + ports)


def _frontend_i8c64_matches(cfg, seed):
    rng = np.random.default_rng(seed)
    iq = _iq(rng, 3, cfg)
    words, scales = ref_cplx.to_i8_packed(iq)
    w64 = ref_cplx.view_i64(words)
    sf = np.array([3, 4, 5], np.int64)
    cfo = np.float32(0.013)
    import jax
    with jax.enable_x64(True):
        d64 = jax.device_put(w64)
    want = ref_frontend.make_frontend(RefCell(**cfg)).jitted_i8c64(
        d64, sf.astype(np.int32), jnp.asarray(scales), cfo)
    got = frontend.make_frontend(CellConfig(**cfg)).run_i8c64(
        torch.from_numpy(w64), torch.from_numpy(sf),
        torch.from_numpy(scales), float(cfo))
    for k in ("grids", "h", "noise_var", "snr_db", "rsrp", "cfi_corr"):
        close(got[k], want[k])
    np.testing.assert_array_equal(got["cfi"].numpy(), np.asarray(want["cfi"]))
