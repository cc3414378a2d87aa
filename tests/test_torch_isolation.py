"""The port stands alone, and carries over what the reference defines.

* In a fresh interpreter that refuses `jax`, `jaxlib` and
  `ltesniffer_tpu` (but not `ltesniffer_tpu_torch`), every module of the
  port (the CLI, cell search, SDR sources and `parallel/` among them)
  and chip_smoke.py import.
* The port's scenario generator reproduces the JAX package's IQ (the
  golden scenario, the first 4 loaded-cell subframes, the UL golden's
  dual-carrier streams and the first 6 subframes of the UL cell) within
  1e-5.
* `convert.config_from_reference` rebuilds the reference's configuration
  (the DL golden's and the UL golden's, and configs with the ingest,
  pipeline-depth and live options), and the port's constant tables
  equal the reference's numpy arrays.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ltesniffer_tpu.kernels import chest as ref_chest, ofdm as ref_ofdm
from ltesniffer_tpu.kernels import viterbi as ref_viterbi
from ltesniffer_tpu.phy import conv as ref_conv, crc as ref_crc
from ltesniffer_tpu.phy import sequences as ref_seq, tables as ref_tables
from ltesniffer_tpu.phy import turbo as ref_turbo_host
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import core as ref_core
from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch

from ltesniffer_tpu_torch import convert
from ltesniffer_tpu_torch.kernels import chest, ofdm, viterbi
from ltesniffer_tpu_torch.phy import conv, crc, sequences, tables
from ltesniffer_tpu_torch.phy import turbo as turbo_host
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, pdcch_rx
from ltesniffer_tpu_torch.testing import loaded_cell, stream_cell, ul_cell

from tests import test_golden_replay as golden
from tests.test_torch_core import ref_loaded_stream
from tests.test_torch_ul_core import ref_ul_streams

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "ltesniffer_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("refused import of " + name)
            return None

    for m in [m for m in sys.modules if blocked(m)]:
        del sys.modules[m]
    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import ltesniffer_tpu_torch
    names = ["ltesniffer_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            ltesniffer_tpu_torch.__path__, "ltesniffer_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    importlib.import_module("chip_smoke")
    bad = sorted(m for m in sys.modules if blocked(m))
    assert not bad, bad
    print(" ".join(names))
    print(len(names))
""")

# the uplink's modules, each of which must import without JAX
UL_MODULES = {"ltesniffer_tpu_torch.phy." + m for m in (
    "ul_dmrs", "uci", "prach_roots", "prach_root_gen")} | {
    "ltesniffer_tpu_torch.kernels.scfdma",
    "ltesniffer_tpu_torch.sniffer.pusch_rx",
    "ltesniffer_tpu_torch.sniffer.prach_rx",
    "ltesniffer_tpu_torch.testing.ul_cell"}
# the live entry point's modules
LIVE_MODULES = {"ltesniffer_tpu_torch.cli",
                "ltesniffer_tpu_torch.sniffer.sync",
                "ltesniffer_tpu_torch.io.sdr",
                "ltesniffer_tpu_torch.testing.stream_cell"}
# the scale-out slice's modules: the split over devices, time blocks and
# their runner, and the scenarios of the multi-host run and the ASAN fuzz
PARALLEL_MODULES = {"ltesniffer_tpu_torch.parallel"} | {
    "ltesniffer_tpu_torch.parallel." + m for m in (
        "sharding", "multihost", "run_multihost")} | {
    "ltesniffer_tpu_torch.testing.multihost_cell",
    "ltesniffer_tpu_torch.testing.asan_resolver_fuzz"}


def test_port_imports_without_jax_or_reference():
    r = subprocess.run([sys.executable, "-c", _CHILD, REPO],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert int(lines[-1]) >= 71
    assert UL_MODULES <= set(lines[-2].split())
    assert LIVE_MODULES <= set(lines[-2].split())
    assert PARALLEL_MODULES <= set(lines[-2].split())


def test_refusal_is_effective():
    """The child's finder does refuse the reference package."""
    code = _CHILD.replace("import ltesniffer_tpu_torch\n",
                          "import ltesniffer_tpu.phy\n", 1)
    r = subprocess.run([sys.executable, "-c", code, REPO],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0 and "refused import" in r.stderr


def test_generator_reproduces_golden_iq():
    _, got, _ = stream_cell.golden_scenario()
    want = golden._build_stream()
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generator_reproduces_loaded_cell_iq():
    got, placed, truth = loaded_cell.build_stream(n_sf=4)
    want, want_placed = ref_loaded_stream(4)
    assert placed == want_placed == len(truth) > 40
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generator_reproduces_ul_golden_iq():
    sys.path.insert(0, REPO)
    import chip_smoke
    _, got_dl, got_ul = chip_smoke.ul_golden_scenario()
    want_dl, want_ul = golden._build_dual()
    for got, want in ((got_dl, want_dl), (got_ul, want_ul)):
        assert got.dtype == want.dtype == np.complex64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generator_reproduces_ul_cell_iq():
    dl, ul, placed, truth = ul_cell.build_streams(n_sf=6)
    want_dl, want_ul, want_placed = ref_ul_streams(6)
    assert placed == want_placed > 5 * ul_cell.GRANTS
    # the PUSCH of the DCI0s placed in subframes 0 and 1 land in 4 and 5
    assert 0 < len(truth) <= 2 * ul_cell.GRANTS
    assert {k for k, _, _ in truth} == {4, 5}
    np.testing.assert_allclose(dl, want_dl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ul, want_ul, rtol=0, atol=1e-5)


def test_ul_golden_config_from_reference():
    """The UL golden's reference configuration (tests/test_golden_replay.py
    `_run_ul`) converts, and the port's UL core takes it."""
    ref = ref_core.SnifferConfig(cell=golden.CELL, batch_size=8,
                                 pcap_path=None, acquire_sfn=False)
    cfg = convert.config_from_reference(dataclasses.asdict(ref),
                                        device="cpu")
    assert cfg.cell == CellConfig(n_id_cell=199, n_prb=50, nof_ports=2,
                                  nof_rx_ant=1)
    for f in dataclasses.fields(cfg):
        if f.name not in ("cell", "device"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    c = core.LTESnifferCoreUL(cfg, cyclic_shift_cfg=2)
    assert c.cyclic_shift_cfg == 2 and c.device.type == "cpu"


def test_config_from_reference():
    ref = ref_core.SnifferConfig(cell=RefCell(n_id_cell=301, n_prb=100,
                                              nof_ports=2, nof_rx_ant=1),
                                 batch_size=256, turbo_iters=2)
    cfg = convert.config_from_reference(dataclasses.asdict(ref),
                                        device="cpu")
    assert isinstance(cfg, core.SnifferConfig) and cfg.device == "cpu"
    assert cfg.cell == CellConfig(n_id_cell=301, n_prb=100, nof_ports=2,
                                  nof_rx_ant=1)
    for f in dataclasses.fields(cfg):
        if f.name not in ("cell", "device"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert convert.config_from_reference(
        dataclasses.asdict(ref.cell)) == cfg.cell
    bad = dict(dataclasses.asdict(ref), no_such_option=1)
    with pytest.raises(ValueError, match="no_such_option"):
        convert.config_from_reference(bad)


@pytest.mark.parametrize("opts", [
    dict(ingest="i16"), dict(ingest="f32", pipeline_depth=1),
    dict(ingest_int16=False, pipeline_depth=2),
    dict(live_mode=True, live_buffer_sf=7, pipeline_depth=2),
    dict(ingest="i16", live_mode=True, use_native=False)])
def test_config_from_reference_carries_live_and_ingest_options(opts):
    """Every ingest, pipeline and live option of a reference config
    carries over unchanged, and the port's core takes the config."""
    ref = ref_core.SnifferConfig(cell=RefCell(n_id_cell=55, n_prb=50,
                                              nof_ports=2, nof_rx_ant=1),
                                 batch_size=8, **opts)
    cfg = convert.config_from_reference(dataclasses.asdict(ref),
                                        device="cpu")
    for f in dataclasses.fields(cfg):
        if f.name not in ("cell", "device"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    for k, v in opts.items():
        assert getattr(cfg, k) == v
    c = core.LTESnifferCore(cfg)
    assert c.sf_skipped == 0 and c.tracker is None


def test_constant_tables_equal():
    ref_cell = RefCell(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
    cell = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
    # DFT bin matrices (the port rounds the float64 products to float32
    # once, as the reference's arrays are rounded on the device)
    for g, w in zip(ofdm._dft_mats(cell.n_fft, cell.n_sc),
                    ref_ofdm._dft_mats(cell.n_fft, cell.n_sc)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    # SC-FDMA DFT and per-grant IDFT matrices (rounded the same way)
    from ltesniffer_tpu.kernels import scfdma as ref_scfdma
    from ltesniffer_tpu_torch.kernels import scfdma
    for g, w in zip(scfdma._ul_dft_mats(cell.n_fft, cell.n_sc)
                    + scfdma._idft_mats(96) + scfdma._idft_mats(1200),
                    ref_scfdma._ul_dft_mats(cell.n_fft, cell.n_sc)
                    + ref_scfdma._idft_mats(96)
                    + ref_scfdma._idft_mats(1200)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    np.testing.assert_array_equal(
        scfdma.ul_subcarrier_bins(cell.n_fft, cell.n_sc),
        ref_scfdma.ul_subcarrier_bins(cell.n_fft, cell.n_sc))
    # CRS maps and interpolation weights
    for g, w in zip(chest.crs_constants(cell) + chest.interp_matrices(cell),
                    ref_chest.crs_constants(ref_cell)
                    + ref_chest.interp_matrices(ref_cell)):
        np.testing.assert_array_equal(g, w)
    # QPP permutations and RSC / convolutional trellis tables
    for K in (40, 352, 1824, 6144):
        np.testing.assert_array_equal(tables.qpp_interleave_indices(K),
                                      ref_tables.qpp_interleave_indices(K))
    for k, v in ref_turbo_host.rsc_tables().items():
        np.testing.assert_array_equal(turbo_host.rsc_tables()[k], v)
    for k, v in ref_conv.trellis_tables().items():
        np.testing.assert_array_equal(conv.trellis_tables()[k], v)
    np.testing.assert_array_equal(viterbi._tables()[1],
                                  ref_viterbi._tables()[1])
    # CRC remainder tables and Gold bases
    for p in (crc.CRC16, crc.CRC24A, crc.CRC24B, crc.CRC8):
        np.testing.assert_array_equal(crc.crc_remainder_table(p, 300),
                                      ref_crc.crc_remainder_table(p, 300))
    for g, w in zip(sequences.gold_basis(960), ref_seq.gold_basis(960)):
        np.testing.assert_array_equal(g, w)
    # PDCCH static maps
    for cfi in (1, 2, 3):
        g = pdcch_rx._static_maps(cell, cfi)
        w = ref_pdcch._static_maps(ref_cell, cfi)
        assert g["locs"] == w["locs"] and g["nof_cce"] == w["nof_cce"]
        np.testing.assert_array_equal(g["gather_idx"], w["gather_idx"])
        for D in w["size_maps"]:
            for a, b in zip(g["size_maps"][D]["mats"],
                            w["size_maps"][D]["mats"]):
                np.testing.assert_array_equal(a, b)
