"""The port's native (C++) resolver against the port's Python resolver,
mirroring tests/test_native_resolver.py, and how the port builds it.

* On the same blind-search outputs (the JAX package's PDCCH pipeline over
  a seeded scenario, as numpy arrays), `ltesniffer_tpu_torch.native`'s
  resolver and `ltesniffer_tpu_torch.sniffer.dci_search` accept the same
  DCIs with the same payloads, count the same stats and end with the same
  active RNTI set; a RAR-activated T-CRNTI stays active.
* The core with `use_native=True` and `use_native=False` writes the same
  pcap and summary (the resolver reads the fused candidate words there).
* The library is built with `g++ -O2 -shared -fPIC -std=c++17` into
  `ltesniffer_tpu_torch/_build/`, under a name keyed by source and flags;
  two processes building at once both load a whole library; a missing
  compiler makes `use_native=True` raise instead of falling back.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.phy import dci as ref_dci, ra as ref_ra
from ltesniffer_tpu.phy import search_space as ref_ss
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch
from ltesniffer_tpu.testing import encoder as ref_encoder

from ltesniffer_tpu_torch import native
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, dci_search, rnti_manager

from tests import test_golden_replay as golden

torch.set_num_threads(1)

CFG = dict(n_id_cell=123, n_prb=50, nof_ports=2, nof_rx_ant=1)
CELL = CellConfig(**CFG)
CFI = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scenario_outputs(n_sf=20, seed=7):
    """A mixed scenario: SI, paging, two UEs (L=2 and L=0), empty
    subframes (tests/test_native_resolver.py:_scenario_outputs)."""
    ref_cell = RefCell(**CFG)
    rng = np.random.default_rng(seed)
    run, st = ref_pdcch.make_pipeline(ref_cell, CFI)
    iqs, sfs = [], []
    ues = [0x1111, 0x2222]
    for j in range(n_sf):
        sf = j % 10
        txs = []
        if sf == 5:
            txs.append(ref_encoder.TxDci(dci=ref_dci.Dci(
                fmt="1A", rnti=0xFFFF, fields=dict(
                    flag0_1a=1, riv=ref_ra.start_len_to_riv(0, 4, 50),
                    mcs=4)), L=3, ncce=0))
        for k, u in enumerate(ues):
            want_l = 2 if k == 0 else 0
            cands = [c for c in ref_ss.ue_candidates(u, sf, st["nof_cce"])
                     if c[0] == want_l]
            if cands:
                l, ncce = cands[0]
                txs.append(ref_encoder.TxDci(dci=ref_dci.Dci(
                    fmt="1A", rnti=u, fields=dict(
                        flag0_1a=1, riv=ref_ra.start_len_to_riv(10, 4, 50),
                        mcs=9)), L=l, ncce=ncce))
        g = ref_encoder.build_control_subframe(ref_cell, sf, CFI, txs)
        h = ref_encoder.flat_channel(ref_cell, 1, rng)
        iqs.append(ref_encoder.subframe_iq(
            ref_cell, ref_encoder.apply_channel(g, h, 0.05, rng))[0])
        sfs.append(sf)
    out = run(jnp.asarray(np.stack(iqs)[:, None, :].astype(np.complex64)),
              jnp.asarray(np.asarray(sfs, np.int32)))
    return {k: np.asarray(v) for k, v in out.items()}, st, sfs


def test_native_matches_python_resolver():
    out, st, sfs = _scenario_outputs()
    py_rm = rnti_manager.default_manager()
    py = dci_search.DciBlindSearch(CELL, py_rm)
    nat_rm = native.default_native_manager()
    nat = native.NativeDciBlindSearch(CELL, nat_rm)
    n_acc = 0
    for b in range(len(sfs)):
        a_py = py.resolve_subframe(out, b, st["locs"], st["nof_cce"], sfs[b])
        a_nat = nat.resolve_subframe(out, b, st["locs"], st["nof_cce"],
                                     sfs[b])
        key = lambda a: (a.rnti, a.fmt, a.l, a.ncce, a.histval)
        assert [key(x) for x in a_py] == [key(x) for x in a_nat], f"sf {b}"
        for x, y in zip(a_py, a_nat):
            np.testing.assert_array_equal(x.payload, y.payload)
        n_acc += len(a_py)
    assert n_acc > 10
    assert py.stats == nat.stats
    py_set = {(r, why.name) for r, why, _ in py_rm.active_set()}
    nat_set = {(r, why.name) for r, why, _ in nat_rm.active_set()}
    assert py_set == nat_set and len(py_set) >= 2


def test_native_rar_activation_side_list():
    out, st, sfs = _scenario_outputs(n_sf=6, seed=9)
    nat_rm = native.default_native_manager()
    nat = native.NativeDciBlindSearch(CELL, nat_rm)
    # pre-activate a T-CRNTI as if a RAR was seen
    nat_rm.activate_and_refresh(0x1111, 0,
                                rnti_manager.ActivationReason.RAR)
    assert (nat_rm.get_activation_reason(0x1111)
            == rnti_manager.ActivationReason.RAR)
    for b in range(6):
        nat.resolve_subframe(out, b, st["locs"], st["nof_cce"], sfs[b])
    assert nat_rm.is_active(0x1111)


def test_native_and_python_cores_equal(tmp_path):
    """The whole core, once with each resolver, on the golden scenario:
    the same pcap bytes and the same summary."""
    stream = golden._build_stream()
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    pcaps, sums = {}, {}
    for use_native in (True, False):
        p = str(tmp_path / f"dl_{use_native}.pcap")
        c = core.LTESnifferCore(core.SnifferConfig(
            cell=cell, batch_size=8, pcap_path=p, use_native=use_native,
            device="cpu"))
        assert isinstance(c.search, native.NativeDciBlindSearch) \
            == use_native
        c.run_samples(stream)
        c.close()
        pcaps[use_native] = open(p, "rb").read()
        sums[use_native] = c.summary()
    assert pcaps[True] == pcaps[False]
    assert sums[True] == sums[False]
    assert sums[True]["pdsch_ok"] == 12


def test_build_flags_and_output_path():
    assert native.CXX == "g++"
    assert native.CXX_FLAGS == ("-O2", "-shared", "-fPIC", "-std=c++17")
    so = native.library_path()
    assert os.path.dirname(so) == os.path.join(REPO, "ltesniffer_tpu_torch",
                                               "_build")
    name = os.path.basename(so)
    assert name.startswith("libresolver_") and name.endswith(".so")
    assert native.SRC == os.path.join(REPO, "ltesniffer_tpu_torch", "csrc",
                                      "resolver.cpp")
    native.load_library()
    assert os.path.isfile(so)


def test_build_key_follows_flags(monkeypatch):
    base = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != base


def test_use_native_raises_without_compiler(tmp_path, monkeypatch):
    """No silent fallback: with no compiler, use_native=True raises;
    use_native=False still builds a core on the Python resolver."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    cell = CellConfig(**CFG)
    with pytest.raises(RuntimeError, match="native resolver"):
        core.LTESnifferCore(core.SnifferConfig(cell=cell, device="cpu"))
    c = core.LTESnifferCore(core.SnifferConfig(cell=cell, use_native=False,
                                               device="cpu"))
    assert isinstance(c.search, dci_search.DciBlindSearch)
    assert not os.path.exists(native.library_path())


_BUILD_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    from ltesniffer_tpu_torch import native
    native.BUILD_DIR = sys.argv[2]
    m = native.default_native_manager()
    m.activate_and_refresh(0x4321, 2, native.ActivationReason.RAR)
    assert m.is_active(0x4321)
    print(native.library_path())
""")


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no library build it at the same time: each
    writes its own temp file and renames it into place, so both load a
    whole library and one library file is left."""
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, REPO,
                               build], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build)) == [os.path.basename(paths.pop())]
