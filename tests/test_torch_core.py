"""The port's downlink chain as a whole, against the JAX package.

* `ltesniffer_tpu_torch`'s core on the CPU reproduces the sha256 of
  tests/golden/dl_mode.pcap from the stream the JAX package's own
  `testing.scenario` builds;
* on a 100-PRB loaded-cell stream of 12 subframes (with its format-2A
  load), the port and `ltesniffer_tpu.sniffer.core` write byte-equal
  pcaps, return equal `summary()` dicts and count the same wrong-MIMO
  grants;
* the committed expected records of the full loaded cell
  (`ltesniffer_tpu_torch/testing/dl_loaded_expected.json`) and of the 2x2
  MIMO cell (`ltesniffer_tpu_torch/testing/mimo_expected.json`), which
  chip_smoke.py holds the card's runs against, match the scenarios that
  `testing/loaded_cell.py` and `testing/mimo_cell.py` build.

The expected records are (re)generated by running the JAX package on the
CPU over the full streams:
    python -m tests.test_torch_core --regen-loaded
    python -m tests.test_torch_core --regen-mimo
Regenerate ONLY when a scenario or the reference's behavior changes on
purpose, and say why in the commit message.
"""
import contextlib
import hashlib
import json
import os
import sys

import pytest
import torch

from ltesniffer_tpu.phy.params import CellConfig as RefCellConfig
from ltesniffer_tpu.sniffer import core as ref_core

from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core
from ltesniffer_tpu_torch.testing import loaded_cell, mimo_cell

from tests import test_golden_replay as golden

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                        "dl_loaded_expected.json")
EXPECTED_MIMO = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                             "mimo_expected.json")
MIMO_BATCH = 32          # the MIMO cell's batch size, record and card alike


@contextlib.contextmanager
def _bench_module(**overrides):
    """Import the reference's bench.py (for its `build_stream`) with its
    module constants overridden, leaving JAX's global config as it was
    (bench.py points JAX's persistent compile cache at the repo)."""
    import jax
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench
    for k, v in saved.items():
        jax.config.update(k, v)
    old = {k: getattr(bench, k) for k in overrides}
    for k, v in overrides.items():
        setattr(bench, k, v)
    try:
        yield bench
    finally:
        for k, v in old.items():
            setattr(bench, k, v)


def ref_loaded_stream(n_sf: int, mimo_dcis: int = loaded_cell.MIMO_DCIS):
    """The loaded-cell IQ from the JAX package's generator
    (`bench.py:build_stream` with the port's scenario parameters)."""
    p = loaded_cell.params(n_sf)
    with _bench_module(N_SF=n_sf, N_RNTI=p["n_rnti"], GRANTS=p["grants"],
                       MIMO_DCIS=mimo_dcis) as bench:
        return bench.build_stream(RefCellConfig(
            n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
            nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"]))


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_port_core_reproduces_golden_pcap(tmp_path):
    out = str(tmp_path / "dl.pcap")
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    cfg = core.SnifferConfig(cell=cell, batch_size=8, pcap_path=out,
                             api_mode=0, device="cpu")
    c = core.LTESnifferCore(cfg)
    c.run_samples(golden._build_stream())
    c.close()
    assert _sha(out) == _sha(golden.GOLDEN_PCAP)
    assert c.summary()["pdsch_ok"] == 12


_LOADED12 = {}


def _loaded12(tmp_path_factory, mimo_dcis: int):
    """Both cores over the first 12 subframes of the loaded cell with
    `mimo_dcis` format-2A DCIs per subframe, through run_packed (cached
    per module): ({name: (pcap bytes, summary, core)}, placed TBs)."""
    if mimo_dcis in _LOADED12:
        return _LOADED12[mimo_dcis]
    tmp = tmp_path_factory.mktemp(f"loaded12_{mimo_dcis}")
    stream, placed = ref_loaded_stream(12, mimo_dcis)
    words, scales = _quantize(stream, 12)
    out = {}
    for name, mod, cell_cls, extra in (
            ("ref", ref_core, RefCellConfig, {}),
            ("port", core, CellConfig, {"device": "cpu"})):
        p = loaded_cell.params()
        cell = cell_cls(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                        nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
        path = str(tmp / f"{name}.pcap")
        cfg = mod.SnifferConfig(cell=cell, batch_size=4, pcap_path=path,
                                **extra)
        c = mod.LTESnifferCore(cfg)
        c.run_packed(words, scales)
        c.close()
        out[name] = (open(path, "rb").read(), c.summary(), c)
    _LOADED12[mimo_dcis] = (out, placed)
    return out, placed


def test_port_and_reference_pcaps_equal_100prb(tmp_path_factory):
    """The loaded cell without its format-2A load."""
    out, placed = _loaded12(tmp_path_factory, 0)
    summaries = {k: v[1] for k, v in out.items()}
    assert summaries["ref"]["pdsch_ok"] >= 0.9 * placed
    assert summaries["port"]["pdsch_ok"] == summaries["ref"]["pdsch_ok"]
    assert out["port"][0] == out["ref"][0]


def test_port_and_reference_pcaps_equal_100prb_format_2a(tmp_path_factory):
    """The loaded cell with its format-2A load (one two-codeword DCI per
    subframe, as bench.py sends it): byte-equal pcaps."""
    out, placed = _loaded12(tmp_path_factory, 1)
    summaries = {k: v[1] for k, v in out.items()}
    assert summaries["ref"]["pdsch_ok"] >= 0.85 * placed
    assert summaries["port"]["pdsch_ok"] == summaries["ref"]["pdsch_ok"]
    assert out["port"][0] == out["ref"][0]


@pytest.mark.parametrize("mimo_dcis", [0, 1])
def test_summaries_equal_100prb(tmp_path_factory, mimo_dcis):
    """`summary()` of both cores on the same run_packed input: every key
    of the reference, `sf_skipped` and `resyncs` included, equal."""
    out, _ = _loaded12(tmp_path_factory, mimo_dcis)
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["sf_skipped"] == 0
    assert out["port"][1]["resyncs"] == 0


def test_format_2a_load_counted_as_wrong_mimo(tmp_path_factory):
    """The 1-RX loaded cell's two-codeword format-2A grants: both cores
    count them as wrong-MIMO configs, per RNTI (an RNTI seen only with
    wrong-MIMO grants is evicted at the tracker's limit, in both), and
    decode no PDSCH for them."""
    out, _ = _loaded12(tmp_path_factory, 1)
    counts = {}
    for name, (_, _, c) in out.items():
        counts[name] = {r: st.wrong_mimo for r, st in c.mcs.stats_dl.items()
                        if st.wrong_mimo}
        assert not any(r.dci.fmt == "2A" for r in c.results)
    assert counts["port"] == counts["ref"]
    assert sum(counts["port"].values()) > 0


def _quantize(stream, n_sf):
    from ltesniffer_tpu_torch.kernels import cplx
    n = loaded_cell.CELL.sf_len
    return cplx.to_i8_packed(stream[:n_sf * n].reshape(n_sf, 1, n))


def test_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED))
    assert rec["params"] == loaded_cell.params()
    assert rec["params"]["mimo_dcis"] == 1
    cfg = rec["config"]
    assert cfg["batch_size"] == 256 and cfg["turbo_iters"] == 2
    assert cfg["turbo_iters_max"] == 12 and cfg["acquire_sfn"] is True
    assert cfg["pipeline_depth"] == 3
    assert len(rec["pdsch_ok"]) == len(rec["pdsch_dci"])
    assert all(0 <= i < len(rec["dcis"]) for i in rec["pdsch_dci"])
    assert rec["placed"] > 0 and len(rec["pcap_sha256"]) == 64
    # accepted format-2A DCIs are wrong-MIMO counts (the tally left after
    # the tracker evicts RNTIs seen only so), never results
    n_2a = sum(1 for d in rec["dcis"] if d[2] == "2A")
    assert 0 < rec["wrong_mimo"] <= n_2a
    assert all(rec["dcis"][i][2] != "2A" for i in rec["pdsch_dci"])
    assert os.path.getsize(EXPECTED) < 256 * 1024


def test_mimo_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED_MIMO))
    assert rec["params"] == mimo_cell.params()
    cfg = rec["config"]
    assert cfg["batch_size"] == MIMO_BATCH and cfg["turbo_iters"] == 2
    assert cfg["turbo_iters_max"] == 12 and cfg["acquire_sfn"] is True
    assert len(rec["pdsch_ok"]) == len(rec["pdsch_dci"])
    assert all(0 <= i < len(rec["dcis"]) for i in rec["pdsch_dci"])
    # the two-codeword grants: two results for each accepted 2 / 2A DCI
    per_dci = {}
    for i in rec["pdsch_dci"]:
        per_dci[i] = per_dci.get(i, 0) + 1
    for i, n in per_dci.items():
        assert n == (2 if rec["dcis"][i][2] in ("2", "2A") else 1)
    assert {rec["dcis"][i][2] for i in per_dci} == {"1A", "2", "2A"}
    assert rec["wrong_mimo"] == 0
    assert rec["placed"] > 0 and len(rec["pcap_sha256"]) == 64
    assert os.path.getsize(EXPECTED_MIMO) < 256 * 1024


# ---------------------------------------------------------------------------
# expected record of the full loaded cell
# ---------------------------------------------------------------------------
def record_run(c, accepted_log, placed, sha, params, cfg_dict):
    """Compact JSON record of one core run: accepted DCIs in time order,
    and for each PDSCH result the index of its DCI plus its CRC flag."""
    index = {}
    dcis = []
    for tti, rnti, fmt in accepted_log:
        index.setdefault((tti, rnti, fmt), len(dcis))
        dcis.append([tti, rnti, fmt])
    pdsch_dci, ok = [], []
    for r in c.results:
        pdsch_dci.append(index[(r.dci.sfn * 10 + r.dci.sf_idx, r.dci.rnti,
                                r.dci.fmt)])
        ok.append("1" if r.crc_ok else "0")
    return {"params": params, "config": cfg_dict, "placed": int(placed),
            "summary": {k: v for k, v in c.summary().items()
                        if k != "search_stats"},
            "wrong_mimo": sum(st.wrong_mimo
                              for st in c.mcs.stats_dl.values()),
            "pcap_sha256": sha, "dcis": dcis, "pdsch_dci": pdsch_dci,
            "pdsch_ok": "".join(ok)}


def run_logged(mod, cfg, words, scales):
    """Run a core (either package) over packed IQ, logging every accepted
    DCI as (tti, rnti, format) in time order."""
    c = mod.LTESnifferCore(cfg)
    log = []

    def hook(ctx):
        for a in ctx["accepted"]:
            log.append((ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt))
    c.on_subframe = hook
    c.run_packed(words, scales)
    c.close()
    return c, log


def _regen_loaded():
    import dataclasses
    import jax
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    p = loaded_cell.params()
    stream, placed = ref_loaded_stream(p["n_sf"])
    words, scales = _quantize(stream, p["n_sf"])
    cell = RefCellConfig(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                         nof_ports=p["nof_ports"],
                         nof_rx_ant=p["nof_rx_ant"])
    with tempfile.TemporaryDirectory() as d:
        pcap = os.path.join(d, "loaded.pcap")
        cfg = ref_core.SnifferConfig(cell=cell, batch_size=256,
                                     pcap_path=pcap)
        c, log = run_logged(ref_core, cfg, words, scales)
        sha = _sha(pcap)
    cfg_dict = {k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ("batch_size", "turbo_iters", "turbo_iters_max",
                         "acquire_sfn", "pipeline_depth", "ingest")}
    rec = record_run(c, log, placed, sha, p, cfg_dict)
    with open(EXPECTED, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    n_dl = sum(1 for t in log if t[2] != "0")
    print(f"expected record regenerated: {EXPECTED} "
          f"({os.path.getsize(EXPECTED)} B)")
    print(f"placed {placed}, accepted DL DCIs {n_dl}, "
          f"summary {rec['summary']}")


def _regen_mimo():
    import dataclasses
    import jax
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    p = mimo_cell.params()
    words, scales, truth = mimo_cell.build_packed(p["n_sf"])
    cell = RefCellConfig(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                         nof_ports=p["nof_ports"],
                         nof_rx_ant=p["nof_rx_ant"])
    with tempfile.TemporaryDirectory() as d:
        pcap = os.path.join(d, "mimo.pcap")
        cfg = ref_core.SnifferConfig(cell=cell, batch_size=MIMO_BATCH,
                                     pcap_path=pcap)
        c, log = run_logged(ref_core, cfg, words, scales)
        sha = _sha(pcap)
    cfg_dict = {k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ("batch_size", "turbo_iters", "turbo_iters_max",
                         "acquire_sfn", "pipeline_depth", "ingest")}
    rec = record_run(c, log, len(truth), sha, p, cfg_dict)
    with open(EXPECTED_MIMO, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_MIMO} "
          f"({os.path.getsize(EXPECTED_MIMO)} B)")
    print(f"placed {len(truth)} TBs, accepted DCIs {len(log)}, "
          f"summary {rec['summary']}")


if __name__ == "__main__":
    if "--regen-loaded" in sys.argv:
        _regen_loaded()
        sys.exit(0)
    if "--regen-mimo" in sys.argv:
        _regen_mimo()
        sys.exit(0)
    print(__doc__)
    sys.exit(2)
