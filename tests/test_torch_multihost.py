"""Port parity, multi-host time blocks: `ltesniffer_tpu_torch.parallel.
multihost` and its process-per-block runner, mirroring
`tests/test_multihost.py` on the port (on the CPU), plus:

* the port's merged results and pcap records equal the JAX package's
  merge on the same stream;
* the committed record of the loaded cell in two time blocks
  (`ltesniffer_tpu_torch/testing/multihost_expected.json`, which
  chip_smoke.py phase 8b holds the card's run against) matches its
  scenario.

The record is (re)generated by the JAX package on the CPU over the port's
loaded-cell stream (`testing/multihost_cell.py`; about 5 minutes):
    python -m tests.test_torch_multihost --regen-multihost
Regenerate ONLY when the scenario or the reference's behavior changes on
purpose, and say why in the commit message.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from ltesniffer_tpu.io import pcap as ref_pcap
from ltesniffer_tpu.parallel import multihost as ref_multihost
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import core as ref_core

from ltesniffer_tpu_torch.io import iq as iq_mod, pcap
from ltesniffer_tpu_torch.parallel import multihost
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core
from ltesniffer_tpu_torch.testing import loaded_cell, multihost_cell

from tests import test_multihost as ref_tests

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                        "multihost_expected.json")
CFG = dict(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
CELL, REF_CELL = CellConfig(**CFG), RefCell(**CFG)
# the runner's children: one thread each, as this process runs
_ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _run_single(mod, cell, path, stream, **kw):
    cfg = mod.SnifferConfig(cell=cell, batch_size=8, pcap_path=str(path),
                            **kw)
    c = mod.LTESnifferCore(cfg)
    c.run_samples(stream)
    c.close()
    return c, pcap.read_pcap(str(path))


def _run_hosts(mh, mod, cell, tmp, stream, n_hosts, overlap_sf, **kw):
    blocks = mh.split_blocks(stream, n_hosts, cell, overlap_sf=overlap_sf)
    cores = []
    for blk in blocks:
        def factory(b):
            return mod.LTESnifferCore(mod.SnifferConfig(
                cell=cell, batch_size=8,
                pcap_path=str(tmp / f"host{b.host}.pcap"), **kw))
        c = mh.run_block(factory, blk)
        c.close()
        cores.append(c)
    per_host = [pcap.read_pcap(str(tmp / f"host{h}.pcap"))
                for h in range(n_hosts)]
    return blocks, cores, per_host


def _port_single(tmp, stream):
    return _run_single(core, CELL, tmp / "single.pcap", stream,
                       device="cpu")


def _port_hosts(tmp, stream, n_hosts, overlap_sf):
    return _run_hosts(multihost, core, CELL, tmp, stream, n_hosts,
                      overlap_sf, device="cpu")


_result_key = ref_tests._result_key
_pcap_key = ref_tests._pcap_key


@pytest.fixture(scope="module")
def trace():
    return ref_tests._build_trace()


@pytest.fixture(scope="module")
def single(tmp_path_factory, trace):
    """The port's single-host run of the trace: (core, pcap records)."""
    return _port_single(tmp_path_factory.mktemp("single"), trace)


_HOSTS = {}


@pytest.fixture(scope="module")
def hosts(tmp_path_factory, trace):
    """The port's n-host runs of the trace at overlap 20, cached per n:
    n -> (blocks, cores, per-host pcap records)."""
    def get(n_hosts):
        if n_hosts not in _HOSTS:
            tmp = tmp_path_factory.mktemp(f"hosts{n_hosts}")
            _HOSTS[n_hosts] = _port_hosts(tmp, trace, n_hosts, 20)
        return _HOSTS[n_hosts]
    yield get
    _HOSTS.clear()


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_multihost_equals_single_host(single, hosts, n_hosts):
    single_c, single_recs = single
    blocks, cores, per_host = hosts(n_hosts)
    merged = multihost.merge_accepted([c.results for c in cores], blocks)
    assert [_result_key(r) for r in merged] == \
        [_result_key(r) for r in single_c.results]
    merged_recs = multihost.merge_pcap_records(per_host, blocks)
    assert [_pcap_key(r) for r in merged_recs] == \
        [_pcap_key(r) for r in single_recs]
    rntis = {r["rnti"] for r in merged_recs}
    assert 0x4B0B in rntis and 0x4100 in rntis


def test_ownership_filter_drops_replay_duplicates(hosts):
    blocks, cores, _ = hosts(2)
    h1_all = cores[1].results
    h1_owned = [r for r in h1_all
                if multihost.owned(blocks[1], r.dci.sfn, r.dci.sf_idx)]
    assert len(h1_owned) < len(h1_all)
    merged = multihost.merge_accepted([c.results for c in cores], blocks)
    keys = [(r.dci.sfn, r.dci.sf_idx, r.dci.rnti) for r in merged]
    assert len(keys) == len(set(keys)), "replay duplicates leaked"


def test_merge_equals_reference_merge(tmp_path, trace, hosts):
    """The JAX package's 2-host run and merge over the same trace: equal
    merged result keys and pcap records, and equal blocks."""
    ref_blocks, ref_cores, ref_per_host = _run_hosts(
        ref_multihost, ref_core, REF_CELL, tmp_path, trace, 2, 20)
    blocks, cores, per_host = hosts(2)
    for a, b in zip(blocks, ref_blocks):
        assert (a.host, a.warmup_sf, a.own_start_sf, a.own_count_sf,
                a.sfn0, a.sf_idx0) == (b.host, b.warmup_sf, b.own_start_sf,
                                       b.own_count_sf, b.sfn0, b.sf_idx0)
        assert a.samples is b.samples or (a.samples == b.samples).all()
    got = multihost.merge_accepted([c.results for c in cores], blocks)
    want = ref_multihost.merge_accepted([c.results for c in ref_cores],
                                        ref_blocks)
    assert [_result_key(r) for r in got] == [_result_key(r) for r in want]
    got_recs = multihost.merge_pcap_records(per_host, blocks)
    want_recs = ref_multihost.merge_pcap_records(ref_per_host, ref_blocks)
    assert [_pcap_key(r) for r in got_recs] == \
        [_pcap_key(r) for r in want_recs]
    assert len(got_recs) > 0


def test_multihost_runner_processes(tmp_path, trace, single):
    """The runner: one real OS process per block on the CPU, merged to the
    single-host pcap record set; each child's device is printed."""
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), trace)
    _, single_recs = single
    merged_pcap = tmp_path / "merged.pcap"
    r = subprocess.run(
        [sys.executable, "-m", "ltesniffer_tpu_torch.parallel.run_multihost",
         "-i", str(iq_path), "-c", str(CELL.n_id_cell), "-p", "50",
         "-P", "2", "-n", "2", "-B", "8", "--overlap", "20",
         "-o", str(merged_pcap), "--workdir", str(tmp_path / "wd"),
         "--device", "cpu"],
        cwd=REPO, env=_ONE_THREAD, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr
    assert "child 0 on cpu" in r.stdout and "child 1 on cpu" in r.stdout
    merged = pcap.read_pcap(str(merged_pcap))
    assert [_pcap_key(x) for x in merged] == \
        [_pcap_key(x) for x in single_recs]
    for h in range(2):
        rep = json.load(open(tmp_path / "wd" / f"host{h}.json"))
        assert rep["device"] == "cpu" and rep["results"]


def test_runner_fails_when_a_child_fails(tmp_path):
    """A child that cannot run (no such input) fails the parent."""
    r = subprocess.run(
        [sys.executable, "-m", "ltesniffer_tpu_torch.parallel.run_multihost",
         "-i", str(tmp_path / "missing.iq"), "-c", "55", "-n", "2",
         "--device", "cpu", "-o", str(tmp_path / "m.pcap"),
         "--workdir", str(tmp_path / "wd")],
        cwd=REPO, env=_ONE_THREAD, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 1
    assert "child failures" in r.stderr
    assert not (tmp_path / "m.pcap").exists()


def test_runner_cuda_without_card_raises():
    from ltesniffer_tpu_torch.parallel import run_multihost
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_multihost.child_devices("cuda", 2)
    assert run_multihost.child_devices("cpu", 3) == ["cpu"] * 3


def test_multihost_rar_silence_past_overlap_divergence_bound(tmp_path):
    """The mirror of the reference's test of the same name, on the port:
    an RNTI activated by RAR, silent longer than overlap_sf, resuming just
    after the block boundary.  The merged result may MISS at most
    histogram_threshold of the earliest resumed-RNTI records, never adds
    any, and every other record matches the 1-host run; with the overlap
    covering the RAR, parity is exact."""
    t_crnti = 0x4D0D
    n_sf, rar_sf, boundary, resume_sf = 120, 4, 60, 62
    stream = ref_tests._build_rar_silence_trace(n_sf, rar_sf, resume_sf,
                                                t_crnti)
    single_c, _ = _port_single(tmp_path, stream)
    single_keys = [_result_key(r) for r in single_c.results]
    assert any(r.dci.rnti == t_crnti for r in single_c.results)

    blocks, cores, _ = _port_hosts(tmp_path, stream, 2, 40)
    merged = multihost.merge_accepted([c.results for c in cores], blocks)
    merged_keys = [_result_key(r) for r in merged]
    missing = [k for k in single_keys if k not in merged_keys]
    extra = [k for k in merged_keys if k not in single_keys]
    assert not extra, "divergence must never add records"
    assert all(k[2] == t_crnti for k in missing), \
        "only the silent RAR RNTI may diverge"
    thresh = core.SnifferConfig(cell=CELL).histogram_threshold
    assert len(missing) <= thresh, (len(missing), thresh)
    t_single = [k for k in single_keys if k[2] == t_crnti]
    assert missing == t_single[:len(missing)]

    blocks2, cores2, _ = _port_hosts(tmp_path, stream, 2,
                                     boundary - rar_sf + 1)
    merged2 = multihost.merge_accepted([c.results for c in cores2], blocks2)
    assert sorted(_result_key(r) for r in merged2) == sorted(single_keys)


def test_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED))
    assert rec["params"] == multihost_cell.params()
    p = rec["params"]
    assert p["n_hosts"] == 2 and p["overlap_sf"] == 200
    # the batch divides the block boundary and the replay start
    bound = p["n_sf"] // 2
    assert bound % p["batch_size"] == 0
    assert (bound - p["overlap_sf"]) % p["batch_size"] == 0
    assert len(rec["pdsch_ok"]) == len(rec["pdsch_dci"]) > 0
    assert all(0 <= i < len(rec["dcis"]) for i in rec["pdsch_dci"])
    ttis = [d[0] for d in rec["dcis"]]
    assert ttis == sorted(ttis) and ttis[-1] < p["n_sf"]
    assert rec["n_records_merged"] > 0 and rec["n_records_single"] > 0
    assert 0 <= rec["n_records_differ"] <= (rec["n_records_merged"]
                                            + rec["n_records_single"])
    assert rec["placed"] > 0
    assert os.path.getsize(EXPECTED) < 256 * 1024


def _regen_multihost():
    import jax
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    p = loaded_cell.params()
    stream, placed, _ = loaded_cell.build_stream()
    cell = RefCell(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                   nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
    with tempfile.TemporaryDirectory() as d:
        single_path = os.path.join(d, "single.pcap")
        _, _, t_single = multihost_cell.run_single(ref_core, cell, stream,
                                                   single_path)
        single_recs = ref_pcap.read_pcap(single_path)
        blocks, cores, logs, secs = multihost_cell.run_hosts(
            ref_core, ref_multihost, cell, stream, d)
        merged_recs = ref_multihost.merge_pcap_records(
            [ref_pcap.read_pcap(os.path.join(d, f"host{h}.pcap"))
             for h in range(len(blocks))], blocks)
    dcis = multihost_cell.merged_dcis(ref_multihost, logs, blocks)
    results = ref_multihost.merge_accepted([c.results for c in cores],
                                           blocks)
    rec = multihost_cell.record(
        dcis, results, len(single_recs), len(merged_recs),
        multihost_cell.count_differing(merged_recs, single_recs))
    rec["placed"] = int(placed)
    with open(EXPECTED, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED} "
          f"({os.path.getsize(EXPECTED)} B); single host {t_single:.0f} s, "
          f"blocks {[round(s) for s in secs]} s on the CPU")
    print(f"placed {placed}, merged DCIs {len(dcis)}, merged results "
          f"{len(results)} ({rec['pdsch_ok'].count('1')} CRC-ok), pcap "
          f"records single {len(single_recs)} merged {len(merged_recs)} "
          f"differ {rec['n_records_differ']}")


if __name__ == "__main__":
    if "--regen-multihost" in sys.argv:
        _regen_multihost()
        sys.exit(0)
    print(__doc__)
    sys.exit(2)
