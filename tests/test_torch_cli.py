"""The port's command-line interface, against the JAX package's.

* tests/test_observability_cli.py's CLI and observability tests, mirrored
  on the port with `--device cpu`: the `-D` DCI trace and the
  `mcs_statistic.csv`, the heartbeat, the flags plumbing, `--sync`
  through the stream tracker, SIGINT as a graceful stop;
* both CLIs on the same IQ files (the aligned path, `--sync` stream,
  `--sync once`, and `-u` dual-carrier, aligned): byte-equal pcaps and equal
  `--stats-json` counts (the wall-clock fields aside);
* `--device cuda` without a card raises, with no fallback;
* the committed expected record of the card's CLI run
  (`ltesniffer_tpu_torch/testing/cli_expected.json`: the DL golden stream
  behind a 777-sample lead, `--sync`) matches the scenario, and the port's
  CLI on the CPU reproduces it.

The record is (re)generated by running the JAX package's CLI on the CPU:
    python -m tests.test_torch_cli --regen-cli
Regenerate ONLY when the scenario or the reference's behavior changes on
purpose, and say why in the commit message.
"""
import hashlib
import io
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from ltesniffer_tpu import cli as ref_cli
from ltesniffer_tpu.mac_rrc import mac as ref_mac
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.testing import scenario as ref_scenario

from ltesniffer_tpu_torch import cli
from ltesniffer_tpu_torch.io import iq as iq_mod, pcap
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, observability
from ltesniffer_tpu_torch.testing import stream_cell

from tests import test_golden_replay as golden

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED_CLI = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                            "cli_expected.json")
CFG = dict(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
CELL = CellConfig(**CFG)
CELL_ARGS = ["-c", "55", "-p", "50", "-P", "2"]
CPU = ["--device", "cpu"]


def _traffic_stream(n_sf=14, rnti=0x4141):
    sb = ref_scenario.ScenarioBuilder(RefCell(**CFG), seed=9)
    pdu = ref_mac.build_mac_pdu([ref_mac.MacSubPdu(lcid=3,
                                                   payload=b"obs-test")])
    ndi = 0
    for j in range(n_sf):
        txs = []
        if j >= 2:
            ndi ^= 1
            txs.append(ref_scenario.DlTx(rnti=rnti, mac_pdu=pdu, n_prb=10,
                                         prb_start=12, harq_pid=j % 8,
                                         ndi=ndi))
        sb.add_subframe(j % 10, txs)
    return sb.stream()


def _sync_stream():
    """test_cli_sync_routes_through_stream_tracker's trace: 40 subframes
    with PBCH behind a third of a subframe of noise."""
    sb = ref_scenario.ScenarioBuilder(RefCell(**CFG), seed=9)
    pdu = ref_mac.build_mac_pdu([ref_mac.MacSubPdu(lcid=3,
                                                   payload=b"obs-test")])
    for j in range(40):
        sf = j % 10
        txs = []
        if j >= 2 and sf not in (0, 5):
            txs.append(ref_scenario.DlTx(rnti=0x4141, mac_pdu=pdu, n_prb=10,
                                         prb_start=12, harq_pid=j % 8,
                                         ndi=(j // 8) % 2))
        sb.add_subframe(sf, txs,
                        with_pbch_sfn=j // 10 if sf == 0 else None)
    rng = np.random.default_rng(3)
    n_lead = CELL.sf_len // 3
    lead = (0.01 * (rng.standard_normal(n_lead)
                    + 1j * rng.standard_normal(n_lead))).astype(np.complex64)
    return np.concatenate([lead, sb.stream()])


def test_dci_trace_and_csv_written(tmp_path):
    trace = tmp_path / "dci.trace"
    csvp = tmp_path / "mcs.csv"
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=CELL, batch_size=8, dci_trace_path=str(trace),
        mcs_csv_path=str(csvp), device="cpu"))
    c.run_samples(_traffic_stream())
    c.close()
    assert c.dci_trace is None   # handle released
    lines = trace.read_text().strip().splitlines()
    # one line per accepted DCI (>= decoded grants: HARQ skips drop some)
    assert len(lines) >= len(c.results) >= 8
    # line format: ts, sfn, sf, rnti, fmt, ncce, L, histval
    cols = lines[0].split("\t")
    assert len(cols) == 8
    assert int(cols[3]) == 0x4141
    rows = csvp.read_text().strip().splitlines()
    assert rows[0].startswith("direction,rnti,table")
    assert any("0x4141" in r and r.startswith("dl") for r in rows[1:])


def test_heartbeat_counts():
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=CELL, batch_size=8, heartbeat=True, device="cpu"))
    buf = io.StringIO()
    c.heartbeat = observability.Heartbeat(out=buf, every=8)
    c.run_samples(_traffic_stream(n_sf=10))
    assert "[heartbeat] Processed 8/8 subframes" in buf.getvalue()
    assert c.heartbeat.processed == 10


def test_cli_flags_plumb_through(tmp_path):
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), _traffic_stream())
    out_pcap = tmp_path / "out.pcap"
    trace = tmp_path / "dci.trace"
    csvp = tmp_path / "mcs.csv"
    rc = cli.main(["-i", str(iq_path)] + CELL_ARGS + [
        "-o", str(out_pcap), "--heartbeat", "--dci-trace", str(trace),
        "--csv", str(csvp), "-B", "8"] + CPU)
    assert rc == 0
    assert trace.exists() and len(trace.read_text().splitlines()) >= 8
    assert csvp.exists() and "0x4141" in csvp.read_text()
    assert len(pcap.read_pcap(str(out_pcap))) >= 8


def test_cli_sync_routes_through_stream_tracker(tmp_path, monkeypatch):
    """--sync (stream mode) must use the continuous tracker: a trace with
    a leading sample offset still decodes via PSS-tracked framing."""
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), _sync_stream())
    out_pcap = tmp_path / "out.pcap"
    calls = []
    orig = core.LTESnifferCore.run_stream
    monkeypatch.setattr(core.LTESnifferCore, "run_stream",
                        lambda self, *a, **k: (calls.append(1),
                                               orig(self, *a, **k))[1])
    rc = cli.main(["-i", str(iq_path)] + CELL_ARGS + [
        "-o", str(out_pcap), "--sync", "-B", "8"] + CPU)
    assert rc == 0 and calls == [1]
    recs = [r for r in pcap.read_pcap(str(out_pcap))
            if r.get("rnti") == 0x4141]
    assert len(recs) >= 15


@pytest.mark.skipif(sys.platform == "win32", reason="POSIX signals")
def test_cli_sigint_graceful_stop(tmp_path):
    """SIGINT mid-run drains in-flight work and still writes a valid pcap."""
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), _traffic_stream(n_sf=14))
    out_pcap = tmp_path / "out.pcap"
    fired = {"n": 0}
    orig = core.LTESnifferCore._phase3
    stopped = []

    def patched(self, ctx):
        orig(self, ctx)
        fired["n"] += 1
        if fired["n"] == 1:   # after the first batch resolves, interrupt
            os.kill(os.getpid(), signal.SIGINT)
            stopped.append(self.stop_requested)

    core.LTESnifferCore._phase3 = patched
    try:
        rc = cli.main(["-i", str(iq_path)] + CELL_ARGS + [
            "-o", str(out_pcap), "-B", "4"] + CPU)
    finally:
        core.LTESnifferCore._phase3 = orig
    assert rc == 0   # graceful: no KeyboardInterrupt escape
    assert stopped == [True]
    assert fired["n"] < 4     # the stop cut the 4-batch run short
    assert isinstance(pcap.read_pcap(str(out_pcap)), list)
    assert signal.getsignal(signal.SIGINT) not in (None,)


def test_cli_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), _traffic_stream(n_sf=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", str(iq_path)] + CELL_ARGS + [
            "-o", str(tmp_path / "x.pcap")])


def test_cli_missing_input_returns_2(tmp_path):
    assert cli.main(["-i", str(tmp_path / "none.iq")] + CPU) == 2


def _stats(path):
    s = json.load(open(path))
    for k in stream_cell.CLI_CLOCK_KEYS:
        s.pop(k)
    return s


def _run_both(tmp, args):
    """Both CLIs with the same arguments -> {name: (pcap bytes, stats)}."""
    out = {}
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, CPU)):
        pc, st = tmp / f"{name}.pcap", tmp / f"{name}.json"
        assert main(args + ["-o", str(pc), "--stats-json", str(st)]
                    + extra) == 0
        out[name] = (open(pc, "rb").read(), _stats(st))
    return out


@pytest.mark.parametrize("mode", ["aligned", "sync", "sync-once",
                                  "dual"])
def test_both_clis_equal(tmp_path, mode):
    if mode == "aligned":
        x, extra = _traffic_stream(), ["-B", "8"]
    elif mode == "dual":
        # aligned: the CLI's one-shot `--sync` cuts only the DL stream in
        # `-u` mode (the reference's behavior, kept), so a lead would
        # misalign the UL
        x, ul = golden._build_dual()
        ul_path = tmp_path / "ul.iq"
        iq_mod.write_iq(str(ul_path), ul)
        extra = ["-u", str(ul_path), "-B", "8"]
    else:
        x = _sync_stream()
        extra = ["--sync"] + (["once"] if mode == "sync-once" else []) + \
            ["-B", "8"]
    iq_path = tmp_path / "trace.iq"
    iq_mod.write_iq(str(iq_path), x)
    cell = ["-c", "199", "-p", "50", "-P", "2"] if mode == "dual" \
        else CELL_ARGS
    out = _run_both(tmp_path, ["-i", str(iq_path)] + cell + extra)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    # decoded records reached the pcap (UL ones in the dual mode)
    assert len(pcap_records(tmp_path / "port.pcap")) >= 8


def pcap_records(path):
    return pcap.read_pcap(str(path))


def test_cli_expected_record(tmp_path):
    """The card's CLI scenario: the record matches it, and the port's CLI
    on the CPU reproduces the JAX CLI's pcap and counts."""
    rec = json.load(open(EXPECTED_CLI))
    assert rec["lead"] == stream_cell.CLI_LEAD
    assert rec["noise_seed"] == stream_cell.NOISE_SEED
    cell, stream, _ = stream_cell.golden_scenario()
    iq_path = str(tmp_path / "golden_lead.iq")
    iq_mod.write_iq(iq_path, stream_cell.cli_stream(stream))
    pc, st = str(tmp_path / "cli.pcap"), str(tmp_path / "cli.json")
    args = stream_cell.cli_args(cell, iq_path, pc, st)
    assert [a for a in args if not a.startswith(str(tmp_path))] == \
        rec["args"]
    assert cli.main(args + CPU) == 0
    assert hashlib.sha256(open(pc, "rb").read()).hexdigest() == \
        rec["pcap_sha256"]
    assert _stats(st) == rec["stats"]
    assert rec["stats"]["pdsch_ok"] > 0


def _regen_cli():
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    cell, stream, _ = stream_cell.golden_scenario()
    with tempfile.TemporaryDirectory() as d:
        iq_path = os.path.join(d, "golden_lead.iq")
        iq_mod.write_iq(iq_path, stream_cell.cli_stream(stream))
        pc, st = os.path.join(d, "cli.pcap"), os.path.join(d, "cli.json")
        args = stream_cell.cli_args(cell, iq_path, pc, st)
        assert ref_cli.main(args) == 0
        rec = {"scenario": "tests/test_golden_replay.py:_build_stream",
               "lead": stream_cell.CLI_LEAD,
               "noise_seed": stream_cell.NOISE_SEED,
               "args": [a for a in args if not a.startswith(d)],
               "pcap_sha256": hashlib.sha256(open(pc, "rb").read()
                                             ).hexdigest(),
               "stats": _stats(st)}
    with open(EXPECTED_CLI, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_CLI}: {rec}")


if __name__ == "__main__":
    if "--regen-cli" in sys.argv:
        _regen_cli()
        sys.exit(0)
    print(__doc__)
    sys.exit(2)
