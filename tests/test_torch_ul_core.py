"""The port's uplink (UL mode) as a whole, against the JAX package.

* `ltesniffer_tpu_torch`'s `LTESnifferCoreUL.run_dual_samples` on the CPU
  reproduces the sha256 of tests/golden/ul_mode.pcap from the streams the
  JAX package's own `testing.scenario` builds;
* on the same dual-carrier input, both cores give equal `ul_results`
  (RNTI, SFN, subframe, CRC flag, TBS, payload, MCS table, RAR origin;
  `snr_db` within 1e-3 dB and `ta_us` within 1e-4 us, which are float sums
  in another order), equal UL statistics, byte-equal pcaps and equal
  `summary()` dicts;
* `tests/test_ul_mode_e2e.py` (its first three tests) and
  `tests/test_ul_batch.py` (all three) mirrored on the port, each scenario
  also run through the JAX package's core and compared;
* the committed expected record of the bench's UL cell
  (`ltesniffer_tpu_torch/testing/ul_expected.json`), which chip_smoke.py
  holds the card's run against, matches `testing/ul_cell.py`.

The scenarios are 50 PRB and a few dozen subframes; the 100-PRB UL cell
runs on the card only.  Its record is (re)generated by running the JAX
package on the CPU over the full streams:
    python -m tests.test_torch_ul_core --regen-ul
Regenerate ONLY when the scenario or the reference's behavior changes on
purpose, and say why in the commit message.
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import core as ref_core
from ltesniffer_tpu.sniffer import pusch_rx as ref_pusch
from ltesniffer_tpu.testing import scenario as ref_scenario

from ltesniffer_tpu_torch.io import pcap
from ltesniffer_tpu_torch.phy import dci as dci_mod, ra, search_space, tables
from ltesniffer_tpu_torch.phy import grid as grid_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, prach_rx, pusch_rx, trackers
from ltesniffer_tpu_torch.testing import encoder, ul_cell

from tests import test_golden_replay as golden

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED_UL = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                           "ul_expected.json")
SNR_TOL_DB = 1e-3
TA_TOL_US = 1e-4

CFG = dict(n_id_cell=147, n_prb=50, nof_ports=2, nof_rx_ant=1)
REF_CELL, CELL = RefCell(**CFG), CellConfig(**CFG)
CFI = 2


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _run(mod, cell, dl, ul, tmp=None, name="x", setup=None, **cfg_kw):
    """One core (either package) over a dual stream -> (core, pcap bytes)."""
    extra = {"device": "cpu"} if mod is core else {}
    path = str(tmp / f"{name}.pcap") if tmp is not None else None
    cfg = mod.SnifferConfig(cell=cell, pcap_path=path, **cfg_kw, **extra)
    c = mod.LTESnifferCoreUL(cfg)
    if setup is not None:
        setup(c)
    c.run_dual_samples(dl, ul)
    c.close()
    return c, (open(path, "rb").read() if path else None)


def assert_same_ul(port, ref):
    """Equal UL results and statistics of two cores on the same input."""
    assert len(port.ul_results) == len(ref.ul_results)
    for p, r in zip(port.ul_results, ref.ul_results):
        assert (p.rnti, p.sfn, p.sf_idx, p.crc_ok, p.tbs, p.payload,
                p.table.value, p.from_rar) == \
            (r.rnti, r.sfn, r.sf_idx, r.crc_ok, r.tbs, r.payload,
             r.table.value, r.from_rar)
        assert abs(p.snr_db - r.snr_db) <= SNR_TOL_DB
        assert abs(p.ta_us - r.ta_us) <= TA_TOL_US
    assert {rn: (st.new_tx, st.success, st.fail)
            for rn, st in port.mcs.stats_ul.items()} == \
        {rn: (st.new_tx, st.success, st.fail)
         for rn, st in ref.mcs.stats_ul.items()}
    assert {rn: t.value for rn, t in port.mcs.ul_table.items()} == \
        {rn: t.value for rn, t in ref.mcs.ul_table.items()}
    assert port.summary() == ref.summary()
    assert port.prach_detections == ref.prach_detections


# ---------------------------------------------------------------------------
# the UL golden
# ---------------------------------------------------------------------------
def test_port_reproduces_ul_golden_pcap(tmp_path):
    dl, ul = golden._build_dual()
    c, got = _run(core, golden_cell(), dl, ul, tmp_path, "ul",
                  batch_size=8, acquire_sfn=False)
    assert hashlib.sha256(got).hexdigest() == _sha(golden.GOLDEN_UL_PCAP)
    assert sum(r.crc_ok for r in c.ul_results) >= 15


def golden_cell():
    return CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)


def _mixed_streams(n_sf=24):
    """A 50-PRB dual-carrier stream from the JAX package's generator: four
    grants per subframe over 12 UEs, QPSK and 16QAM-region MCS (the
    16QAM ones run the table cascade and learn)."""
    sb = ref_scenario.DualScenarioBuilder(REF_CELL, cfi=CFI, seed=5)
    rng = np.random.default_rng(5)
    from ltesniffer_tpu.phy import tables as ref_tables
    for j in range(n_sf):
        txs = []
        for g in range(4):
            rnti = 0x500 + (j * 4 + g) % 12
            mcs = 14 if rnti % 3 == 0 else 6
            _, itbs = ref_tables.ul_mcs_to_qm_itbs(mcs)
            tbs = ref_tables.tbs_lookup(itbs, 8)
            txs.append(ref_scenario.UlTx(
                rnti=rnti, tb_bits=rng.integers(0, 2, tbs).astype(np.uint8),
                mcs=mcs, prb_start=2 + 12 * g, n_prb=8))
        sb.add_subframe(j % 10, txs, strict=False)
    return sb.streams()


_MIXED = {}


def _mixed(tmp_path_factory):
    if not _MIXED:
        tmp = tmp_path_factory.mktemp("mixed")
        dl, ul = _mixed_streams()
        for name, mod, cell in (("ref", ref_core, REF_CELL),
                                ("port", core, CELL)):
            _MIXED[name] = _run(mod, cell, dl, ul, tmp, name, batch_size=8,
                                acquire_sfn=False)
    return _MIXED


def test_both_cores_equal_on_mixed_cell(tmp_path_factory):
    out = _mixed(tmp_path_factory)
    assert_same_ul(out["port"][0], out["ref"][0])
    ok = [r for r in out["port"][0].ul_results if r.crc_ok]
    assert len(ok) >= 0.9 * len(out["port"][0].ul_results) > 40
    assert any(r.table == trackers.McsTable.UL_16QAM for r in ok)


def test_pcaps_equal_on_mixed_cell(tmp_path_factory):
    out = _mixed(tmp_path_factory)
    assert out["port"][1] == out["ref"][1] and len(out["port"][1]) > 1000


def test_both_cores_equal_on_ul_golden(tmp_path):
    dl, ul = golden._build_dual()
    ref_cell = RefCell(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    r, _ = _run(ref_core, ref_cell, dl, ul, batch_size=8, acquire_sfn=False)
    p, _ = _run(core, golden_cell(), dl, ul, batch_size=8,
                acquire_sfn=False)
    assert_same_ul(p, r)


def test_ul_core_needs_the_card_by_default():
    cfg = core.SnifferConfig(cell=CELL)
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            core.LTESnifferCoreUL(cfg)


# ---------------------------------------------------------------------------
# test_ul_mode_e2e.py (first three tests), built by the port's generator
# ---------------------------------------------------------------------------
def _nof_cce():
    return grid_mod.control_region(CELL, CFI)["nof_pdcch_regs"] // 9


def _noisy_ul(ug, rng, noise):
    un = ug + noise / np.sqrt(2) * (rng.standard_normal(ug.shape)
                                    + 1j * rng.standard_normal(ug.shape))
    return encoder.ul_subframe_iq(CELL, un.astype(np.complex64))[0]


def _both(dl, ul, tmp_path, setup=None, **cfg_kw):
    """Port and reference cores on the same streams; results compared."""
    p, pp = _run(core, CELL, dl, ul, tmp_path, "port", setup=setup,
                 **cfg_kw)
    r, rp = _run(ref_core, REF_CELL, dl, ul, tmp_path, "ref", setup=setup,
                 **cfg_kw)
    assert_same_ul(p, r)
    assert pp == rp
    return p


def test_dci0_to_pusch_chain(tmp_path):
    rng = np.random.default_rng(0)
    rnti = 0x2e2e
    ul_mcs = 6
    prb_start, n_prb = 5, 10
    qm, i_tbs = tables.ul_mcs_to_qm_itbs(ul_mcs)
    tbs = tables.tbs_lookup(i_tbs, n_prb)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    h_dl = encoder.flat_channel(CELL, 1, rng)
    dl_frames, ul_frames = [], []
    at = 2
    for j in range(10):
        txs = []
        if j == at:
            cands = search_space.ue_candidates(rnti, j, _nof_cce())
            l, ncce = [c for c in cands if c[0] == 2][0]
            txs.append(encoder.TxDci(dci=dci_mod.Dci(
                fmt="0", rnti=rnti, fields=dict(
                    flag0_1a=0, hopping=0,
                    riv=ra.start_len_to_riv(prb_start, n_prb, 50),
                    mcs=ul_mcs, ndi=1, tpc=0, dmrs_cs=2, cqi_request=0)),
                L=l, ncce=ncce))
        g = encoder.build_control_subframe(CELL, j, CFI, txs)
        dl_frames.append(encoder.subframe_iq(
            CELL, encoder.apply_channel(g, h_dl, 0.04, rng))[0])
        ug = (encoder.build_ul_subframe(CELL, j, [dict(
            rnti=rnti, prb_start=prb_start, n_prb=n_prb, qm=qm,
            tb_bits=tb, dmrs_field=2)]) if j == at + 4
            else np.zeros((1, 14, CELL.n_sc), np.complex64))
        ul_frames.append(_noisy_ul(ug, rng, 0.03))
    c = _both(np.concatenate(dl_frames), np.concatenate(ul_frames),
              tmp_path, batch_size=4)
    assert len(c.ul_results) == 1
    r = c.ul_results[0]
    assert r.rnti == rnti and r.crc_ok and r.sf_idx == at + 4
    np.testing.assert_array_equal(
        np.unpackbits(np.frombuffer(r.payload, np.uint8))[:tbs], tb)
    assert r.snr_db > 10 and abs(r.ta_us) < 1.0
    recs = pcap.read_pcap(str(tmp_path / "port.pcap"))
    ul_recs = [x for x in recs if x["direction"] == pcap.DIRECTION_UPLINK]
    assert len(ul_recs) == 1 and ul_recs[0]["rnti"] == rnti


def test_uci_ack_ri_through_core(tmp_path):
    """PUSCH carrying multiplexed HARQ-ACK + RI + aperiodic CQI decodes
    through the core loop (`testing/ul_cell.uci_scenario`)."""
    dl, ul, rnti, tb = ul_cell.uci_scenario(CELL)
    c = _both(dl, ul, tmp_path, batch_size=4)
    assert len(c.ul_results) == 1
    r = c.ul_results[0]
    assert r.rnti == rnti and r.crc_ok, (r.rnti, r.crc_ok, r.snr_db)
    np.testing.assert_array_equal(
        np.unpackbits(np.frombuffer(r.payload, np.uint8))[:len(tb)], tb)


def test_ul_table_cascade_learns_16qam(tmp_path):
    rng = np.random.default_rng(1)
    rnti = 0x3f3f
    ul_mcs = 14
    prb_start, n_prb = 0, 8
    qm, i_tbs = tables.ul_mcs_to_qm_itbs(ul_mcs)
    assert qm == 4
    tbs = tables.tbs_lookup(i_tbs, n_prb)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    dl_frames, ul_frames = [], []
    for j in range(8):
        g = encoder.build_control_subframe(CELL, j, CFI, [])
        h_dl = encoder.flat_channel(CELL, 1, rng)
        dl_frames.append(encoder.subframe_iq(
            CELL, encoder.apply_channel(g, h_dl, 0.04, rng))[0])
        ug = (encoder.build_ul_subframe(CELL, j, [dict(
            rnti=rnti, prb_start=prb_start, n_prb=n_prb, qm=qm,
            tb_bits=tb, dmrs_field=1)]) if j == 5
            else np.zeros((1, 14, CELL.n_sc), np.complex64))
        ul_frames.append(_noisy_ul(ug, rng, 0.02))

    def inject(c):
        # the grant directly (bypassing the DCI path tested above); both
        # packages' trackers take their own grant class
        tr = sys.modules[type(c).__module__.rsplit(".", 1)[0] + ".trackers"]
        tti = tr.tti_of(0, 1)
        c.ulsche.pending[(tti + 4) % tr.TTI_MAX] = [tr.UlGrantPending(
            rnti=rnti, tti_apply=0, mcs=ul_mcs, prb_start=prb_start,
            n_prb=n_prb, ndi=0, dmrs_cs=1)]
    c = _both(np.concatenate(dl_frames), np.concatenate(ul_frames),
              tmp_path, setup=inject, batch_size=8)
    assert len(c.ul_results) == 1 and c.ul_results[0].crc_ok
    assert c.mcs.ul_table_of(rnti) == trackers.McsTable.UL_16QAM


# ---------------------------------------------------------------------------
# test_ul_batch.py, built by the port's generator
# ---------------------------------------------------------------------------
def _dual_stream(rng, ul_specs, n_sf=14):
    """test_ul_batch.py:_dual_stream through the port's encoder."""
    h_dl = encoder.flat_channel(CELL, 1, rng)
    by_dl, by_ul = {}, {}
    for s in ul_specs:
        by_dl.setdefault(s["sf"], []).append(s)
        by_ul.setdefault(s["sf"] + 4, []).append(s)
    dl_frames, ul_frames = [], []
    for j in range(n_sf):
        txs = []
        used = set()
        for s in by_dl.get(j, []):
            cands = search_space.ue_candidates(s["rnti"], j % 10, _nof_cce())
            l, ncce = next(c for c in cands if c[0] == 2
                           and not set(range(c[1], c[1] + 4)) & used)
            used.update(range(ncce, ncce + 4))
            txs.append(encoder.TxDci(dci=dci_mod.Dci(
                fmt="0", rnti=s["rnti"], fields=dict(
                    flag0_1a=0, hopping=0,
                    riv=ra.start_len_to_riv(s["prb_start"], s["n_prb"], 50),
                    mcs=s["mcs"], ndi=1, tpc=0, dmrs_cs=0, cqi_request=0)),
                L=l, ncce=ncce))
        g = encoder.build_control_subframe(CELL, j % 10, CFI, txs)
        dl_frames.append(encoder.subframe_iq(
            CELL, encoder.apply_channel(g, h_dl, 0.04, rng))[0])
        jobs = [dict(rnti=s["rnti"], prb_start=s["prb_start"],
                     n_prb=s["n_prb"], qm=s["qm"], tb_bits=s["tb_bits"],
                     dmrs_field=0)
                for s in by_ul.get(j, []) if s.get("tb_bits") is not None]
        ug = (encoder.build_ul_subframe(CELL, j % 10, jobs) if jobs
              else np.zeros((1, 14, CELL.n_sc), np.complex64))
        ul_frames.append(_noisy_ul(ug, rng, 0.03))
    return np.concatenate(dl_frames), np.concatenate(ul_frames)


def test_batched_multi_grant_subframe(tmp_path):
    rng = np.random.default_rng(5)
    specs = []
    for k in range(3):
        qm, i_tbs = tables.ul_mcs_to_qm_itbs(6)
        tbs = tables.tbs_lookup(i_tbs, 8)
        specs.append(dict(rnti=0x3000 + k, sf=2, mcs=6, qm=qm,
                          prb_start=2 + 9 * k, n_prb=8,
                          tb_bits=rng.integers(0, 2, tbs).astype(np.uint8)))
    dl, ul = _dual_stream(rng, specs)

    def activate(c):   # known-active RNTIs (established UEs)
        rm_mod = sys.modules[type(c).__module__.rsplit(".", 1)[0]
                             + ".rnti_manager"]
        for s in specs:
            c.rm.activate_and_refresh(s["rnti"],
                                      rm_mod.FORMAT_TO_INDEX["0"],
                                      rm_mod.ActivationReason.OTHER)
    c = _both(dl, ul, tmp_path, setup=activate, batch_size=14)
    ok = [r for r in c.ul_results if r.crc_ok]
    assert {r.rnti for r in ok} == {0x3000, 0x3001, 0x3002}
    for r, s in zip(sorted(ok, key=lambda r: r.rnti), specs):
        got = np.unpackbits(np.frombuffer(r.payload, np.uint8))
        np.testing.assert_array_equal(got[:len(s["tb_bits"])], s["tb_bits"])


def test_ul_trial_rate_limiting(monkeypatch):
    """An RNTI whose grants never decode stops burning cascade trials;
    once the budget is spent each grant dispatches one variant."""
    rng = np.random.default_rng(6)
    rnti = 0x3111
    specs = [dict(rnti=rnti, sf=s, mcs=21, qm=4, prb_start=4, n_prb=8,
                  tb_bits=None) for s in range(1, 9)]
    dl, ul = _dual_stream(rng, specs, n_sf=14)
    c = core.LTESnifferCoreUL(core.SnifferConfig(cell=CELL, batch_size=14,
                                                 device="cpu"))
    seen_jobs = []
    orig = pusch_rx.dispatch_grants_ul_batch

    def spy(grids, cell, jobs, **kw):
        seen_jobs.append(len(jobs))
        return orig(grids, cell, jobs, **kw)
    monkeypatch.setattr(pusch_rx, "dispatch_grants_ul_batch", spy)
    c.run_dual_samples(dl, ul)
    n_phase1 = len(c.ul_results)
    assert n_phase1 >= c.mcs.UL_TRIAL_LIMIT
    assert not any(r.crc_ok for r in c.ul_results)
    assert c.mcs.ul_trials[rnti] >= c.mcs.UL_TRIAL_LIMIT
    assert not c.mcs.ul_trial_budget_ok(rnti)
    specs2 = [dict(rnti=rnti, sf=s, mcs=21, qm=4, prb_start=4, n_prb=8,
                   tb_bits=None) for s in (1, 3)]
    dl2, ul2 = _dual_stream(rng, specs2, n_sf=10)
    n_before = len(seen_jobs)
    c.run_dual_samples(dl2, ul2)
    n_phase2 = len(c.ul_results) - n_phase1
    assert n_phase2 >= 1
    assert sum(seen_jobs[n_before:]) == n_phase2
    assert sum(seen_jobs[:n_before]) > n_phase1   # trials before the limit


def test_prach_wired_into_ul_loop(tmp_path):
    rng = np.random.default_rng(7)
    dl, ul = _dual_stream(rng, [], n_sf=6)
    u, shift = 129, 26
    tx = prach_rx.prach_tx(CELL, u, shift, prach_freq_offset=4)
    n = CELL.sf_len
    ul = ul.copy()
    ul[3 * n:3 * n + len(tx)] += 3.0 * tx

    def sib2(c):   # logical 0 -> physical u=129 (36.211 Table 5.7.2-4)
        c.ulsche.set_sib2(dict(prach_config_index=14, prach_root_seq_index=0,
                               prach_freq_offset=4, zero_correlation_zone=1))
    c = _both(dl, ul, tmp_path, setup=sib2, batch_size=6)
    hits = [d for d in c.prach_detections if d["sf_idx"] == 3]
    assert hits, f"no PRACH detection at sf 3: {c.prach_detections}"
    d = max(hits, key=lambda d: d["peak"])
    assert d["root"] == u and d["preamble"] == shift // 13


# ---------------------------------------------------------------------------
# expected record of the bench's UL cell
# ---------------------------------------------------------------------------
def test_ul_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED_UL))
    assert rec["params"] == ul_cell.params()
    cfg = rec["config"]
    assert cfg["batch_size"] == ul_cell.BATCH and cfg["turbo_iters"] == 2
    assert cfg["turbo_iters_max"] == 12 and cfg["acquire_sfn"] is False
    assert rec["placed"] > 0 and rec["n_results"] == len(rec["results"])
    assert rec["crc_ok"] == sum(r[3] for r in rec["results"])
    assert all(len(d) == 2 for d in rec["dci0"])
    # every result is a PUSCH 4 subframes after an accepted DCI0
    dci0 = {tuple(d) for d in rec["dci0"]}
    assert all((r[0] * 10 + r[1] - 4, r[2]) in dci0 for r in rec["results"])
    _, itbs = tables.ul_mcs_to_qm_itbs(ul_cell.UL_MCS)
    assert {r[4] for r in rec["results"]} == \
        {tables.tbs_lookup(itbs, ul_cell.N_PRB_GRANT)}
    assert os.path.getsize(EXPECTED_UL) < 512 * 1024


def ref_ul_streams(n_sf: int):
    """The UL cell's IQ from the JAX package's generator
    (`bench.py:run_ul_e2e`'s `_build`, with the port's parameters)."""
    from ltesniffer_tpu.phy import tables as ref_tables
    p = ul_cell.params(n_sf)
    cell = RefCell(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                   nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
    rng = np.random.default_rng(p["seed"])
    sb = ref_scenario.DualScenarioBuilder(cell, cfi=p["cfi"], seed=p["seed"])
    _, itbs = ref_tables.ul_mcs_to_qm_itbs(p["ul_mcs"])
    tbs = ref_tables.tbs_lookup(itbs, p["n_prb_grant"])
    placed = 0
    for j in range(n_sf):
        txs = [ref_scenario.UlTx(
            rnti=p["rnti0"] + ((j * p["grants"] + g) % p["n_rnti"]),
            tb_bits=rng.integers(0, 2, tbs).astype(np.uint8),
            mcs=p["ul_mcs"], prb_start=g * p["n_prb_grant"],
            n_prb=p["n_prb_grant"]) for g in range(p["grants"])]
        placed += sb.add_subframe(j % 10, txs, strict=False)
    dl, ul = sb.streams()
    return dl, ul, placed


def _regen_ul():
    import dataclasses
    import jax
    from ltesniffer_tpu.kernels import cplx as ref_cplx
    jax.config.update("jax_platforms", "cpu")
    p = ul_cell.params()
    dl, ul, placed = ref_ul_streams(p["n_sf"])
    n = ul_cell.CELL.sf_len
    T = p["n_sf"]
    dlp = ref_cplx.to_i8_packed(dl[:T * n].reshape(T, 1, n))
    ulp = ref_cplx.to_i8_packed(ul[:T * n].reshape(T, 1, n))
    cell = RefCell(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                   nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
    cfg = ref_core.SnifferConfig(cell=cell, batch_size=ul_cell.BATCH,
                                 acquire_sfn=False)
    c = ref_core.LTESnifferCoreUL(cfg)
    log = ul_cell.log_dci0(c)
    c.run_dual_packed(dlp, ulp)
    c.close()
    results = ul_cell.result_rows(c)
    cfg_dict = {k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ("batch_size", "turbo_iters", "turbo_iters_max",
                         "acquire_sfn", "pipeline_depth", "ingest")}
    rec = {"params": p, "config": cfg_dict, "placed": int(placed),
           "n_results": len(results),
           "crc_ok": sum(r[3] for r in results),
           "summary": {k: v for k, v in c.summary().items()
                       if k != "search_stats"},
           "dci0": log, "results": results}
    with open(EXPECTED_UL, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_UL} "
          f"({os.path.getsize(EXPECTED_UL)} B)")
    print(f"placed {placed}, accepted DCI0 {len(log)}, PUSCH results "
          f"{len(results)}, CRC-ok {rec['crc_ok']}")


if __name__ == "__main__":
    if "--regen-ul" in sys.argv:
        _regen_ul()
        sys.exit(0)
    print(__doc__)
    sys.exit(2)
