"""The port's stream drivers and ingest options, against the JAX package.

* `run_stream` on tests/test_core_e2e.py's gap-recovery stream: both cores
  give equal results, byte-equal pcaps and equal `summary()` dicts
  (`resyncs` and `sync_losses` included); `run_source` over odd-sized
  blocks equals `run_stream`, in both packages;
* the live-mode invariants of tests/test_observability_cli.py (drops are
  counted, kept + dropped never exceed the framed subframes, the
  heartbeat ticks each drop);
* `FileSource`, `ArraySource(chunk_limit=...)` and the SoapySDR gate;
* the golden DL scenario under every ingest ("i8", "i16", "f32") and
  pipeline depth (1, 2, 3): the port's pcap is byte-equal to the JAX
  package's run with the same options, and to the committed record the
  card is held against (`ltesniffer_tpu_torch/testing/ingest_expected.json`);
  on a stream with a residual CFO, both cores' CFO integrators and results
  agree under "f32" (host de-rotation) and "i16" (device de-rotation);
* `Frontend.run_i16` and the complex64 entry `Frontend.run` against the
  reference's `jitted_i16` and `run`: float32 results within rtol 1e-4
  plus atol 1e-4 of the tensor's peak, CFI equal;
* `run_dual_source` with an inter-stream skew of either sign (mirroring
  tests/test_ul_mode_e2e.py:test_run_dual_source_with_interstream_skew):
  equal `ul_results` and pcaps across the packages; without the skew
  compensation the UL decode fails in both;
* the committed expected records of the 20 MHz stream scenarios
  (`testing/stream_cell.py`), which chip_smoke.py phase 7 holds the
  card's runs against, match the scenarios.

The records are (re)generated by running the JAX package on the CPU over
the streams `testing/stream_cell.py` builds:
    python -m tests.test_torch_stream --regen-dl-stream   (~10 minutes)
    python -m tests.test_torch_stream --regen-ul-stream   (~5 minutes)
    python -m tests.test_torch_stream --regen-ingest      (~1 minute)
Regenerate ONLY when a scenario or the reference's behavior changes on
purpose, and say why in the commit message.
"""
import hashlib
import io
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from ltesniffer_tpu.io import sdr as ref_sdr
from ltesniffer_tpu.kernels import cplx as ref_cplx
from ltesniffer_tpu.mac_rrc import mac as ref_mac
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import core as ref_core
from ltesniffer_tpu.sniffer import frontend as ref_frontend
from ltesniffer_tpu.sniffer import sync as ref_sync
from ltesniffer_tpu.testing import encoder as ref_encoder
from ltesniffer_tpu.testing import scenario as ref_scenario

from ltesniffer_tpu_torch.io import iq as iq_mod, pcap, sdr
from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, frontend, observability, sync
from ltesniffer_tpu_torch.testing import loaded_cell, stream_cell, ul_cell

from tests import test_golden_replay as golden
from tests.test_torch_frontend import close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTING = os.path.join(REPO, "ltesniffer_tpu_torch", "testing")
EXPECTED_DL = os.path.join(TESTING, "dl_stream_expected.json")
EXPECTED_UL = os.path.join(TESTING, "ul_stream_expected.json")
EXPECTED_INGEST = os.path.join(TESTING, "ingest_expected.json")
CFO_TOL = 1e-5           # |est_cfo port - est_cfo reference|, subcarriers

CFG = dict(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
REF_CELL, CELL = RefCell(**CFG), CellConfig(**CFG)
PACKAGES = (("ref", ref_core, ref_sdr, RefCell, {}),
            ("port", core, sdr, CellConfig, {"device": "cpu"}))


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _rows(c):
    return [(r.dci.rnti, r.dci.sfn, r.dci.sf_idx, r.dci.fmt, r.crc_ok,
             r.tbs, r.payload) for r in c.results]


def _both(tmp, drive, cfg=CFG, **cfg_kw):
    """Run `drive(core, sdr module)` on a core of each package ->
    {name: (core, pcap bytes)}."""
    out = {}
    for name, mod, sdr_mod, cell_cls, extra in PACKAGES:
        path = str(tmp / f"{name}.pcap")
        c = mod.LTESnifferCore(mod.SnifferConfig(
            cell=cell_cls(**cfg), pcap_path=path, **cfg_kw, **extra))
        drive(c, sdr_mod)
        c.close()
        out[name] = (c, open(path, "rb").read())
    return out


def _assert_same(out):
    (p, p_pcap), (r, r_pcap) = out["port"], out["ref"]
    assert _rows(p) == _rows(r)
    assert p_pcap == r_pcap
    assert p.summary() == r.summary()
    assert p.sfn == r.sfn and p._mib_synced == r._mib_synced


# ---------------------------------------------------------------------------
# stream drivers
# ---------------------------------------------------------------------------
def _gap_stream():
    """tests/test_core_e2e.py:test_run_stream_gap_recovery_and_sfn_resync:
    80 subframes with PBCH, 2.5 subframes cut inside subframe 24."""
    sb = ref_scenario.ScenarioBuilder(REF_CELL, seed=11, noise=0.04)
    pdu = ref_mac.build_mac_pdu([ref_mac.MacSubPdu(lcid=3,
                                                   payload=b"tail-traffic")])
    for j in range(80):
        sf = j % 10
        txs = []
        if j >= 2 and sf not in (0, 5):
            txs.append(ref_scenario.DlTx(rnti=0x3c3c, mac_pdu=pdu, n_prb=10,
                                         prb_start=20, harq_pid=j % 8,
                                         ndi=(j // 8) % 2))
        sb.add_subframe(sf, txs, with_pbch_sfn=100 + j // 10
                        if sf == 0 else None)
    stream = sb.stream()
    cut = CELL.sf_len * 24 + 500
    return np.concatenate([stream[:cut],
                           stream[cut + int(CELL.sf_len * 2.5):]])


def test_run_stream_gap_recovery_both_cores(tmp_path):
    out = _both(tmp_path, lambda c, _: c.run_stream(_gap_stream()),
                batch_size=8)
    _assert_same(out)
    c = out["port"][0]
    s = c.summary()
    assert s["resyncs"] == c.tracker.resyncs >= 1
    assert s["sync_losses"] >= 1 and c._mib_synced
    assert s["sf_skipped"] == 0
    oks = [r for r in c.results if r.crc_ok and r.dci.rnti == 0x3c3c]
    assert len(oks) >= 20
    recs = pcap.read_pcap(str(tmp_path / "port.pcap"))
    tail = [r for r in recs if r.get("rnti") == 0x3c3c and r["sfn"] >= 103]
    assert tail and all(103 <= r["sfn"] <= 108 for r in tail)


def _source_stream():
    """tests/test_observability_cli.py:
    test_run_source_chunked_blocks_equals_run_stream's 30 subframes."""
    sb = ref_scenario.ScenarioBuilder(REF_CELL, seed=13)
    pdu = ref_mac.build_mac_pdu([ref_mac.MacSubPdu(lcid=3,
                                                   payload=b"src-test")])
    for j in range(30):
        sf = j % 10
        txs = []
        if j >= 2 and sf not in (0, 5):
            txs.append(ref_scenario.DlTx(rnti=0x4242, mac_pdu=pdu, n_prb=10,
                                         prb_start=12, harq_pid=j % 8,
                                         ndi=(j // 8) % 2))
        sb.add_subframe(sf, txs,
                        with_pbch_sfn=j // 10 if sf == 0 else None)
    return sb.stream()


def test_run_source_chunked_blocks_equals_run_stream(tmp_path):
    """Odd-sized blocks force the tail carry across reads: the records
    equal the one-shot array path's, and the reference's."""
    stream = _source_stream()

    def blocks(c, sdr_mod):
        c.run_source(sdr_mod.ArraySource(stream, CELL.srate,
                                         chunk_limit=CELL.sf_len * 3 + 777),
                     chunk_subframes=8)
    out = _both(tmp_path, blocks, batch_size=8)
    _assert_same(out)
    whole = core.LTESnifferCore(core.SnifferConfig(cell=CELL, batch_size=8,
                                                   device="cpu"))
    whole.run_stream(stream, chunk_subframes=8)
    assert _rows(whole) == _rows(out["port"][0])
    assert sum(1 for r in _rows(whole) if r[0] == 0x4242 and r[4]) >= 5


def test_live_mode_overload_drops_and_counts():
    """Live-mode overload shedding: when processing lags the radio's 1 ms
    cadence beyond the buffer ring, subframes are dropped and counted
    (`LTESniffer_Core.cc:443-451,557-562`)."""
    sb = ref_scenario.ScenarioBuilder(REF_CELL, seed=5)
    for j in range(30):
        sb.add_subframe(j % 10, [])
    stream = sb.stream()
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=CELL, batch_size=4, heartbeat=True, live_mode=True,
        live_buffer_sf=5, device="cpu"))
    c.heartbeat = observability.Heartbeat(out=io.StringIO(), every=10)
    # make per-subframe processing slower than real time
    c.on_subframe = lambda ctx: time.sleep(0.004)
    c.run_stream(stream, chunk_subframes=4)
    s = c.summary()
    assert s["sf_skipped"] == c.sf_skipped > 0
    assert s["subframes"] + s["sf_skipped"] <= 30
    assert c.heartbeat.skipped == s["sf_skipped"]
    # every framed subframe was either kept or dropped
    off = core.LTESnifferCore(core.SnifferConfig(cell=CELL, batch_size=4,
                                                 device="cpu"))
    off.run_stream(stream, chunk_subframes=4)
    assert off.summary()["sf_skipped"] == 0
    assert s["subframes"] + s["sf_skipped"] == off.summary()["subframes"]


def test_max_subframes_and_stop_in_stream():
    """`max_subframes` bounds the framed count; a stop request ends the
    stream loop and still drains what was framed."""
    stream = _source_stream()
    c = core.LTESnifferCore(core.SnifferConfig(cell=CELL, batch_size=4,
                                               device="cpu"))
    c.run_stream(stream, max_subframes=11, chunk_subframes=4)
    assert c.summary()["subframes"] == 11
    s = core.LTESnifferCore(core.SnifferConfig(cell=CELL, batch_size=4,
                                               device="cpu"))
    s.request_stop()
    s.run_stream(stream, chunk_subframes=4)
    assert s.summary()["subframes"] == 0 and s.tracker is not None


def test_run_source_rejects_wrong_cell():
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=CellConfig(**dict(CFG, n_id_cell=56)), device="cpu"))
    with pytest.raises(RuntimeError, match="cell ID mismatch"):
        c.run_stream(_source_stream()[:12 * CELL.sf_len])
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(12 * CELL.sf_len)
             + 1j * rng.standard_normal(12 * CELL.sf_len))
    with pytest.raises(RuntimeError, match="cell search failed"):
        c.run_stream(noise.astype(np.complex64))


def _segments(c):
    """Record (subframes, sf_idx0) of every segment a stream driver hands
    to `run_samples`."""
    segs = []
    inner = c.run_samples
    c.run_samples = lambda x, sf_idx0=0: (
        segs.append((len(x) // c.cell.sf_len, sf_idx0)),
        inner(x, sf_idx0=sf_idx0))[1]
    return segs


def test_chunk_flush_labels_follow_the_reference(tmp_path):
    """A segment flushed because it reached `chunk_subframes` starts the
    next one at the tracker's `sf_idx` read while the generator still
    holds the last yielded subframe: one less than the next subframe's
    index.  Both packages do so (ROADMAP §3 lists the defect); the
    subframes after such a flush decode under labels one too low."""
    stream = _source_stream()
    out = {}
    for name, mod, _, cell_cls, extra in PACKAGES:
        c = mod.LTESnifferCore(mod.SnifferConfig(
            cell=cell_cls(**CFG), batch_size=8, **extra))
        segs = _segments(c)
        c.run_stream(stream, chunk_subframes=8)
        out[name] = (segs, _rows(c), c.summary())
    assert out["port"] == out["ref"]
    segs = out["port"][0]
    assert len(segs) >= 3 and all(n == 8 for n, _ in segs[:-1])
    # the tracker's count stays true; only each later segment's label is
    # one low
    first = segs[0][1]
    for k in range(1, len(segs)):
        done = sum(n for n, _ in segs[:k])
        assert segs[k][1] == (first + done - 1) % 10


def loaded_acquire_window():
    """The first 12 subframes (what `run_source` buffers for its cell
    search) of the DL stream built from the loaded cell as it is."""
    x, _, _ = stream_cell.build_dl_stream(n_sf=13, pdsch_free_sf=())
    return x[:12 * loaded_cell.CELL.sf_len]


def test_loaded_cell_is_not_acquired():
    """The loaded cell's PDSCH fills the PSS symbol: both packages' cell
    search sees a PSS metric near 0.15 (threshold 0.3) and `run_source`
    raises the same error; the committed record holds the reference's."""
    window = loaded_acquire_window()
    cell = loaded_cell.CELL
    got = sync.find_pss(window, cell.n_fft)
    want = ref_sync.find_pss(window, cell.n_fft)
    assert (got.offset, got.n_id_2) == (want.offset, want.n_id_2)
    assert abs(got.peak - want.peak) <= 1e-6 and got.peak < 0.3
    assert sync.find_cell(window, cell.n_fft) is None
    rec = json.load(open(EXPECTED_DL))["loaded_acquire"]
    assert abs(rec["find_pss_peak"] - got.peak) <= 1e-6
    c = core.LTESnifferCore(core.SnifferConfig(cell=cell, device="cpu"))
    with pytest.raises(RuntimeError) as e:
        c.run_source(sdr.ArraySource(window, cell.srate,
                                     chunk_limit=stream_cell.dl_chunk_limit()))
    assert str(e.value) == rec["error"]


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------
def test_file_source_reads_iq(tmp_path):
    path = str(tmp_path / "s.iq")
    data = (np.arange(1000) + 1j * np.arange(1000)).astype(np.complex64)
    iq_mod.write_iq(path, data)
    got = {}
    for name, mod in (("port", sdr), ("ref", ref_sdr)):
        src = mod.FileSource(path, 1.0)
        blocks = []
        while True:
            blk = src.read(333)
            if blk is None:
                break
            blocks.append(blk)
        src.close()
        got[name] = blocks
    assert [len(b) for b in got["port"]] == [333, 333, 333, 1]
    np.testing.assert_array_equal(np.concatenate(got["port"]), data)
    for a, b in zip(got["port"], got["ref"]):
        np.testing.assert_array_equal(a, b)


def test_array_source_chunk_limit():
    data = (np.arange(1000) - 1j * np.arange(1000)).astype(np.complex128)
    for limit in (None, 77):
        port = sdr.ArraySource(data, 2.0, chunk_limit=limit)
        ref = ref_sdr.ArraySource(data, 2.0, chunk_limit=limit)
        while True:
            a, b = port.read(100), ref.read(100)
            if a is None:
                assert b is None
                break
            assert a.dtype == np.complex64
            assert len(a) == (min(100, limit) if limit else 100) or \
                port.pos == len(data)
            np.testing.assert_array_equal(a, b)
        port.close()


def test_soapy_source_gated():
    with pytest.raises(RuntimeError, match="SoapySDR"):
        sdr.SoapySource("driver=uhd", 23.04e6, 2.14e9)


# ---------------------------------------------------------------------------
# ingest options and pipeline depths
# ---------------------------------------------------------------------------
INGEST_CASES = [(q, d) for q in ("i8", "i16", "f32") for d in (1, 2, 3)]
_GOLDEN = {}


def _golden_run(name: str, ingest: str, depth: int, tmp) -> str:
    """sha256 of the golden scenario's pcap from one package's core."""
    key = (name, ingest, depth)
    if key not in _GOLDEN:
        mod = ref_core if name == "ref" else core
        extra = {} if name == "ref" else {"device": "cpu"}
        cell = golden.CELL if name == "ref" else CellConfig(
            n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
        path = str(tmp / f"golden_{name}_{ingest}_{depth}.pcap")
        c = mod.LTESnifferCore(mod.SnifferConfig(
            cell=cell, batch_size=8, pcap_path=path, api_mode=0,
            ingest=ingest, pipeline_depth=depth, **extra))
        c.run_samples(golden._build_stream())
        c.close()
        _GOLDEN[key] = _sha(open(path, "rb").read())
    return _GOLDEN[key]


@pytest.mark.parametrize("ingest,depth", INGEST_CASES)
def test_golden_pcap_under_ingest_and_depth(tmp_path_factory, ingest, depth):
    tmp = tmp_path_factory.mktemp("golden")
    got = _golden_run("port", ingest, depth, tmp)
    assert got == _golden_run("ref", ingest, depth, tmp)
    rec = json.load(open(EXPECTED_INGEST))
    assert got == rec["pcap_sha256"][stream_cell.ingest_key(ingest, depth)]


def test_ingest_int16_false_is_f32(tmp_path):
    """The legacy alias: ingest_int16=False sends float32 whatever
    `ingest` says."""
    seen = []
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1),
        batch_size=8, ingest="i8", ingest_int16=False, device="cpu"))
    orig = c._run_quantized
    c._run_quantized = lambda f, s, q, t, i: (seen.append((q, s)),
                                              orig(f, s, q, t, i))[1]
    c.run_samples(golden._build_stream()[:4 * c.cell.sf_len])
    assert seen == [("f32", None)]


def _cfo_stream():
    """tests/test_sync.py:test_chest_cfo_estimate_and_core_feedback's
    24 subframes with a residual CFO of 0.02 subcarriers, plus a SIB
    every frame."""
    from ltesniffer_tpu.phy import dci as ref_dci, ra as ref_ra
    cell = RefCell(n_id_cell=77, n_prb=25, nof_ports=2)
    rng = np.random.default_rng(7)
    eps = 0.02
    d = ref_dci.Dci(fmt="1A", rnti=0xFFFF, fields=dict(
        flag0_1a=1, riv=ref_ra.start_len_to_riv(0, 4, 25), mcs=2))
    h = ref_encoder.flat_channel(cell, 1, rng, selective=False)
    frames = []
    for j in range(24):
        g = ref_encoder.build_control_subframe(cell, j % 10, 2, [
            ref_encoder.TxDci(dci=d, L=2, ncce=0)] if j % 10 == 5 else [])
        iq = ref_encoder.subframe_iq(cell, ref_encoder.apply_channel(
            g, h, 0.03, rng))[0]
        n0 = j * cell.sf_len
        rot = np.exp(2j * np.pi * eps * (n0 + np.arange(cell.sf_len))
                     / cell.n_fft)
        frames.append((iq * rot).astype(np.complex64))
    return np.concatenate(frames)


@pytest.mark.parametrize("ingest,depth", [("f32", 3), ("f32", 1),
                                          ("i16", 2)])
def test_cfo_feedback_under_ingest(ingest, depth):
    """The core's CFO integrator, fed back on the host ("f32") or on the
    device ("i16"): both cores track the same estimate and decide the
    same DCIs and CFIs."""
    stream = _cfo_stream()
    got = {}
    for name, mod, _, cell_cls, extra in PACKAGES:
        c = mod.LTESnifferCore(mod.SnifferConfig(
            cell=cell_cls(n_id_cell=77, n_prb=25, nof_ports=2), batch_size=4,
            decode_pdsch=False, ingest=ingest, pipeline_depth=depth,
            **extra))
        log = []
        c.on_subframe = lambda ctx, log=log: log.append(
            (ctx["sf"], [(a.rnti, a.fmt, a.ncce) for a in ctx["accepted"]]))
        c.run_samples(stream)
        got[name] = (c.est_cfo, log, c.summary())
    assert abs(got["port"][0] - got["ref"][0]) <= CFO_TOL
    assert abs(got["port"][0] - 0.02) < 0.015
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]


def _fe_iq(rng, n_sf=3):
    cell = RefCell(n_id_cell=123, n_prb=25, nof_ports=2, nof_rx_ant=1)
    out = []
    for sf in range(n_sf):
        g = ref_encoder.build_control_subframe(cell, sf, 2, [])
        h = ref_encoder.flat_channel(cell, 1, rng)
        out.append(ref_encoder.subframe_iq(
            cell, ref_encoder.apply_channel(g, h, noise_std=0.05, rng=rng)))
    return np.stack(out).astype(np.complex64)        # (B, RX, sf_len)


def test_frontend_run_i16_matches():
    """int16 ingest: scale, on-device CFO de-rotation, demod, chest,
    PCFICH — against `jitted_i16` (rtol 1e-4 + 1e-4 of the peak)."""
    import jax.numpy as jnp
    iq = _fe_iq(np.random.default_rng(16))
    q, scale = cplx.to_i16(iq)
    rq, rscale = ref_cplx.to_i16(iq)
    np.testing.assert_array_equal(q, rq)
    assert scale == rscale and scale.dtype == np.float32
    sf = np.array([7, 8, 9], np.int64)
    cfo = np.float32(-0.021)
    cfg = dict(n_id_cell=123, n_prb=25, nof_ports=2, nof_rx_ant=1)
    want = ref_frontend.make_frontend(RefCell(**cfg)).jitted_i16(
        jnp.asarray(rq), sf.astype(np.int32), rscale, cfo)
    got = frontend.make_frontend(CellConfig(**cfg)).run_i16(
        torch.from_numpy(q), torch.from_numpy(sf),
        torch.tensor(scale), float(cfo))
    for k in ("grids", "h", "noise_var", "snr_db", "rsrp", "cfi_corr"):
        close(got[k], want[k])
    np.testing.assert_array_equal(got["cfi"].numpy(), np.asarray(want["cfi"]))


def test_frontend_run_complex_matches():
    """The float32 path's complex64 entry against the reference's `run`."""
    iq = _fe_iq(np.random.default_rng(17))
    sf = np.array([0, 1, 2], np.int64)
    cfg = dict(n_id_cell=123, n_prb=25, nof_ports=2, nof_rx_ant=1)
    want = ref_frontend.make_frontend(RefCell(**cfg))(iq, sf.astype(np.int32))
    got = frontend.make_frontend(CellConfig(**cfg)).run(
        iq, torch.from_numpy(sf), "cpu")
    for k in ("grids", "h", "noise_var", "snr_db", "cfi_corr"):
        close(got[k], want[k])
    np.testing.assert_array_equal(got["cfi"].numpy(), np.asarray(want["cfi"]))


# ---------------------------------------------------------------------------
# dual-carrier source
# ---------------------------------------------------------------------------
def _dual_skew_streams(skew: int):
    """tests/test_ul_mode_e2e.py:test_run_dual_source_with_interstream_skew's
    streams, with the UL content `skew` samples later (earlier when
    negative) than the DL's -> (DL stream, UL stream, rnti, TB bits,
    PUSCH subframe)."""
    from ltesniffer_tpu.phy import dci as ref_dci, ra as ref_ra
    from ltesniffer_tpu.phy import search_space as ref_ss, tables as ref_tab
    from ltesniffer_tpu.phy import grid as ref_grid
    rng = np.random.default_rng(3)
    rnti, ul_mcs, prb_start, n_prb, cfi = 0x2f2f, 6, 5, 10, 2
    nof_cce = ref_grid.control_region(REF_CELL, cfi)["nof_pdcch_regs"] // 9
    qm, i_tbs = ref_tab.ul_mcs_to_qm_itbs(ul_mcs)
    tbs = ref_tab.tbs_lookup(i_tbs, n_prb)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    h_dl = ref_encoder.flat_channel(REF_CELL, 1, rng)
    dl_frames, ul_frames = [], []
    at = 6
    for j in range(16):
        sf = j % 10
        txs = []
        if j == at:
            l, ncce = [c for c in ref_ss.ue_candidates(rnti, sf, nof_cce)
                       if c[0] == 2][0]
            d = ref_dci.Dci(fmt="0", rnti=rnti, fields=dict(
                flag0_1a=0, hopping=0,
                riv=ref_ra.start_len_to_riv(prb_start, n_prb, 50),
                mcs=ul_mcs, ndi=1, tpc=0, dmrs_cs=2, cqi_request=0))
            txs.append(ref_encoder.TxDci(dci=d, L=l, ncce=ncce))
        g = ref_encoder.build_control_subframe(REF_CELL, sf, cfi, txs)
        dl_frames.append(ref_encoder.subframe_iq(
            REF_CELL, ref_encoder.apply_channel(g, h_dl, 0.04, rng))[0])
        if j == at + 4:
            ug = ref_encoder.build_ul_subframe(REF_CELL, sf, [dict(
                rnti=rnti, prb_start=prb_start, n_prb=n_prb, qm=qm,
                tb_bits=tb, dmrs_field=2)])
        else:
            ug = np.zeros((1, 14, REF_CELL.n_sc), np.complex64)
        un = ug + 0.03 / np.sqrt(2) * (rng.standard_normal(ug.shape)
                                       + 1j * rng.standard_normal(ug.shape))
        ul_frames.append(ref_encoder.ul_subframe_iq(
            REF_CELL, un.astype(np.complex64))[0])
    lead = 3000
    noise = lambda k: (0.01 / np.sqrt(2) * (      # noqa: E731
        rng.standard_normal(k) + 1j * rng.standard_normal(k))
        ).astype(np.complex64)
    dl = np.concatenate([noise(lead)] + dl_frames)
    ul = np.concatenate([noise(lead + skew)] + ul_frames)
    return dl, ul, rnti, tb, (at + 4) % 10


def _ul_rows(c):
    return [(r.rnti, r.sfn, r.sf_idx, r.crc_ok, r.tbs, r.payload,
             r.table.value) for r in c.ul_results]


@pytest.mark.parametrize("skew", [500, -300])
def test_run_dual_source_with_interstream_skew(tmp_path, skew):
    dl, ul, rnti, tb, sf_at = _dual_skew_streams(skew)
    out = {}
    for ul_skew in (skew, 0):
        for name, mod, sdr_mod, cell_cls, extra in PACKAGES:
            path = str(tmp_path / f"{name}_{ul_skew}.pcap")
            c = mod.LTESnifferCoreUL(mod.SnifferConfig(
                cell=cell_cls(**CFG), batch_size=4, acquire_sfn=False,
                pcap_path=path, **extra))
            c.run_dual_source(sdr_mod.ArraySource(dl, CELL.srate),
                              sdr_mod.ArraySource(ul, CELL.srate),
                              chunk_subframes=6, ul_skew=ul_skew)
            c.close()
            out[name, ul_skew] = (c, open(path, "rb").read())
        (p, p_pcap), (r, r_pcap) = out["port", ul_skew], out["ref", ul_skew]
        assert _ul_rows(p) == _ul_rows(r)
        assert p_pcap == r_pcap
        assert p.summary() == r.summary()
    c = out["port", skew][0]
    assert len(c.ul_results) == 1
    res = c.ul_results[0]
    assert res.crc_ok and res.rnti == rnti and res.sf_idx == sf_at
    np.testing.assert_array_equal(
        np.unpackbits(np.frombuffer(res.payload, np.uint8))[:len(tb)], tb)
    # negative control: without the skew compensation the slaved UL slice
    # misses the DMRS alignment and the decode fails
    assert not any(x.crc_ok for x in out["port", 0][0].ul_results)


# ---------------------------------------------------------------------------
# the expected records of the card's stream phase
# ---------------------------------------------------------------------------
def test_dl_stream_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED_DL))
    assert rec["params"] == stream_cell.dl_params()
    cfg = rec["config"]
    assert cfg["batch_size"] == stream_cell.BATCH == 32
    assert cfg["acquire_sfn"] is True and cfg["ingest"] == "i8"
    assert cfg["pipeline_depth"] == 3 and cfg["live_mode"] is False
    s = rec["summary"]
    assert s["resyncs"] >= 1 and s["sync_losses"] >= 1
    assert s["sf_skipped"] == 0
    # the stream loses the subframes before the first PSS lock, the 2.5
    # cut ones and the ones framed blind before the re-acquire
    assert stream_cell.N_SF - 16 <= s["subframes"] <= stream_cell.N_SF - 3
    assert len(rec["pdsch_ok"]) == len(rec["pdsch_dci"]) > 0
    assert all(0 <= i < len(rec["dcis"]) for i in rec["pdsch_dci"])
    # SFN labels: the MIB is re-read after the gap, so the accepted DCIs'
    # frames run on past it without a jump back
    ttis = [d[0] for d in rec["dcis"]]
    assert ttis == sorted(ttis) and ttis[-1] // 10 > 40
    assert rec["placed"] > 0 and len(rec["pcap_sha256"]) == 64
    # segments: the first runs to the sync loss, the re-acquired one is
    # flushed at chunk_subframes, the rest follows
    assert sum(n for n, _ in rec["segments"]) == s["subframes"]
    assert len(rec["segments"]) >= 2
    assert rec["loaded_acquire"]["error"].startswith("cell search failed")
    assert os.path.getsize(EXPECTED_DL) < 256 * 1024


def test_ul_stream_expected_record_matches_scenario():
    rec = json.load(open(EXPECTED_UL))
    assert rec["params"] == stream_cell.ul_params()
    cfg = rec["config"]
    assert cfg["batch_size"] == ul_cell.BATCH and cfg["acquire_sfn"] is False
    assert rec["n_results"] == len(rec["results"]) > 0
    assert rec["crc_ok"] == sum(r[3] for r in rec["results"])
    assert rec["summary"]["resyncs"] == 0
    dci0 = {tuple(d) for d in rec["dci0"]}
    assert all((r[0] * 10 + r[1] - 4, r[2]) in dci0 for r in rec["results"])
    assert os.path.getsize(EXPECTED_UL) < 512 * 1024


def test_ingest_expected_record_covers_options():
    rec = json.load(open(EXPECTED_INGEST))
    keys = {stream_cell.ingest_key(q, d) for q, d in INGEST_CASES}
    assert set(rec["pcap_sha256"]) == keys
    assert {stream_cell.ingest_key(q, d)
            for q, d in stream_cell.CHIP_INGEST} <= keys
    # the default options reproduce the committed golden pcap
    assert rec["pcap_sha256"][stream_cell.ingest_key("i8", 3)] == _sha(
        open(golden.GOLDEN_PCAP, "rb").read())


def test_stream_cell_impairments():
    """`impair` on a short stream: lead, CFO mix and cut in that order."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4000) + 1j * rng.standard_normal(4000)
         ).astype(np.complex64)
    got = stream_cell.impair(x, 128, 1000, np.random.default_rng(2),
                             lead=10, cfo=0.25, gap_at=2, gap_sf=1.5)
    lead = stream_cell.noise(10, np.random.default_rng(2))
    whole = np.concatenate([lead, x])
    whole = whole * np.exp(2j * np.pi * 0.25 * np.arange(len(whole)) / 128)
    cut = 2000 + stream_cell.GAP_OFFSET
    want = np.concatenate([whole[:cut], whole[cut + 1500:]])
    np.testing.assert_allclose(got, want.astype(np.complex64), rtol=0,
                               atol=1e-6)
    assert abs(np.std(lead) - stream_cell.NOISE_SIGMA) < 0.01


# ---------------------------------------------------------------------------
# regeneration of the records (the JAX package on the CPU)
# ---------------------------------------------------------------------------
def _cfg_dict(cfg):
    import dataclasses
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in ("batch_size", "turbo_iters", "turbo_iters_max",
                     "acquire_sfn", "pipeline_depth", "ingest", "live_mode")}


def _regen_dl_stream():
    import tempfile
    import jax
    from tests.test_torch_core import record_run
    jax.config.update("jax_platforms", "cpu")
    p = stream_cell.dl_params()
    cell = RefCell(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                   nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
    # the loaded cell as it is: the reference's acquisition fails
    window = loaded_acquire_window()
    try:
        ref_core.LTESnifferCore(ref_core.SnifferConfig(
            cell=cell, batch_size=p["batch_size"])).run_source(
                ref_sdr.ArraySource(window, cell.srate,
                                    chunk_limit=p["chunk_limit"]))
        loaded = {"error": None}
    except RuntimeError as e:
        loaded = {"error": str(e)}
    loaded["find_pss_peak"] = ref_sync.find_pss(
        window[:12 * cell.sf_len], cell.n_fft).peak
    print(f"loaded cell as it is: {loaded}", flush=True)
    t0 = time.time()
    stream, placed, _ = stream_cell.build_dl_stream()
    print(f"stream built in {time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stream.pcap")
        cfg = ref_core.SnifferConfig(cell=cell, batch_size=p["batch_size"],
                                     pcap_path=path)
        c = ref_core.LTESnifferCore(cfg)
        log = []

        def hook(ctx):
            for a in ctx["accepted"]:
                log.append((ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt))
        c.on_subframe = hook
        segments = _segments(c)
        t0 = time.time()
        c.run_source(ref_sdr.ArraySource(stream, cell.srate,
                                         chunk_limit=p["chunk_limit"]),
                     chunk_subframes=p["chunk_subframes"])
        c.close()
        print(f"JAX run_source in {time.time() - t0:.1f} s", flush=True)
        sha = _sha(open(path, "rb").read())
    rec = record_run(c, log, placed, sha, p, _cfg_dict(cfg))
    rec["drift_corrections"] = c.tracker.drift_corrections
    rec["segments"] = segments
    rec["loaded_acquire"] = loaded
    with open(EXPECTED_DL, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_DL} "
          f"({os.path.getsize(EXPECTED_DL)} B); summary {rec['summary']}, "
          f"drift corrections {rec['drift_corrections']}")


def _regen_ul_stream():
    import jax
    jax.config.update("jax_platforms", "cpu")
    p = stream_cell.ul_params()
    t0 = time.time()
    dl, ul, placed, _ = stream_cell.build_ul_streams()
    print(f"streams built in {time.time() - t0:.1f} s", flush=True)
    cell = RefCell(n_id_cell=p["n_id_cell"], n_prb=p["n_prb"],
                   nof_ports=p["nof_ports"], nof_rx_ant=p["nof_rx_ant"])
    cfg = ref_core.SnifferConfig(cell=cell, batch_size=p["batch_size"],
                                 acquire_sfn=False)
    c = ref_core.LTESnifferCoreUL(cfg)
    log = ul_cell.log_dci0(c)
    t0 = time.time()
    c.run_dual_source(ref_sdr.ArraySource(dl, cell.srate),
                      ref_sdr.ArraySource(ul, cell.srate),
                      chunk_subframes=p["chunk_subframes"],
                      ul_skew=p["ul_skew"])
    c.close()
    print(f"JAX run_dual_source in {time.time() - t0:.1f} s", flush=True)
    results = ul_cell.result_rows(c)
    rec = {"params": p, "config": _cfg_dict(cfg), "placed": int(placed),
           "n_results": len(results),
           "crc_ok": sum(r[3] for r in results),
           "summary": {k: v for k, v in c.summary().items()
                       if k != "search_stats"},
           "dci0": log, "results": results}
    with open(EXPECTED_UL, "w") as f:
        json.dump(rec, f, separators=(",", ":"))
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_UL} "
          f"({os.path.getsize(EXPECTED_UL)} B); {len(log)} DCI0s, "
          f"{len(results)} results, {rec['crc_ok']} CRC-ok; "
          f"summary {rec['summary']}")


def _regen_ingest():
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    _, stream, _ = stream_cell.golden_scenario()
    shas = {}
    with tempfile.TemporaryDirectory() as d:
        for ingest, depth in INGEST_CASES:
            path = os.path.join(d, f"{ingest}_{depth}.pcap")
            c = ref_core.LTESnifferCore(ref_core.SnifferConfig(
                cell=golden.CELL, batch_size=8, pcap_path=path, api_mode=0,
                ingest=ingest, pipeline_depth=depth))
            c.run_samples(stream)
            c.close()
            shas[stream_cell.ingest_key(ingest, depth)] = _sha(
                open(path, "rb").read())
    rec = {"scenario": "tests/test_golden_replay.py:_build_stream",
           "config": {"batch_size": 8, "api_mode": 0},
           "pcap_sha256": shas}
    with open(EXPECTED_INGEST, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"expected record regenerated: {EXPECTED_INGEST}: {shas}")


if __name__ == "__main__":
    if "--regen-dl-stream" in sys.argv:
        _regen_dl_stream()
        sys.exit(0)
    if "--regen-ul-stream" in sys.argv:
        _regen_ul_stream()
        sys.exit(0)
    if "--regen-ingest" in sys.argv:
        _regen_ingest()
        sys.exit(0)
    print(__doc__)
    sys.exit(2)
