"""The port's cell search and subframe tracker, against the JAX package.

`ltesniffer_tpu_torch/sniffer/sync.py` is host numpy, as the reference's
is; on the same seeded streams:

* `find_cell` gives the same cell id, subframe half and subframe offset,
  with `cfo` and `peak` within 1e-6;
* `correct_cfo` and the PSS replicas are equal;
* `SubframeTracker.frames` yields the same (sf_idx, samples) sequence on a
  drift stream and on a gap stream (whole, in blocks with the tail carried
  as `run_source` carries it, and with a slaved aux stream), with equal
  drift corrections, resyncs, end offset, and CFO within 1e-6;

and the 8 tests of tests/test_sync.py, mirrored on the port (streams from
the port's own generator).
"""
import numpy as np
import pytest
import torch

from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import sync as ref_sync
from ltesniffer_tpu.testing import encoder as ref_encoder

from ltesniffer_tpu_torch.kernels import ofdm
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import sync
from ltesniffer_tpu_torch.testing import encoder

torch.set_num_threads(1)

TOL = 1e-6     # cfo (subcarriers) and normalized peak


def _stream(enc, cell, sf_range, rng, noise=0.05, lead=777):
    """tests/test_sync.py:_stream through a package's encoder:
    concatenated subframes with `lead` junk samples in front."""
    chunks = [0.01 * (rng.standard_normal(lead)
                      + 1j * rng.standard_normal(lead))]
    h = enc.flat_channel(cell, 1, rng, selective=False)
    for sf in sf_range:
        g = enc.build_control_subframe(cell, sf % 10, 1, [])
        rxg = enc.apply_channel(g, h, noise, rng)
        chunks.append(enc.subframe_iq(cell, rxg)[0])
    return np.concatenate(chunks).astype(np.complex64)


def _ref_stream(cfg, sf_range, seed, **kw):
    return _stream(ref_encoder, RefCell(**cfg), sf_range,
                   np.random.default_rng(seed), **kw)


def _mix(x, eps, n_fft):
    n = np.arange(len(x))
    return (x * np.exp(2j * np.pi * eps * n / n_fft)).astype(np.complex64)


C123 = dict(n_id_cell=123, n_prb=25, nof_ports=2)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def test_pss_replicas_equal():
    for n_fft in (128, 512, 1024, 2048):
        np.testing.assert_array_equal(sync.pss_time_replicas(n_fft),
                                      ref_sync.pss_time_replicas(n_fft))
    np.testing.assert_array_equal(ofdm.symbol_starts(2048),
                                  ref_sync.ofdm.symbol_starts(2048))


def _cases():
    """(stream, n_fft) pairs: sf0 and sf5 starts, a CFO, noise only."""
    out = []
    s = _ref_stream(C123, range(0, 4), 0)
    out.append((s, 512))
    out.append((_ref_stream(dict(C123, n_id_cell=45), range(5, 9), 1), 512))
    out.append((_mix(_ref_stream(dict(C123, n_id_cell=9), range(0, 3), 2,
                                 noise=0.02), 0.21, 512), 512))
    out.append((_mix(_ref_stream(dict(n_id_cell=301, n_prb=50, nof_ports=2),
                                 range(3, 6), 3, lead=5000), -0.07, 1024),
                1024))
    rng = np.random.default_rng(3)
    out.append(((rng.standard_normal(40000)
                 + 1j * rng.standard_normal(40000)).astype(np.complex64),
                512))
    return out


@pytest.mark.parametrize("case", range(5))
def test_find_cell_equal(case):
    x, n_fft = _cases()[case]
    x = x[:2 * 15360 * n_fft // 1024]
    got, want = sync.find_cell(x, n_fft), ref_sync.find_cell(x, n_fft)
    if want is None:
        assert got is None
        return
    assert (got.n_id_cell, got.is_subframe5, got.subframe_offset) == \
        (want.n_id_cell, want.is_subframe5, want.subframe_offset)
    assert abs(got.cfo - want.cfo) <= TOL
    assert abs(got.peak - want.peak) <= TOL


def test_correct_cfo_equal():
    x = _ref_stream(C123, range(0, 2), 5)
    for eps in (0.013, -0.4):
        np.testing.assert_array_equal(sync.correct_cfo(x, eps, 512),
                                      ref_sync.correct_cfo(x, eps, 512))


def _drift_stream():
    """tests/test_sync.py:test_tracker_corrects_timing_drift's stream, with
    a residual CFO (the running mixer is on)."""
    s = _ref_stream(C123, range(0, 30), 7, lead=0)
    cut = RefCell(**C123).sf_len * 12 + 1000
    return _mix(np.concatenate([s[:cut], s[cut + 9:]]), 0.03, 512)


def _gap_stream():
    """tests/test_sync.py:test_tracker_reacquires_after_gap's stream."""
    s = _ref_stream(C123, range(0, 60), 8, lead=0)
    sf_len = RefCell(**C123).sf_len
    cut = sf_len * 14 + 321
    return np.concatenate([s[:cut], s[cut + int(sf_len * 2.5):]])


def _track(mod, cell_cls, x, block=None, aux=None):
    """Frame a stream with a package's tracker, whole or in blocks (the
    unconsumed tail carried into the next block as `run_source` does) ->
    (yielded tuples, tracker)."""
    tr = mod.SubframeTracker(cell_cls(**C123), 0, 0, cfo=0.01)
    if block is None:
        return list(tr.frames(x, aux=aux) if aux is not None
                    else tr.frames(x)), tr
    out, carry, pos = [], x[:block], block
    while True:
        out += list(tr.frames(carry))
        start = len(carry) + tr.offset
        tail = carry[start:] if 0 <= start <= len(carry) else carry[:0]
        if pos >= len(x):
            break
        carry = np.concatenate([tail, x[pos:pos + block]])
        pos += block
        tr.offset = 0
    return out, tr


@pytest.mark.parametrize("stream", ["drift", "gap"])
@pytest.mark.parametrize("block", [None, 3 * 7680 + 777])
def test_tracker_frames_equal(stream, block):
    x = _drift_stream() if stream == "drift" else _gap_stream()
    got, tr = _track(sync, CellConfig, x, block)
    want, rtr = _track(ref_sync, RefCell, x, block)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (tr.drift_corrections, tr.resyncs, tr.offset, tr.sf_idx,
            tr.consecutive_losses) == \
        (rtr.drift_corrections, rtr.resyncs, rtr.offset, rtr.sf_idx,
         rtr.consecutive_losses)
    assert abs(tr.cfo - rtr.cfo) <= TOL
    if stream == "gap":
        assert tr.resyncs >= 1
    else:
        assert tr.drift_corrections >= 1


def test_tracker_aux_slices_equal():
    """The slaved aux stream (UL carrier) is cut at the DL's positions,
    zero-filled past its end, in both packages."""
    x = _gap_stream()
    aux = np.arange(len(x) - 5000).astype(np.complex64)
    got, _ = _track(sync, CellConfig, x, aux=aux)
    want, _ = _track(ref_sync, RefCell, x, aux=aux)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert not got[-1][2].any()


# ---------------------------------------------------------------------------
# tests/test_sync.py on the port
# ---------------------------------------------------------------------------
def _port_stream(cfg, sf_range, seed, **kw):
    return _stream(encoder, CellConfig(**cfg), sf_range,
                   np.random.default_rng(seed), **kw)


def test_find_cell_from_stream():
    cell = CellConfig(**C123)
    stream = _port_stream(C123, range(0, 10), 0)
    res = sync.find_cell(stream[:cell.sf_len * 2], cell.n_fft)
    assert res is not None
    assert res.n_id_cell == 123
    assert not res.is_subframe5
    assert abs(res.subframe_offset - 777) <= 2
    assert abs(res.cfo) < 0.05


def test_find_cell_sf5_phase():
    cfg = dict(C123, n_id_cell=45)
    stream = _port_stream(cfg, range(5, 15), 1)   # starts at subframe 5
    res = sync.find_cell(stream[:CellConfig(**cfg).sf_len * 2], 512)
    assert res is not None and res.n_id_cell == 45
    assert res.is_subframe5


def test_cfo_estimation_and_correction():
    cfg = dict(C123, n_id_cell=9)
    cell = CellConfig(**cfg)
    stream = _port_stream(cfg, range(0, 3), 2, noise=0.02)
    eps = 0.21   # fractional CFO in subcarrier units
    shifted = _mix(stream, eps, cell.n_fft)
    res = sync.find_cell(shifted[:cell.sf_len * 2], cell.n_fft)
    assert res is not None
    assert abs(res.cfo - eps) < 0.03
    fixed = sync.correct_cfo(shifted, res.cfo, cell.n_fft)
    res2 = sync.find_cell(fixed[:cell.sf_len * 2], cell.n_fft)
    assert abs(res2.cfo) < 0.03


def test_no_cell_in_noise():
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal(40000) + 1j * rng.standard_normal(40000)
             ).astype(np.complex64)
    assert sync.find_cell(noise, 512) is None


def test_subframe_tracker_frames():
    cell = CellConfig(**C123)
    stream = _port_stream(C123, range(0, 6), 4)
    res = sync.find_cell(stream[:cell.sf_len * 2], cell.n_fft)
    tr = sync.SubframeTracker(cell, res.subframe_offset,
                              5 if res.is_subframe5 else 0, res.cfo)
    frames = list(tr.frames(stream))
    assert len(frames) == 6
    assert [s for s, _ in frames] == [0, 1, 2, 3, 4, 5]
    assert all(len(x) == cell.sf_len for _, x in frames)


def test_chest_cfo_estimate_and_core_feedback():
    """Fine CFO visible to chest; the core's feedback loop corrects it."""
    from ltesniffer_tpu_torch.phy import dci as dci_mod, ra
    from ltesniffer_tpu_torch.sniffer import core, frontend
    cell = CellConfig(n_id_cell=77, n_prb=25, nof_ports=2)
    rng = np.random.default_rng(7)
    eps = 0.02   # small residual CFO in subcarrier units
    d = dci_mod.Dci(fmt="1A", rnti=0xFFFF, fields=dict(
        flag0_1a=1, riv=ra.start_len_to_riv(0, 4, 25), mcs=2))
    h = encoder.flat_channel(cell, 1, rng, selective=False)
    frames = []
    for j in range(24):
        g = encoder.build_control_subframe(cell, j % 10, 2, [
            encoder.TxDci(dci=d, L=2, ncce=0)] if j % 10 == 5 else [])
        iq = encoder.subframe_iq(cell, encoder.apply_channel(g, h, 0.03,
                                                             rng))[0]
        n0 = j * cell.sf_len
        rot = np.exp(2j * np.pi * eps * (n0 + np.arange(cell.sf_len))
                     / cell.n_fft)
        frames.append((iq * rot).astype(np.complex64))
    stream = np.concatenate(frames)

    # chest-level estimate on the first subframe
    out = frontend.make_frontend(cell).run(
        stream[:cell.sf_len][None, None, :], torch.tensor([0]), "cpu")
    assert abs(float(out["cfo"][0]) - eps) < 0.01

    # core-level: feedback loop keeps SNR/decoding healthy across batches
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=cell, batch_size=8, decode_pdsch=False, device="cpu"))
    c.run_samples(stream)
    assert abs(c.est_cfo - eps) < 0.015


def _pss_metric(cell, f):
    off = ofdm.symbol_starts(cell.n_fft)[6]
    rep = sync.pss_time_replicas(cell.n_fft)[cell.n_id_cell % 3]
    seg = f[off:off + cell.n_fft]
    return abs(np.vdot(rep, seg)) / (np.linalg.norm(seg) + 1e-12)


def test_tracker_corrects_timing_drift():
    """Samples dropped mid-stream (integer drift): the PSS re-correlation
    at the next sf0/5 re-aligns framing within the tracking window."""
    cell = CellConfig(**C123)
    stream = _port_stream(C123, range(0, 30), 7, lead=0)
    # drop 9 samples inside subframe 12 (not PSS-bearing)
    cut = cell.sf_len * 12 + 1000
    stream = np.concatenate([stream[:cut], stream[cut + 9:]])
    tr = sync.SubframeTracker(cell, 0, 0)
    frames = list(tr.frames(stream))
    assert tr.drift_corrections >= 1
    assert tr.resyncs == 0
    # the last PSS-bearing frame must be cleanly aligned
    _, f = [x for x in frames if x[0] in (0, 5)][-1]
    assert _pss_metric(cell, f) > 0.8


def test_tracker_reacquires_after_gap():
    """A gap far larger than the tracking window forces 5 PSS misses and a
    full re-acquisition (reference 5-loss -> DECODE_MIB analog)."""
    cell = CellConfig(**C123)
    stream = _port_stream(C123, range(0, 60), 8, lead=0)
    cut = cell.sf_len * 14 + 321
    gap = int(cell.sf_len * 2.5)
    stream = np.concatenate([stream[:cut], stream[cut + gap:]])
    tr = sync.SubframeTracker(cell, 0, 0)
    frames = list(tr.frames(stream))
    assert tr.resyncs >= 1
    # after re-acquisition the sf_idx labels follow the transmitted pattern
    _, f = [x for x in frames if x[0] in (0, 5)][-1]
    assert _pss_metric(cell, f) > 0.8
