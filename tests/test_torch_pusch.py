"""Port parity, PUSCH: the SC-FDMA frontend, the batched equalizer, the
UCI window of the derm+turbo finisher, the single-grant decode and the
power map of `ltesniffer_tpu_torch` against the JAX package, mirroring
`tests/test_pusch_e2e.py`.

Inputs are made with numpy from seeds (the JAX package's test-side
transmitter).  Tolerances: grids, LLRs and the power map agree within
rtol 1e-4 plus atol 1e-4 of the tensor's peak (the two packages sum the
DFT matmuls and reductions in different orders); `snr_db` within 1e-3 dB
and `ta_us` within 1e-4 us (both come from `log10` / `arctan2` of sums
over the grant, so their float order differs).  Integer results — fused
[crc | packed bits] rows, decoded bits, CRC flags — are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.kernels import cplx as ref_cplx
from ltesniffer_tpu.phy import pdsch as ref_pdsch_mod, tables
from ltesniffer_tpu.phy import turbo as ref_turbo_mod, uci as ref_uci
from ltesniffer_tpu.phy import ul_dmrs as ref_dmrs
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdsch_rx as ref_pdsch
from ltesniffer_tpu.sniffer import pusch_rx as ref_pusch
from ltesniffer_tpu.testing import encoder

from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.phy import uci
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx, pusch_rx

torch.set_num_threads(1)

CFG = dict(n_id_cell=147, n_prb=50, nof_ports=2, nof_rx_ant=1)
REF_CELL, CELL = RefCell(**CFG), CellConfig(**CFG)
SNR_TOL_DB = 1e-3
TA_TOL_US = 1e-4


def close(got, want, rtol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * peak)


def _iq(grants, sf_idx, rng, noise=0.03, cs_cfg=0):
    """One UL subframe's IQ (1, sf_len): `test_pusch_e2e._tx_rx`'s
    transmitter and flat channel."""
    g = encoder.build_ul_subframe(REF_CELL, sf_idx, grants,
                                  cyclic_shift_cfg=cs_cfg)
    h = encoder.flat_channel(REF_CELL, 1, rng)[:, :1]
    rx = np.einsum("rpls,pls->rls", h, g)
    rx = rx + noise / np.sqrt(2) * (rng.standard_normal(rx.shape)
                                    + 1j * rng.standard_normal(rx.shape))
    return encoder.ul_subframe_iq(REF_CELL, rx.astype(np.complex64))


def _grids(iqs):
    """(JAX UL grids, port UL grids) of a (B, RX, sf_len) IQ stack."""
    x = np.stack(iqs).astype(np.complex64)
    ref = np.asarray(ref_pusch.make_ul_frontend(REF_CELL)(jnp.asarray(x)))
    port = pusch_rx.make_ul_frontend(CELL).run_ri(
        torch.from_numpy(cplx.to_ri(x)))
    return ref, port


def _grant(rnti, prb_start, n_prb, qm, i_tbs, rng, **kw):
    tbs = tables.tbs_lookup(i_tbs, n_prb)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    return dict(rnti=rnti, prb_start=prb_start, n_prb=n_prb, qm=qm,
                tb_bits=tb, tbs=tbs, **kw)


def test_ul_frontend_grids():
    rng = np.random.default_rng(0)
    iqs = [_iq([_grant(0x7101, 4, 10, 2, 6, rng)], sf, rng) for sf in (2, 3)]
    ref, port = _grids(iqs)
    assert port.shape == (2, 1, 14, CELL.n_sc, 2)
    close(port, ref)


def test_ul_frontend_i8c64_grids():
    """The packed-int8 ingest (int64 carrier) gives the JAX package's
    grids from the same packed words."""
    rng = np.random.default_rng(1)
    iqs = np.stack([_iq([_grant(0x7102, 0, 8, 2, 5, rng)], sf, rng)
                    for sf in (0, 1, 2)])
    words, scales = cplx.to_i8_packed(iqs)
    w64 = cplx.view_i64(words)
    import jax
    with jax.enable_x64(True):
        ref = np.asarray(ref_pusch.make_ul_frontend(REF_CELL).jitted_i8c64(
            jax.device_put(w64), jax.device_put(scales)))
    port = pusch_rx.make_ul_frontend(CELL).run_i8c64(
        torch.from_numpy(w64), torch.from_numpy(scales))
    close(port, ref)


def _eq_rows(rng):
    """Three grants over two subframes, two (n_prb, qm) groups."""
    spec = [(0, 2, _grant(0x7201, 4, 10, 2, 6, rng, dmrs_field=2)),
            (0, 2, _grant(0x7202, 20, 12, 4, 10, rng, dmrs_field=3)),
            (1, 7, _grant(0x7203, 30, 10, 2, 6, rng))]
    iqs = []
    for b, sf in ((0, 2), (1, 7)):
        iqs.append(_iq([g for bb, _, g in spec if bb == b], sf, rng))
    return spec, _grids(iqs)


def test_eq_batch_ul_fn_matches():
    """LLRs, snr_db and ta_us of `_eq_batch_ul_fn` per (n_prb, qm) group."""
    rng = np.random.default_rng(2)
    spec, (ref_g, port_g) = _eq_rows(rng)
    groups = {}
    for b, sf, g in spec:
        groups.setdefault((g["n_prb"], g["qm"]), []).append((b, sf, g))
    for (n_prb, qm), rows in groups.items():
        bidx = np.array([b for b, _, _ in rows])
        k0 = np.array([12 * g["prb_start"] for _, _, g in rows])
        cinit = np.array([ref_pdsch_mod.scrambling_cinit(
            g["rnti"], 0, sf, CELL.n_id_cell) for _, sf, g in rows])
        dmrs = np.stack([np.stack([ref_dmrs.pusch_dmrs(
            n_prb, 2 * sf + s, CELL.n_id_cell, 0, g.get("dmrs_field", 0))
            for s in range(2)]) for _, sf, g in rows])
        ref = ref_pusch._eq_batch_ul_fn(REF_CELL, n_prb, qm, len(rows))(
            jnp.asarray(ref_g), jnp.asarray(bidx.astype(np.int32)),
            jnp.asarray(k0.astype(np.int32)),
            jnp.asarray(ref_cplx.to_ri(dmrs)),
            jnp.asarray(cinit.astype(np.uint32)))
        port = pusch_rx._eq_batch_ul_fn(CELL, n_prb, qm)(
            port_g, torch.from_numpy(bidx), torch.from_numpy(k0),
            torch.from_numpy(cplx.to_ri(dmrs)),
            torch.from_numpy(cinit.astype(np.int64)))
        close(port[0], ref[0])
        np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=SNR_TOL_DB)
        np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]),
                                   rtol=0, atol=TA_TOL_US)
        assert (port[1].numpy() > 15).all()


def _rows_mat(rng, m_sc, qm, n_rows=6):
    """Seeded LLR rows: a noisy coded stream in each row (values around
    +-2, so decodes are non-trivial), as a (n, 12*m_sc*qm) matrix."""
    W = 12 * m_sc * qm
    x = 1.0 - 2.0 * rng.integers(0, 2, (n_rows, W))
    return (2.0 * x + rng.normal(size=(n_rows, W))).astype(np.float32)


@pytest.mark.parametrize("window", [
    "lin",
    "uci_ri_ack",           # RI removed, ACK punctured
    "uci_ri_ack_cqi",       # + CQI heading the stream
    "uci_two_cbs"])         # two code blocks: the second window's off0 > 0
def test_derm_turbo_static_fn_windows(window):
    """`_derm_turbo_static_fn` with the linear and the UCI windows: the
    fused [CB CRC remainder | packed bits] rows are equal to the JAX
    function's and the combined LLRs agree."""
    rng = np.random.default_rng(3)
    n_prb, qm = (10, 2) if window != "uci_two_cbs" else (20, 4)
    m_sc = 12 * n_prb
    tbs = tables.tbs_lookup(6 if window != "uci_two_cbs" else 21, n_prb)
    n_ri = n_ack = n_cqi = 0
    if window != "lin":
        n_ri, n_ack = ref_uci.uci_symbol_counts(1, 1, 10, 12, n_prb, tbs)
    if window in ("uci_ri_ack_cqi", "uci_two_cbs"):
        n_cqi = ref_uci.cqi_q_prime(ref_uci.aperiodic_cqi_bits(50), 15,
                                    n_prb, tbs, n_ri_syms=n_ri)
    rows = _rows_mat(rng, m_sc, qm)
    n_re = 12 * m_sc - n_ri - n_cqi
    seg = ref_turbo_mod.segment_sizes(tbs)
    assert (seg.C > 1) == (window == "uci_two_cbs")
    es = ref_pdsch_mod.cb_rate_match_sizes(n_re * qm, seg.C, qm)
    off = 0
    n_b = rows.shape[0]
    Wm = 1 << 14
    rows_ref = np.zeros((n_b, Wm), np.float32)
    rows_ref[:, :rows.shape[1]] = rows
    for ci, (K, E) in enumerate(zip(seg.K, es)):
        F = seg.F if ci == 0 else 0
        laps = ref_pdsch._derm_laps(K, F, E)
        key = (("lin",) if window == "lin"
               else ("uci", m_sc, qm, n_ri, n_ack, n_cqi, off))
        idx = np.arange(n_b)
        e_true = np.full(n_b, E)
        fused_r, d_r = ref_pdsch._derm_turbo_static_fn(
            Wm, K, F, laps, 0, n_b, False, 2, key)(
            jnp.asarray(rows_ref), jnp.asarray(idx.astype(np.int32)),
            jnp.asarray(e_true.astype(np.int32)), np.int32(off))
        fused_p, d_p = pdsch_rx._derm_turbo_static_fn(K, F, laps, 0, 2, key)(
            torch.from_numpy(rows), torch.from_numpy(idx),
            torch.from_numpy(e_true), off)
        np.testing.assert_array_equal(fused_p.numpy().astype(np.uint32),
                                      np.asarray(fused_r))
        close(d_p, d_r)
        off += E


def test_uci_src_map_equals_reference():
    """The UCI index map itself, rebuilt as the JAX function builds it."""
    m_sc, qm = 120, 2
    n_ri, n_ack, n_cqi = 8, 12, 40
    for EB, off0 in ((2000, 0), (2000, 1500), (5000, 100)):
        SRC, OK = pdsch_rx._uci_src_map(
            EB, ("uci", m_sc, qm, n_ri, n_ack, n_cqi, off0))
        _, ack_cells = ref_uci.uci_positions(m_sc, qm, n_ri, n_ack)
        data = ref_uci.data_group_map(m_sc, n_ri)
        src = (data[:, None] * qm + np.arange(qm)).astype(np.int64)
        ack = np.zeros(12 * m_sc, bool)
        ack[ack_cells] = True
        src[ack[data]] = -1
        rel = src[n_cqi:].reshape(-1)
        want = np.full(EB, -1, np.int64)
        n_av = max(0, min(EB, len(rel) - off0))
        want[:n_av] = rel[off0:off0 + n_av]
        np.testing.assert_array_equal(OK, want >= 0)
        np.testing.assert_array_equal(SRC, np.where(want >= 0, want, 0))
        assert SRC.max() < 12 * m_sc * qm


# ---------------------------------------------------------------------------
# decode_grant_ul: test_pusch_e2e.py's round trips, both packages
# ---------------------------------------------------------------------------
def _decode_both(grid_ref, grid_port, *args, **kw):
    r = ref_pusch.decode_grant_ul(grid_ref, REF_CELL, *args, **kw)
    p = pusch_rx.decode_grant_ul(grid_port, CELL, *args, **kw)
    assert p.crc_ok == r.crc_ok and p.tbs == r.tbs and p.n_prb == r.n_prb
    if r.crc_ok:
        np.testing.assert_array_equal(p.tb_bits, r.tb_bits)
    assert abs(p.snr_db - r.snr_db) <= SNR_TOL_DB
    assert abs(p.ta_us - r.ta_us) <= TA_TOL_US
    return p


def _one(grants, sf, rng, **kw):
    ref, port = _grids([_iq(grants, sf, rng, **kw)])
    return ref[0], port[0]


def test_decode_grant_ul_qpsk():
    rng = np.random.default_rng(0)
    gr = _grant(0x7101, 4, 10, 2, 6, rng)
    p = _decode_both(*_one([gr], 2, rng), 2, gr["rnti"], 4, 10, 2,
                     gr["tbs"])
    assert p.crc_ok and p.snr_db > 15 and abs(p.ta_us) < 1.0
    np.testing.assert_array_equal(p.tb_bits, gr["tb_bits"])


@pytest.mark.parametrize("qm,i_tbs", [(4, 12), (6, 20)])
def test_decode_grant_ul_16qam_64qam(qm, i_tbs):
    rng = np.random.default_rng(qm)
    gr = _grant(0x7202, 10, 20, qm, i_tbs, rng)
    p = _decode_both(*_one([gr], 4, rng, noise=0.02), 4, gr["rnti"], 10,
                     20, qm, gr["tbs"])
    assert p.crc_ok
    np.testing.assert_array_equal(p.tb_bits, gr["tb_bits"])


def test_decode_grant_ul_two_ues():
    rng = np.random.default_rng(2)
    g1 = _grant(0x7303, 0, 8, 2, 5, rng)
    g2 = _grant(0x7404, 20, 12, 4, 10, rng, dmrs_field=3)
    ref, port = _one([g1, g2], 7, rng)
    r1 = _decode_both(ref, port, 7, g1["rnti"], 0, 8, 2, g1["tbs"])
    r2 = _decode_both(ref, port, 7, g2["rnti"], 20, 12, 4, g2["tbs"],
                      dmrs_field=3)
    assert r1.crc_ok and r2.crc_ok
    np.testing.assert_array_equal(r2.tb_bits, g2["tb_bits"])


def test_decode_grant_ul_invalid_prb_count():
    grid = torch.zeros((1, 14, CELL.n_sc, 2))
    res = pusch_rx.decode_grant_ul(grid, CELL, 0, 1, 0, 7, 2, 100)
    assert not res.crc_ok and res.snr_db < -90


def test_decode_grant_ul_wrong_dmrs_shift():
    rng = np.random.default_rng(4)
    gr = _grant(0x7505, 4, 10, 2, 6, rng, dmrs_field=0)
    p = _decode_both(*_one([gr], 2, rng), 2, gr["rnti"], 4, 10, 2,
                     gr["tbs"], dmrs_field=5)
    assert not p.crc_ok


def test_decode_grant_ul_ri_and_ack():
    rng = np.random.default_rng(9)
    n_ri, n_ack = 8, 12
    gr = _grant(0x7606, 4, 10, 2, 6, rng, n_ri_syms=n_ri, n_ack_syms=n_ack)
    p = _decode_both(*_one([gr], 3, rng), 3, gr["rnti"], 4, 10, 2,
                     gr["tbs"], n_ri_syms=n_ri, n_ack_syms=n_ack)
    assert p.crc_ok
    np.testing.assert_array_equal(p.tb_bits, gr["tb_bits"])


def test_decode_grant_ul_cqi():
    """CQI + RI + ACK: the data decodes; the CQI-blind decode fails in
    both packages."""
    rng = np.random.default_rng(17)
    n_prb, qm = 10, 2
    tbs = tables.tbs_lookup(6, n_prb)
    n_ri, n_ack = uci.uci_symbol_counts(1, 1, 10, 12, n_prb, tbs)
    n_cqi = uci.cqi_q_prime(uci.aperiodic_cqi_bits(CELL.n_prb), 15, n_prb,
                            tbs, n_ri_syms=n_ri)
    gr = _grant(0x7301, 4, n_prb, qm, 6, rng, n_ri_syms=n_ri,
                n_ack_syms=n_ack, n_cqi_syms=n_cqi)
    ref, port = _one([gr], 2, rng)
    p = _decode_both(ref, port, 2, gr["rnti"], 4, n_prb, qm, tbs,
                     n_ri_syms=n_ri, n_ack_syms=n_ack, n_cqi_syms=n_cqi)
    assert p.crc_ok
    np.testing.assert_array_equal(p.tb_bits, gr["tb_bits"])
    blind = _decode_both(ref, port, 2, gr["rnti"], 4, n_prb, qm, tbs,
                         n_ri_syms=n_ri, n_ack_syms=n_ack)
    assert not blind.crc_ok


# ---------------------------------------------------------------------------
# the batched dispatch / finish path
# ---------------------------------------------------------------------------
def _jobs(mod, spec, **uci_kw):
    return [mod.UlGrantJob(b=b, sf_idx=sf, rnti=g["rnti"],
                           prb_start=g["prb_start"], n_prb=g["n_prb"],
                           qm=g["qm"], tbs=g["tbs"],
                           dmrs_field=g.get("dmrs_field", 0),
                           n_ri_syms=g.get("n_ri_syms", 0),
                           n_ack_syms=g.get("n_ack_syms", 0),
                           n_cqi_syms=g.get("n_cqi_syms", 0))
            for b, sf, g in spec]


def test_batched_ul_results_match():
    """dispatch + finish over grants of two groups, one with UCI, plus a
    degenerate (invalid PRB count) job: equal CRC flags and bits, the
    scalars within tolerance, one host read for the batch."""
    rng = np.random.default_rng(5)
    n_ri, n_ack = 8, 12
    spec = [(0, 2, _grant(0x7201, 4, 10, 2, 6, rng, dmrs_field=2)),
            (0, 2, _grant(0x7202, 20, 12, 4, 10, rng, dmrs_field=3)),
            (1, 7, _grant(0x7203, 30, 10, 2, 6, rng, n_ri_syms=n_ri,
                          n_ack_syms=n_ack))]
    iqs = [_iq([g for bb, _, g in spec if bb == b], sf, rng)
           for b, sf in ((0, 2), (1, 7))]
    ref_g, port_g = _grids(iqs)
    bad = dict(rnti=0x7204, prb_start=0, n_prb=7, qm=2, tbs=100)
    spec.append((1, 7, bad))
    res_r = ref_pusch.finish_grants_ul_batch(ref_pusch.dispatch_grants_ul_batch(
        jnp.asarray(ref_g), REF_CELL, _jobs(ref_pusch, spec), n_iter=2))
    n0 = pusch_rx.HOST_READS["pusch"]
    res_p = pusch_rx.finish_grants_ul_batch(pusch_rx.dispatch_grants_ul_batch(
        port_g, CELL, _jobs(pusch_rx, spec), n_iter=2))
    assert pusch_rx.HOST_READS["pusch"] == n0 + 1
    assert [r.crc_ok for r in res_p] == [r.crc_ok for r in res_r] \
        == [True, True, True, False]
    for p, r, (_, _, g) in zip(res_p, res_r, spec):
        assert abs(p.snr_db - r.snr_db) <= SNR_TOL_DB
        assert abs(p.ta_us - r.ta_us) <= TA_TOL_US
        if r.crc_ok:
            np.testing.assert_array_equal(p.tb_bits, r.tb_bits)
            np.testing.assert_array_equal(p.tb_bits, g["tb_bits"])


def test_batched_ul_escalation_matches():
    """A noisy grant that fails at n_iter 1: both packages escalate it
    from the stored LLRs at n_iter 12 and agree on the outcome."""
    rng = np.random.default_rng(8)
    spec = [(0, 3, _grant(0x7301 + k, 2 + 12 * k, 10, 2, 9, rng))
            for k in range(3)]
    ref_g, port_g = _grids([_iq([g for _, _, g in spec], 3, rng,
                                noise=0.55)])
    out = []
    for mod, grids, cell, esc in (
            (ref_pusch, jnp.asarray(ref_g), REF_CELL, 12),
            (pusch_rx, port_g, CELL, 12), (pusch_rx, port_g, CELL, 0)):
        jobs = _jobs(mod, spec)
        for gi, j in enumerate(jobs):
            j.tag = dict(gi=gi)
        pb = mod.dispatch_grants_ul_batch(grids, cell, jobs, n_iter=1)
        out.append([r.crc_ok for r in
                    mod.finish_grants_ul_batch(pb, n_iter_esc=esc)])
    assert out[0] == out[1]
    # the escalation decided: every grant fails at n_iter 1, some pass
    # at 12, some do not
    assert not any(out[2]) and any(out[1]) and not all(out[1])


def test_power_map_matches():
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((2, 1, 14, CELL.n_sc))
         + 1j * rng.standard_normal((2, 1, 14, CELL.n_sc))).astype(np.complex64)
    g[0, :, :, :12] *= 10.0   # hot PRB 0 in subframe 0
    ri = cplx.to_ri(g)
    want = np.asarray(ref_pusch.make_power_map(REF_CELL)(jnp.asarray(ri)))
    got = pusch_rx.make_power_map(CELL)(torch.from_numpy(ri))
    assert got.shape == (2, CELL.n_prb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert got[0, 0] > got[0, 1] + 15
