"""Port parity, TM3/TM4 spatial multiplexing on 2-RX cells: the MIMO
precoders and equalizers (`kernels/mimo.py`), the two-codeword decode
(`pdsch_rx.decode_grant_mimo`) and the core's two-codeword handler,
against the JAX package; mirrors tests/test_mimo.py and
tests/test_four_port.py.

Tolerance: float32 outputs of `kernels/mimo.py` (effective channels,
equalized symbols) agree within rtol 1e-5 plus atol 1e-5 of the tensor's
peak — the two packages sum einsums and reductions in different orders.
The decode's LLRs agree within rtol 1e-4 plus atol 5e-4 of the peak: the
2x2 MMSE solve divides by det(H^H H + noise I), which amplifies those
rounding differences on ill-conditioned REs (largest seen: 9.7e-5 of the
peak).  Decoded bits, CRC flags, layer/PMI decisions and pcap bytes are
equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.kernels import mimo as ref_mimo
from ltesniffer_tpu.phy import dci as ref_dci, tables
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import core as ref_core
from ltesniffer_tpu.sniffer import frontend as ref_frontend
from ltesniffer_tpu.sniffer import pdsch_rx as ref_pdsch
from ltesniffer_tpu.testing import encoder as ref_encoder

from ltesniffer_tpu_torch.kernels import mimo
from ltesniffer_tpu_torch.phy import dci as dci_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, pdsch_rx, trackers
from ltesniffer_tpu_torch.testing import encoder, mimo_cell

torch.set_num_threads(1)

CFI = 2


def close(got, want, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * peak)


def _chan(rng, ports, B=2, RX=2, M=24):
    h = rng.normal(size=(B, RX, ports, M, 2)).astype(np.float32)
    y = rng.normal(size=(B, RX, M, 2)).astype(np.float32)
    nv = np.abs(rng.normal(size=(B,))).astype(np.float32) * 0.1
    return h, y, nv


# ---------------------------------------------------------------------------
# kernels/mimo.py
# ---------------------------------------------------------------------------
def test_codebooks_and_pinfo_equal():
    for p in range(4):
        np.testing.assert_array_equal(mimo.pmi_matrix_1layer(p),
                                      ref_mimo.pmi_matrix_1layer(p))
    for p in range(3):
        np.testing.assert_array_equal(mimo.pmi_matrix_2layer(p),
                                      ref_mimo.pmi_matrix_2layer(p))
    for p in range(16):
        np.testing.assert_array_equal(mimo.pmi_matrix_2layer_4tx(p),
                                      ref_mimo.pmi_matrix_2layer_4tx(p))
    for two_tb in (True, False):
        for pinfo in range(8):
            assert (mimo.decode_pinfo_2tx(pinfo, two_tb)
                    == ref_mimo.decode_pinfo_2tx(pinfo, two_tb))
        # the reference's classification, pinfo 16 and 33 included
        for pinfo in range(64):
            assert (mimo.decode_pinfo_4tx(pinfo, two_tb)
                    == ref_mimo.decode_pinfo_4tx(pinfo, two_tb))
    assert mimo.decode_pinfo_4tx(16, True) == (3, 0)
    assert mimo.decode_pinfo_4tx(33, True) == (4, 0)


@pytest.mark.parametrize("ports,pmi,layers", [(2, 0, 2), (2, 1, 2), (2, 2, 2),
                                              (2, 3, 1), (4, 0, 2), (4, 9, 2),
                                              (4, 15, 2)])
def test_effective_channel_tm4_matches(ports, pmi, layers):
    h, _, _ = _chan(np.random.default_rng(ports * 17 + pmi), ports)
    want = ref_mimo.effective_channel_tm4(jnp.asarray(h), pmi, layers)
    got = mimo.effective_channel_tm4(torch.from_numpy(h), pmi, layers)
    close(got, want)


@pytest.mark.parametrize("ports", [2, 4])
def test_effective_channel_tm3_matches(ports):
    h, _, _ = _chan(np.random.default_rng(ports), ports, M=30)
    close(mimo.effective_channel_tm3(torch.from_numpy(h)),
          ref_mimo.effective_channel_tm3(jnp.asarray(h)))


@pytest.mark.parametrize("ports", [2, 4])
def test_mmse_matches(ports):
    h, y, nv = _chan(np.random.default_rng(50 + ports), ports)
    he = ref_mimo.effective_channel_tm3(jnp.asarray(h))
    close(mimo.mmse_2layer(torch.from_numpy(y),
                           torch.from_numpy(np.array(he)),
                           torch.from_numpy(nv)),
          ref_mimo.mmse_2layer(jnp.asarray(y), he, jnp.asarray(nv)))
    he1 = np.array(he)[:, :, :1]
    close(mimo.mmse_1layer(torch.from_numpy(y), torch.from_numpy(he1),
                           torch.from_numpy(nv)),
          ref_mimo.mmse_1layer(jnp.asarray(y), jnp.asarray(he1),
                               jnp.asarray(nv)))


# ---------------------------------------------------------------------------
# decode_grant_mimo on the same grids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ports,tm,pmi,qms,i_tbss", [
    (2, 4, 0, (2, 2), (8, 8)),
    (2, 4, 1, (2, 2), (8, 8)),
    (2, 4, 2, (4, 4), (12, 14)),
    (2, 3, 0, (2, 4), (6, 10)),
    (4, 4, 3, (2, 2), (8, 8)),
    (4, 4, 9, (2, 2), (8, 8)),
    (4, 3, 0, (2, 2), (8, 8)),
])
def test_decode_grant_mimo_matches(ports, tm, pmi, qms, i_tbss):
    cfg = dict(n_id_cell=93, n_prb=50, nof_ports=ports, nof_rx_ant=2)
    ref_cell, cell = RefCell(**cfg), CellConfig(**cfg)
    rng = np.random.default_rng(100 * ports + 10 * tm + pmi)
    mask = np.zeros(50, bool)
    mask[5:25] = True
    tbss = [tables.tbs_lookup(i, 20) for i in i_tbss]
    sent = [rng.integers(0, 2, t).astype(np.uint8) for t in tbss]
    g = ref_encoder.build_control_subframe(ref_cell, 2, CFI, [])
    ref_encoder.add_pdsch_mimo(g, ref_cell, 2, CFI, 0x5151, mask, qms, sent,
                               tm=tm, pmi=pmi)
    h = ref_encoder.flat_channel(ref_cell, 2, rng)
    iq = ref_encoder.subframe_iq(ref_cell,
                                 ref_encoder.apply_channel(g, h, 0.02, rng))
    out = ref_frontend.make_frontend(ref_cell)(
        jnp.asarray(iq[None].astype(np.complex64)),
        jnp.asarray([2], np.int32))
    ref = (out["grids"], out["h"], out["noise_var"])
    port = tuple(torch.from_numpy(np.array(x)) for x in ref)
    kw = dict(rnti=0x5151, prb_mask=mask, qms=qms, tbss=tuple(tbss), tm=tm,
              pmi=pmi)
    want = ref_pdsch.decode_grant_mimo(*ref, 0, ref_cell, 2, CFI, **kw)
    got = pdsch_rx.decode_grant_mimo(*port, 0, cell, 2, CFI, **kw)
    for q in (0, 1):
        assert got[q].crc_ok and want[q].crc_ok
        assert got[q].cb_crc_ok == want[q].cb_crc_ok
        np.testing.assert_array_equal(got[q].tb_bits, want[q].tb_bits)
        np.testing.assert_array_equal(got[q].tb_bits, sent[q])
        assert len(got[q].d_llrs) == len(want[q].d_llrs)
        for a, b in zip(got[q].d_llrs, want[q].d_llrs):
            close(a, b, rtol=1e-4, atol=5e-4)


def test_decode_grant_mimo_wrong_pmi_fails():
    """Equalizing with another codebook entry than the one sent breaks
    at least one codeword in both packages alike."""
    cfg = dict(n_id_cell=93, n_prb=50, nof_ports=2, nof_rx_ant=2)
    ref_cell, cell = RefCell(**cfg), CellConfig(**cfg)
    rng = np.random.default_rng(3)
    mask = np.zeros(50, bool)
    mask[5:25] = True
    tbss = [tables.tbs_lookup(8, 20)] * 2
    sent = [rng.integers(0, 2, t).astype(np.uint8) for t in tbss]
    g = encoder.build_control_subframe(cell, 2, CFI, [])
    encoder.add_pdsch_mimo(g, cell, 2, CFI, 0x5151, mask, (2, 2), sent,
                           tm=4, pmi=1)
    h = encoder.flat_channel(cell, 2, rng)
    iq = encoder.subframe_iq(cell, encoder.apply_channel(g, h, 0.02, rng))
    out = ref_frontend.make_frontend(ref_cell)(
        jnp.asarray(iq[None].astype(np.complex64)),
        jnp.asarray([2], np.int32))
    ref = (out["grids"], out["h"], out["noise_var"])
    port = tuple(torch.from_numpy(np.array(x)) for x in ref)
    kw = dict(rnti=0x5151, prb_mask=mask, qms=(2, 2), tbss=tuple(tbss),
              tm=4, pmi=2)
    want = ref_pdsch.decode_grant_mimo(*ref, 0, ref_cell, 2, CFI, **kw)
    got = pdsch_rx.decode_grant_mimo(*port, 0, cell, 2, CFI, **kw)
    assert [r.crc_ok for r in got] == [r.crc_ok for r in want]
    assert not (got[0].crc_ok and got[1].crc_ok)


def test_port_encoder_matches_reference():
    """`testing/encoder.add_pdsch_mimo` is the reference's, copied: the
    same grid for TM3 and TM4 on 2 and 4 ports."""
    rng = np.random.default_rng(5)
    for ports, tm, pmi in ((2, 3, 0), (2, 4, 2), (4, 3, 0), (4, 4, 7)):
        cfg = dict(n_id_cell=93, n_prb=25, nof_ports=ports, nof_rx_ant=2)
        mask = np.zeros(25, bool)
        mask[4:16] = True
        tbss = [tables.tbs_lookup(6, 12), tables.tbs_lookup(9, 12)]
        sent = [rng.integers(0, 2, t).astype(np.uint8) for t in tbss]
        grids = []
        for enc, cc in ((ref_encoder, RefCell), (encoder, CellConfig)):
            g = enc.build_control_subframe(cc(**cfg), 3, CFI, [])
            enc.add_pdsch_mimo(g, cc(**cfg), 3, CFI, 0x7070, mask, (2, 4),
                               sent, tm=tm, pmi=pmi)
            grids.append(g)
        np.testing.assert_array_equal(grids[0], grids[1])


# ---------------------------------------------------------------------------
# the core's two-codeword handler
# ---------------------------------------------------------------------------
def _core_pair(cell_cfg, **kw):
    return (ref_core.LTESnifferCore(ref_core.SnifferConfig(
                cell=RefCell(**cell_cfg), **kw)),
            core.LTESnifferCore(core.SnifferConfig(
                cell=CellConfig(**cell_cfg), device="cpu", **kw)))


def test_core_2tb_dual_table_trial_learns_256qam():
    """A TM3 (format 2A) UE on the 256QAM table, table initially UNKNOWN:
    both cores run the 64 -> 256 dual-table trial on the two-codeword
    grant and LEARN the table (tests/test_mimo.py:76), with equal
    results."""
    from ltesniffer_tpu.phy import grid as grid_mod, search_space
    cfg = dict(n_id_cell=93, n_prb=50, nof_ports=2, nof_rx_ant=2)
    ref_cell = RefCell(**cfg)
    rng = np.random.default_rng(7)
    rnti = 0x5252
    mcs = 7                          # 64-table: QPSK; 256-table: 16QAM
    qm256, itbs256 = tables.dl_mcs_to_qm_itbs(mcs, True)
    bitmap = 0
    for r in (2, 3, 4, 5, 6, 7):     # 50 PRB -> RBG size 3: PRBs 6..23
        bitmap |= 1 << (17 - 1 - r)
    prb_mask = np.zeros(50, bool)
    prb_mask[6:24] = True
    tbs = tables.tbs_lookup(itbs256, 18)
    ncce_tot = grid_mod.control_region(ref_cell, CFI)["nof_pdcch_regs"] // 9
    frames, sfs, sent = [], [], []
    for j in range(6):
        sf = j % 10
        d = ref_dci.Dci(fmt="2A", rnti=rnti, fields=dict(
            ra_header=0, bitmap=bitmap, tpc=0, harq_pid=j % 8,
            tb_swap=0, mcs=mcs, ndi=0, rv=0, mcs2=mcs, ndi2=0, rv2=0))
        l, ncce = search_space.ue_candidates(rnti, sf, ncce_tot)[0]
        g = ref_encoder.build_control_subframe(
            ref_cell, sf, CFI, [ref_encoder.TxDci(dci=d, L=l, ncce=ncce)])
        tb_bits = [rng.integers(0, 2, tbs).astype(np.uint8)
                   for _ in range(2)]
        ref_encoder.add_pdsch_mimo(g, ref_cell, sf, CFI, rnti, prb_mask,
                                   (qm256, qm256), tb_bits, tm=3, pmi=0)
        h = ref_encoder.flat_channel(ref_cell, 2, rng)
        frames.append(ref_encoder.subframe_iq(
            ref_cell, ref_encoder.apply_channel(g, h, 0.01, rng)))
        sfs.append(sf)
        sent.append(tb_bits)
    ref, port = _core_pair(cfg, batch_size=8, histogram_threshold=2,
                           acquire_sfn=False)
    for c in (ref, port):
        c.process_batch(np.stack(frames), np.array(sfs, np.int32))
    assert port.mcs.dl_table_of(rnti) == trackers.McsTable.QAM256
    assert ref.mcs.dl_table_of(rnti).name == "QAM256"
    oks = [r for r in port.results if r.crc_ok]
    assert len(oks) >= 2
    assert all(r.table == trackers.McsTable.QAM256 for r in oks)
    decoded = {r.payload for r in oks}
    assert any(np.packbits(tb).tobytes() in decoded
               for pair in sent for tb in pair)
    key = lambda r: (r.dci.rnti, r.dci.sf_idx, r.crc_ok, r.tbs, r.payload,
                     r.is_retx, r.table.name)
    assert [key(r) for r in port.results] == [key(r) for r in ref.results]


def test_4port_rank3_counts_wrong_mimo():
    """A 4-port format-2 DCI signalling rank 3 is counted as unsupported
    MIMO config (W_MIMO) in both cores, not half-decoded
    (tests/test_four_port.py:132)."""
    cfg = dict(n_id_cell=93, n_prb=50, nof_ports=4, nof_rx_ant=2)
    rnti = 0x7A7A
    mask = np.zeros(50, bool)
    mask[:9] = True
    for c, dmod in zip(_core_pair(cfg), (ref_dci, dci_mod)):
        grant = dmod.DlGrant(
            rnti=rnti, fmt="2", prb_mask=mask, prb_mask_slot1=mask.copy(),
            mcs=5, mcs2=5, rv=0, rv2=0, ndi=0, ndi2=0, harq_pid=0, nof_tb=2,
            precoding=20)             # 17..32: 3 layers
        a = type("A", (), dict(rnti=rnti, fmt="2", payload=None, l=2,
                               ncce=0, histval=9, sf_idx=0, sfn=0))()
        a._grant = grant
        before = c.mcs.stat_dl(rnti).wrong_mimo
        c._handle_dl_dci(None, 0, 2, a, 0, 0)
        assert c.mcs.stats_dl[rnti].wrong_mimo == before + 1
        assert c.results == []


# ---------------------------------------------------------------------------
# 2-RX cells through both cores (run_packed): byte-equal pcaps
# ---------------------------------------------------------------------------
def _run_both(frames, tmp_path, **kw):
    """Both cores over the same packed int8 IQ -> {name: (pcap bytes,
    summary, core)}."""
    from ltesniffer_tpu_torch.kernels import cplx
    words, scales = cplx.to_i8_packed(frames)
    cell_cfg = dict(n_id_cell=mimo_cell.CELL.n_id_cell,
                    n_prb=mimo_cell.CELL.n_prb,
                    nof_ports=mimo_cell.CELL.nof_ports,
                    nof_rx_ant=mimo_cell.CELL.nof_rx_ant)
    out = {}
    for name, mod, cell_cls, extra in (
            ("ref", ref_core, RefCell, {}),
            ("port", core, CellConfig, {"device": "cpu"})):
        path = str(tmp_path / f"{name}.pcap")
        c = mod.LTESnifferCore(mod.SnifferConfig(
            cell=cell_cls(**cell_cfg), batch_size=4, pcap_path=path,
            **extra, **kw))
        c.run_packed(words, scales)
        c.close()
        out[name] = (open(path, "rb").read(), c.summary(), c)
    return out


@pytest.mark.parametrize("kind", ["siso", "mimo"])
def test_2rx_cell_pcaps_equal(kind, tmp_path):
    """A 2-RX cell (mimo_cell's builder; `siso`: format-1A grants only,
    `mimo`: with its TM3 and TM4 two-codeword grants), 6 subframes at
    100 PRB: both cores write byte-equal pcaps and equal summaries, and
    every CRC-ok payload is one the generator sent."""
    n = dict(siso=dict(n_tm3=0, n_tm4=0, n_siso=8),
             mimo=dict(n_tm3=4, n_tm4=4, n_siso=4))[kind]
    frames, truth = mimo_cell.build_frames(n_sf=6, **n)
    out = _run_both(frames, tmp_path, histogram_threshold=2)
    (pr, sr, ref), (pp, sp, port) = out["ref"], out["port"]
    assert sp == sr
    assert pp == pr
    sent = {(t["sf"], t["rnti"], t["payload"]) for t in truth}
    oks = [r for r in port.results if r.crc_ok]
    assert len(oks) >= 0.5 * len(truth)
    assert all((r.dci.sfn * 10 + r.dci.sf_idx, r.dci.rnti, r.payload)
               in sent for r in oks)
    fmts = {r.dci.fmt for r in oks}
    assert fmts == ({"1A"} if kind == "siso" else {"1A", "2", "2A"})
