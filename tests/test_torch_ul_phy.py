"""Port parity, uplink PHY helpers: the DMRS, UCI and PRACH-root modules
of `ltesniffer_tpu_torch` are copies of the JAX package's numpy modules,
and `sniffer/prach_rx.py` is the host PRACH detector; this file holds
their arrays and detections equal to the reference's and mirrors the
PRACH tests of `tests/test_prach_obs.py` and the UCI / DMRS tests of
`tests/test_pusch_e2e.py` on the port.

Everything here is numpy on the host in both packages, so the
comparisons are exact (equal arrays, equal detections, equal floats).
"""
import dataclasses

import numpy as np
import pytest

from ltesniffer_tpu.phy import prach_roots as ref_roots
from ltesniffer_tpu.phy import uci as ref_uci, ul_dmrs as ref_dmrs
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import prach_rx as ref_prach

from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.phy import prach_root_gen, prach_roots as pr
from ltesniffer_tpu_torch.phy import uci, ul_dmrs
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, prach_rx

CFG = dict(n_id_cell=21, n_prb=50, nof_ports=2)
REF_CELL, CELL = RefCell(**CFG), CellConfig(**CFG)


# ---------------------------------------------------------------------------
# equal to the reference
# ---------------------------------------------------------------------------
def test_ul_dmrs_equals_reference():
    for n_prb in (1, 2, 3, 4, 8, 10, 12, 25, 50):
        for ns in (0, 5, 19):
            for cs_cfg, field in ((0, 0), (2, 3), (7, 7)):
                for n_id in (0, 147, 301):
                    np.testing.assert_array_equal(
                        ul_dmrs.pusch_dmrs(n_prb, ns, n_id, cs_cfg, field),
                        ref_dmrs.pusch_dmrs(n_prb, ns, n_id, cs_cfg, field))
    for n_id in (0, 147, 503):
        for hop in (False, True):
            assert [ul_dmrs.group_number(ns, n_id, 0, hop) for ns in range(20)] \
                == [ref_dmrs.group_number(ns, n_id, 0, hop) for ns in range(20)]
        np.testing.assert_array_equal(ul_dmrs._n_pn_table(n_id, 0),
                                      ref_dmrs._n_pn_table(n_id, 0))


def test_uci_equals_reference():
    for attr in ("BETA_ACK", "BETA_RI", "BETA_CQI"):
        assert tuple(getattr(uci, attr)) == tuple(getattr(ref_uci, attr))
    for args in ((1, 1, 10, 12, 10, 256), (2, 0, 0, 0, 4, 392),
                 (0, 1, 0, 5, 4, 392), (20, 0, 14, 0, 10, 16),
                 (1, 0, 0, 0, 100, 75376), (1, 1, 9, 9, 8, 808)):
        for cur in (None, 1, 8, 25):
            kw = {} if cur is None else dict(n_prb_current=cur)
            assert uci.uci_symbol_counts(*args, **kw) \
                == ref_uci.uci_symbol_counts(*args, **kw)
    for n_prb in (6, 7, 15, 25, 27, 50, 63, 64, 75, 100, 110):
        for wb in (False, True):
            assert uci.aperiodic_cqi_bits(n_prb, wideband_only=wb) \
                == ref_uci.aperiodic_cqi_bits(n_prb, wideband_only=wb)
    for args in ((12, 2, 4, 392), (22, 15, 10, 256), (100, 15, 20, 16)):
        for n_ri in (0, 5):
            assert uci.cqi_q_prime(*args, n_ri_syms=n_ri) \
                == ref_uci.cqi_q_prime(*args, n_ri_syms=n_ri)
    for m_sc, qm, n_ri, n_ack in ((96, 2, 0, 0), (120, 2, 8, 12),
                                  (240, 4, 16, 30), (96, 6, 40, 40)):
        for a, b in zip(uci.uci_positions(m_sc, qm, n_ri, n_ack),
                        ref_uci.uci_positions(m_sc, qm, n_ri, n_ack)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(uci.data_group_map(m_sc, n_ri),
                                      ref_uci.data_group_map(m_sc, n_ri))


def test_prach_roots_equal_reference():
    """The port's table is the reference's, the class-B root-order defect
    included (ADVICE.md: logical 456-837 emitted in reversed group order;
    the golden outputs were written with it, so the port carries it)."""
    assert pr._TABLE == ref_roots._TABLE
    assert pr.NCS_UNRESTRICTED == ref_roots.NCS_UNRESTRICTED
    # the defect as ADVICE.md states it: the published table has 230 at
    # logical 456; the embedded one has 324 there and 230 at 512
    assert pr._TABLE[456] == 324 and pr._TABLE[512] == 230
    for root, zcz in ((0, 1), (92, 1), (0, 12), (455, 12), (836, 12),
                      (500, 15)):
        assert pr.cell_roots(root, zcz) == ref_roots.cell_roots(root, zcz)


def test_prach_table_regenerates_from_design_rule():
    assert prach_root_gen.generate_table() == pr._TABLE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prach_detect_equals_reference(seed):
    """Equal detections (root, preamble, shift, peak, TA) on seeded
    windows: one to three preambles plus noise, several roots."""
    rng = np.random.default_rng(seed)
    n = int(round(CELL.srate * prach_rx.T_SEQ))
    sig = np.zeros(n, np.complex64)
    roots = [129, 710, 400]
    for _ in range(seed + 1):
        u = roots[int(rng.integers(0, 3))]
        shift = 13 * int(rng.integers(0, 64))
        tx = prach_rx.prach_tx(CELL, u, shift)
        cp = len(tx) - n
        sig += float(rng.uniform(0.5, 2.0)) * tx[cp:]
    sig += (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)
    got = prach_rx.detect(sig, CELL, roots=roots, n_cs=13)
    want = ref_prach.detect(sig, REF_CELL, roots=roots, n_cs=13)
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    assert len(got) >= 1
    np.testing.assert_array_equal(prach_rx.prach_tx(CELL, 129, 26),
                                  ref_prach.prach_tx(REF_CELL, 129, 26))


# ---------------------------------------------------------------------------
# test_prach_obs.py's PRACH tests, on the port
# ---------------------------------------------------------------------------
def test_prach_detect_single_preamble():
    rng = np.random.default_rng(0)
    u, shift, n_cs = 129, 3 * 13, 13
    tx = prach_rx.prach_tx(CELL, u, shift)
    cp = len(tx) - int(round(CELL.srate * prach_rx.T_SEQ))
    sig = tx[cp:]
    noisy = sig + 0.05 * (rng.standard_normal(len(sig))
                          + 1j * rng.standard_normal(len(sig)))
    dets = prach_rx.detect(noisy.astype(np.complex64), CELL, roots=[u, 400],
                           n_cs=n_cs)
    assert any(d.root == u and d.preamble == 3 for d in dets)
    assert not any(d.root == 400 and d.peak > 50 for d in dets)


def test_prach_no_false_alarm_on_noise():
    rng = np.random.default_rng(1)
    n = int(round(CELL.srate * prach_rx.T_SEQ))
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
    dets = prach_rx.detect(noise, CELL, roots=[129], n_cs=13, threshold=8.0)
    assert len(dets) <= 2


def test_prach_timing_advance():
    u, n_cs = 129, 13
    tx = prach_rx.prach_tx(CELL, u, 0)
    cp = len(tx) - int(round(CELL.srate * prach_rx.T_SEQ))
    delay = 40
    sig = np.concatenate([np.zeros(delay, np.complex64), tx[cp:]])
    hit = [d for d in prach_rx.detect(sig, CELL, roots=[u], n_cs=n_cs)
           if d.preamble == 0]
    assert hit and abs(hit[0].ta_samples - delay) < 20


def test_prach_logical_root_mapping():
    assert pr.logical_to_physical(0) == 129
    assert pr.logical_to_physical(1) == 710
    assert pr.logical_to_physical(22) == 1
    assert pr.logical_to_physical(23) == 838
    assert pr.logical_to_physical(92) == 128
    assert pr.logical_to_physical(93) == 711
    for i in range(0, pr.MAX_KNOWN_LOGICAL, 2):
        assert (pr.logical_to_physical(i)
                + pr.logical_to_physical(i + 1)) == 839
    roots, n_cs, mapped = pr.cell_roots(92, 1)
    assert mapped and n_cs == 13 and roots == [128]
    roots, n_cs, mapped = pr.cell_roots(0, 12)
    assert mapped and n_cs == 119 and len(roots) == 10
    assert roots[:4] == [129, 710, 140, 699]
    assert pr.MAX_KNOWN_LOGICAL == 837
    assert sorted(pr._TABLE) == list(range(1, 839))
    assert pr.logical_to_physical(172) == 16
    assert pr.logical_to_physical(173) == 823
    assert pr.logical_to_physical(262) == 6
    assert pr.logical_to_physical(264) == 5
    roots, n_cs, mapped = pr.cell_roots(836, 12)
    assert mapped and len(roots) == 10 and roots[0] == pr._TABLE[836]
    assert roots[2] == pr._TABLE[0]


@pytest.mark.parametrize("logical,preamble", [(60, 5), (400, 7)])
def test_prach_e2e_logical_root_detection(logical, preamble):
    """`_work_prach` of the port's UL core, on a packed UL subframe, finds
    a preamble sent on the PHYSICAL root of a LOGICAL SIB2 index
    (test_prach_obs.py's two e2e tests)."""
    rng = np.random.default_rng(7 if logical == 60 else 9)
    u = pr.logical_to_physical(logical)
    assert u != logical
    c = core.LTESnifferCoreUL(core.SnifferConfig(cell=CELL, device="cpu"))
    c.ulsche.set_sib2(dict(prach_root_seq_index=logical,
                           prach_config_index=14,   # every subframe
                           prach_freq_offset=4, zero_correlation_zone=1))
    tx = prach_rx.prach_tx(CELL, u, preamble * 13)
    frame = np.zeros(CELL.sf_len, np.complex64)
    frame[:len(tx)] = tx
    frame += 0.02 * (rng.standard_normal(CELL.sf_len)
                     + 1j * rng.standard_normal(CELL.sf_len))
    packed = cplx.to_i8_packed(frame.reshape(1, 1, -1).astype(np.complex64))
    c._work_prach(packed, 0, sfn=2, sf=1)
    hits = [d for d in c.prach_detections if d["preamble"] == preamble]
    assert hits and hits[0]["root"] == u and hits[0]["logical_mapped"]
    # an odd SFN under an even-SFN-only configuration detects nothing
    c.ulsche.set_sib2(dict(c.ulsche.sib2, prach_config_index=0))
    n = len(c.prach_detections)
    c._work_prach(packed, 0, sfn=3, sf=1)
    assert len(c.prach_detections) == n


def test_unpack_i8_inverts_packing():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 1, 256)) + 1j
         * rng.standard_normal((2, 1, 256))).astype(np.complex64)
    words, scales = cplx.to_i8_packed(x)
    # each of re, im rounds to the nearest step: |error| <= step / sqrt(2)
    for b in range(2):
        np.testing.assert_allclose(cplx.unpack_i8(words[b], scales[b]),
                                   x[b], rtol=0, atol=scales[b] * 0.7072)


# ---------------------------------------------------------------------------
# test_pusch_e2e.py's UCI / DMRS tests, on the port
# ---------------------------------------------------------------------------
def test_dmrs_properties():
    a = ul_dmrs.pusch_dmrs(10, 0, 147, 0, 0)
    b = ul_dmrs.pusch_dmrs(10, 0, 147, 0, 3)
    c = ul_dmrs.pusch_dmrs(10, 1, 147, 0, 0)
    np.testing.assert_allclose(np.abs(a), 1.0, atol=1e-5)
    assert np.abs(np.vdot(a, b)) / len(a) < 0.5
    assert not np.allclose(a, c)


def test_uci_beta_offset_tables():
    assert uci.BETA_ACK[0] == 2.000 and uci.BETA_ACK[10] == 20.000
    assert uci.BETA_ACK[14] == 126.000
    assert uci.BETA_RI[0] == 1.250 and uci.BETA_RI[12] == 20.000
    assert uci.BETA_CQI[2] == 1.125 and uci.BETA_CQI[15] == 6.250
    n_ri0, n_ack0 = uci.uci_symbol_counts(1, 0, 0, 0, 10, 2216)
    n_ri1, n_ack1 = uci.uci_symbol_counts(2, 0, 10, 0, 10, 2216)
    assert n_ri0 == 0 and 0 < n_ack0 < n_ack1
    _, n_cap = uci.uci_symbol_counts(20, 0, 14, 0, 1, 16)
    assert n_cap <= 4 * 12


def test_cqi_sizing_helpers():
    assert uci.cqi_hl_subband_size(7) == 4
    assert uci.cqi_hl_subband_size(26) == 4
    assert uci.cqi_hl_subband_size(27) == 6
    assert uci.cqi_hl_subband_size(63) == 6
    assert uci.cqi_hl_subband_size(64) == 8
    assert uci.cqi_hl_subband_size(110) == 8
    assert uci.cqi_hl_subband_count(50) == 9
    assert uci.cqi_hl_subband_count(100) == 13
    assert uci.aperiodic_cqi_bits(50) == 4 + 2 * 9
    assert uci.aperiodic_cqi_bits(50, wideband_only=True) == 4


def test_q_prime_exact_spec_vectors():
    assert uci.uci_symbol_counts(2, 0, 0, 0, 4, 392) == (0, 6)
    n_ri, _ = uci.uci_symbol_counts(0, 1, 0, 5, 4, 392)
    assert n_ri == 6
    _, n_ack = uci.uci_symbol_counts(20, 0, 14, 0, 10, 16, n_prb_current=1)
    assert n_ack == 48
    _, n_ack_wide = uci.uci_symbol_counts(20, 0, 14, 0, 10, 16,
                                          n_prb_current=25)
    assert n_ack_wide > 48
    _, n_ack_small = uci.uci_symbol_counts(1, 0, 0, 0, 100, 75376)
    assert n_ack_small == 1
    assert uci.cqi_q_prime(12, 2, 4, 392) == 32
    assert uci.cqi_q_prime(100, 15, 20, 16, n_ri_syms=5,
                           n_prb_current=1) == 12 * 12 - 5
