"""The port's DL transport-block bookkeeping, route by route.

A DL grant takes one of three routes through `LTESnifferCore`: the
batched single-TB route (`_run_handlers` builds a job, phases 4-5 retry
and record it), the synchronous single-TB route (`_handle_dl_dci`: FDD
RA-RNTI grants, the one enabled TB of formats 2/2A, grants with no TBS)
and the two-codeword route (formats 2/2A with both TBs on a 2-RX cell).
Each test drives DCIs down one route with `pdsch_rx`'s decode entry
points replaced by a stand-in whose CRC passes iff it is asked at the
(Q_m, TBS) the eNB sent, and holds what the route leaves behind: the
`AcceptedPdsch` entries, the per-RNTI DL stats, the HARQ database, the
learnt MCS tables, `harq_skipped`, the pcap records and the decodes
asked for.  The last tests pin the differences between the routes that
the golden pcaps were made with, one assertion each.

The short RLC AM PDUs at the end (`mac.parse_rlc_am_data`) are the ones
whose length indicators run past the PDU.
"""
import types

import numpy as np
import pytest

from ltesniffer_tpu_torch.mac_rrc import mac, rrc
from ltesniffer_tpu_torch.phy import dci as dci_mod, tables
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import core, dci_search, pdsch_rx, trackers

CELL = CellConfig(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
CELL_2RX = CellConfig(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=2)
Q64, Q256 = trackers.McsTable.QAM64, trackers.McsTable.QAM256
UNKNOWN = trackers.McsTable.UNKNOWN
FE = dict(grids=None, h=None, noise_var=None)


def _qm_tbs(mcs, n_prb, table):
    qm, i_tbs = tables.dl_mcs_to_qm_itbs(mcs, table == Q256)
    return qm, tables.tbs_lookup(i_tbs, n_prb)


class _Pcap:
    def __init__(self):
        self.records = []

    def write_pdu(self, payload, rnti, direction, sfn, sf_idx, crc_ok,
                  retx):
        self.records.append((rnti, sfn, sf_idx, crc_ok, retx, payload))

    def close(self):
        pass


class _Air:
    """What the eNB sent, and `pdsch_rx`'s decode entry points over it.

    `send(rnti, q, qm, tbs, payload)` puts a codeword on the air; a decode
    of (rnti, q) passes its CRC iff it asks for that (qm, tbs).  Every
    decode asked for is logged in `calls`."""

    def __init__(self):
        self.sent = {}
        self.calls = []

    def send(self, rnti, q, qm, tbs, payload):
        self.sent[(rnti, q)] = (qm, tbs, payload)

    def result(self, rnti, q, qm, tbs):
        s = self.sent.get((rnti, q))
        ok = s is not None and s[:2] == (qm, tbs)
        return pdsch_rx.PdschResult(rnti, tbs, ok, None, [], [], 0,
                                    payload=s[2] if ok else None)

    def dispatch_grants_batch(self, grids, h, noise_var, cell, jobs,
                              soft_buffers=None, n_iter=8):
        self.calls.append(("batch", n_iter, [
            (j.rnti, j.qm, j.tbs, j.harq_key, j.is_retx) for j in jobs]))
        return types.SimpleNamespace(
            results=[self.result(j.rnti, 0, j.qm, j.tbs) for j in jobs],
            seg_of={}, group_rows=[], tb=None)

    def finish_grants_batch(self, pb, soft_buffers=None, site="pf_d2h"):
        return list(pb.results)

    def decode_grant(self, grids, h, noise_var, b, cell, sf_idx, cfi, rnti,
                     prb_mask, qm, tbs, rv=0, prb_mask_slot1=None,
                     soft_buffers=None, harq_key=None, n_iter=8, pa=1.0):
        self.calls.append(("grant", rnti, qm, tbs, harq_key,
                           soft_buffers is not None))
        return self.result(rnti, 0, qm, tbs)

    def decode_grant_mimo(self, grids, h, noise_var, b, cell, sf_idx, cfi,
                          rnti, prb_mask, qms, tbss, tm, pmi=0, rvs=(0, 0),
                          soft_buffers=None, harq_keys=(None, None),
                          n_iter=8):
        self.calls.append(("mimo", rnti, tuple(qms), tuple(tbss), tm,
                           tuple(harq_keys), soft_buffers is not None))
        return [self.result(rnti, q, qms[q], tbss[q]) for q in (0, 1)]


@pytest.fixture
def air(monkeypatch):
    a = _Air()
    for name in ("dispatch_grants_batch", "finish_grants_batch",
                 "decode_grant", "decode_grant_mimo"):
        monkeypatch.setattr(pdsch_rx, name, getattr(a, name))
    return a


def _core(cell=CELL):
    c = core.LTESnifferCore(core.SnifferConfig(cell=cell, device="cpu",
                                               use_native=False))
    c.pcap = _Pcap()
    return c


def _mask(start, n):
    m = np.zeros(50, bool)
    m[start:start + n] = True
    return m


def _dci(rnti, fmt="1A", start=0, n_prb=8, mcs=10, pid=0, ndi=0, rv=0,
         **two):
    """An accepted DCI with its grant already derived."""
    m = _mask(start, n_prb)
    g = dci_mod.DlGrant(rnti=rnti, fmt=fmt, prb_mask=m,
                        prb_mask_slot1=m.copy(), mcs=mcs, harq_pid=pid,
                        ndi=ndi, rv=rv, **two)
    a = dci_search.AcceptedDci(rnti=rnti, fmt=fmt, l=2, ncce=0,
                               payload=None, histval=9)
    a._grant = g
    return a


def _subframe(c, sfn, sf, dcis):
    """One subframe's DCIs through phase 3's handlers, the batched
    dispatch and phases 4 and 5, as `_run_quantized` runs them."""
    ctx = dict(outs={}, fe=FE, base=0, B=1)
    pending = c._run_handlers(ctx, [(0, 2, 0, sf, sfn, list(dcis))])
    ctx["pdsch"] = c._dispatch_pending(FE, pending)
    c._phase4(ctx)
    c._phase5(ctx)


def _results(c):
    return [(r.dci.rnti, r.crc_ok, r.tbs, r.payload, r.is_retx, r.table)
            for r in c.results]


def _stats(c, rnti):
    s = c.mcs.stats_dl[rnti]
    return (s.new_tx, s.retx, s.success, s.fail, s.last_seen_tti)


def _harq(c):
    return {k: (v.ndi, v.tbs, v.last_tti, v.active, v.decoded)
            for k, v in c.harq.db.items()}


def _payload(rnti, q=0):
    return bytes((rnti + 7 * q + k) & 0xFF for k in range(24))


# ---------------------------------------------------------------------------
# the batched single-TB route
# ---------------------------------------------------------------------------
def test_batched_known_table_rnti(air):
    """A known-table RNTI decodes on its table with its soft buffer; its
    re-TX 8 ms later after a CRC pass is skipped."""
    c = _core()
    rnti = 0x1001
    c.mcs.learn_dl_table(rnti, Q256)
    qm, tbs = _qm_tbs(10, 8, Q256)
    air.send(rnti, 0, qm, tbs, _payload(rnti))
    _subframe(c, 10, 3, [_dci(rnti, mcs=10, pid=2, ndi=1)])
    key = (rnti, 2, 0)
    assert air.calls == [("batch", 2, [(rnti, qm, tbs, key, False)])]
    assert _results(c) == [(rnti, True, tbs, _payload(rnti), False, Q256)]
    assert _stats(c, rnti) == (1, 0, 1, 0, 103)
    assert _harq(c) == {key: (1, tbs, 103, True, True)}
    assert c.mcs.dl_table_of(rnti) == Q256
    assert c.pcap.records == [(rnti, 10, 3, True, 0, _payload(rnti))]
    _subframe(c, 11, 1, [_dci(rnti, mcs=10, pid=2, ndi=1)])
    assert c.harq_skipped == 1 and len(air.calls) == 1
    assert len(c.results) == 1 and len(c.pcap.records) == 1
    assert _harq(c) == {key: (1, tbs, 111, True, True)}


def test_batched_unknown_table_rnti_passes_on_256qam(air):
    """An unknown-table RNTI fails on 64QAM, passes the batched 256QAM
    retry at full iterations, and learns 256QAM; no soft buffer."""
    c = _core()
    rnti = 0x1002
    qm64, tbs64 = _qm_tbs(10, 8, Q64)
    qm, tbs = _qm_tbs(10, 8, Q256)
    assert (qm64, tbs64) != (qm, tbs)
    air.send(rnti, 0, qm, tbs, _payload(rnti))
    _subframe(c, 20, 4, [_dci(rnti, mcs=10)])
    assert air.calls == [("batch", 2, [(rnti, qm64, tbs64, None, False)]),
                         ("batch", 12, [(rnti, qm, tbs, None, False)])]
    assert _results(c) == [(rnti, True, tbs, _payload(rnti), False, Q256)]
    assert _stats(c, rnti) == (1, 0, 1, 0, 204)
    assert _harq(c) == {(rnti, 0, 0): (0, tbs64, 204, True, True)}
    assert c.mcs.dl_table_of(rnti) == Q256
    assert c.harq_skipped == 0
    assert c.pcap.records == [(rnti, 20, 4, True, 0, _payload(rnti))]


# ---------------------------------------------------------------------------
# the synchronous single-TB route
# ---------------------------------------------------------------------------
def test_fdd_ra_rnti_grant(air):
    """An FDD RA-RNTI grant decodes synchronously on 64QAM, with no HARQ
    and no table learning, and its RAR activates the T-CRNTI."""
    c = _core()
    rnti, t_crnti = 3, 0x4601
    qm, tbs = _qm_tbs(4, 4, Q64)
    rar = mac.build_rar_pdu([mac.Rar(rapid=5, ta=12, grant=50 << 9,
                                     t_crnti=t_crnti)])
    air.send(rnti, 0, qm, tbs, rar)
    _subframe(c, 30, 6, [_dci(rnti, n_prb=4, mcs=4)])
    assert air.calls == [("grant", rnti, qm, tbs, None, False)]
    assert _results(c) == [(rnti, True, tbs, rar, False, Q64)]
    assert _stats(c, rnti) == (1, 0, 1, 0, 306)
    assert _harq(c) == {}
    assert c.mcs.dl_table_of(rnti) == UNKNOWN
    assert c.harq_skipped == 0
    assert c.pcap.records == [(rnti, 30, 6, True, 0, rar)]
    assert t_crnti in [r for r, *_ in c.rm.active_set()]


def test_format_2a_one_tb_disabled_at_one_rx(air):
    """Format 2A with TB 0 disabled (MCS 0, RV 1) on a 1-RX cell decodes
    its TB 1 synchronously, as transmit diversity with TB 1's fields."""
    c = _core()
    rnti = 0x1003
    c.mcs.learn_dl_table(rnti, Q64)
    qm, tbs = _qm_tbs(12, 6, Q64)
    air.send(rnti, 0, qm, tbs, _payload(rnti))
    a = _dci(rnti, fmt="2A", n_prb=6, mcs=0, rv=1, pid=3, ndi=0,
             mcs2=12, rv2=0, ndi2=1, nof_tb=2)
    _subframe(c, 40, 2, [a])
    key = (rnti, 3, 0)
    assert air.calls == [("grant", rnti, qm, tbs, key, True)]
    assert _results(c) == [(rnti, True, tbs, _payload(rnti), False, Q64)]
    assert _stats(c, rnti) == (1, 0, 1, 0, 402)
    assert _harq(c) == {key: (1, tbs, 402, True, True)}
    assert c.mcs.dl_table_of(rnti) == Q64
    assert c.harq_skipped == 0
    assert c.pcap.records == [(rnti, 40, 2, True, 0, _payload(rnti))]
    assert c.mcs.stats_dl[rnti].wrong_mimo == 0


def test_mcs29_new_tx(air):
    """MCS 29 on a new TX has no TBS: the batched route hands it to the
    synchronous one, which decodes nothing and records a failure."""
    c = _core()
    rnti = 0x1004
    c.mcs.learn_dl_table(rnti, Q64)
    _subframe(c, 50, 7, [_dci(rnti, mcs=29, pid=5, ndi=1)])
    assert air.calls == []
    assert _results(c) == [(rnti, False, 0, None, False, Q64)]
    assert _stats(c, rnti) == (1, 0, 0, 1, 507)
    assert _harq(c) == {(rnti, 5, 0): (1, 0, 507, True, False)}
    assert c.mcs.dl_table_of(rnti) == Q64
    assert c.harq_skipped == 0
    assert c.pcap.records == []


# ---------------------------------------------------------------------------
# the two-codeword route
# ---------------------------------------------------------------------------
def _two_cw(rnti, mcs=10, mcs2=12, pid=1, ndi=0, ndi2=0):
    return _dci(rnti, fmt="2A", n_prb=8, mcs=mcs, rv=0, pid=pid, ndi=ndi,
                mcs2=mcs2, rv2=0, ndi2=ndi2, nof_tb=2)


def test_two_codeword_grant_on_2rx_cell(air):
    """Both codewords of a TM3 grant of an unknown-table RNTI pass on
    64QAM: the RNTI learns 64QAM, each codeword is recorded in order,
    the trial decode uses no soft buffer."""
    c = _core(CELL_2RX)
    rnti = 0x1005
    (qm0, tbs0), (qm1, tbs1) = _qm_tbs(10, 8, Q64), _qm_tbs(12, 8, Q64)
    air.send(rnti, 0, qm0, tbs0, _payload(rnti, 0))
    air.send(rnti, 1, qm1, tbs1, _payload(rnti, 1))
    c._handle_dl_dci(FE, 0, 2, _two_cw(rnti), 60, 8)
    assert air.calls == [("mimo", rnti, (qm0, qm1), (tbs0, tbs1), 3,
                          (None, None), False)]
    assert _results(c) == [
        (rnti, True, tbs0, _payload(rnti, 0), False, Q64),
        (rnti, True, tbs1, _payload(rnti, 1), False, Q64)]
    assert _stats(c, rnti) == (2, 0, 2, 0, 608)
    assert _harq(c) == {(rnti, 1, 0): (0, tbs0, 608, True, True),
                        (rnti, 1, 1): (0, tbs1, 608, True, True)}
    assert c.mcs.dl_table_of(rnti) == Q64
    assert c.harq_skipped == 0
    assert c.pcap.records == [(rnti, 60, 8, True, 0, _payload(rnti, 0)),
                              (rnti, 60, 8, True, 0, _payload(rnti, 1))]


# ---------------------------------------------------------------------------
# differences between the routes, kept for parity
# ---------------------------------------------------------------------------
def test_sync_route_clears_unknown_rnti_buffer_batched_does_not(air):
    """(a) At a new TX of an unknown-table RNTI the synchronous route
    clears its soft buffer; the batched route leaves it."""
    c = _core()
    batched, sync = 0x1101, 0x1102
    for r in (batched, sync):
        c.soft_buffers[((r, 0, 0), 0)] = "stale"
    _subframe(c, 70, 1, [
        _dci(batched, start=0),
        _dci(sync, fmt="2A", start=10, mcs=0, rv=1, mcs2=10, nof_tb=2)])
    assert [k[0][0] for k in c.soft_buffers] == [batched]


def test_two_codeword_tbs_get_no_mac_handling(air):
    """(b) A two-codeword TB carrying an RRC ConnectionSetup configures
    no UE; the same PDU on the batched route does."""
    setup = rrc.encode_connection_setup(rrc.RrcConnectionSetup(
        p_a_db=-3.0, cqi_offset=8, ack_offset=9, ri_offset=7, tm=3))
    pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=mac.LCID_CCCH,
                                           payload=setup)])
    c = _core(CELL_2RX)
    two, one = 0x1201, 0x1202
    for r in (two, one):
        c.mcs.learn_dl_table(r, Q64)
    air.send(two, 0, *_qm_tbs(10, 8, Q64), pdu)
    air.send(two, 1, *_qm_tbs(12, 8, Q64), pdu)
    air.send(one, 0, *_qm_tbs(10, 8, Q64), pdu)
    _subframe(c, 80, 2, [_two_cw(two), _dci(one, start=20)])
    assert [r.crc_ok for r in c.results] == [True, True, True]
    assert sorted(c.mcs.ue_config) == [one]


def test_two_codeword_route_decodes_a_decoded_retx_again(air):
    """(c) A re-TX 8 ms after both codewords passed is decoded again on
    the two-codeword route (the single-TB routes skip it)."""
    c = _core(CELL_2RX)
    rnti = 0x1301
    c.mcs.learn_dl_table(rnti, Q64)
    air.send(rnti, 0, *_qm_tbs(10, 8, Q64), _payload(rnti, 0))
    air.send(rnti, 1, *_qm_tbs(12, 8, Q64), _payload(rnti, 1))
    c._handle_dl_dci(FE, 0, 2, _two_cw(rnti), 90, 1)
    c._handle_dl_dci(FE, 0, 2, _two_cw(rnti), 90, 9)
    assert ([r.is_retx for r in c.results], c.harq_skipped) == \
        ([False, False, True, True], 0)


def test_zero_tbs_retx_is_classified_twice(air):
    """(d) An MCS-29 re-TX of a process whose stored TBS is 0 has no TBS
    after the batched route's classification; the synchronous route
    classifies it again at the same TTI, which makes it a new TX."""
    c = _core()
    rnti = 0x1401
    c.mcs.learn_dl_table(rnti, Q64)
    _subframe(c, 100, 0, [_dci(rnti, mcs=29, pid=4, ndi=1)])
    _subframe(c, 100, 8, [_dci(rnti, mcs=29, pid=4, ndi=1)])
    assert [(r.is_retx, r.tbs) for r in c.results] == \
        [(False, 0), (False, 0)]


def test_no_tbs_recorded_on_sync_route_not_on_two_codeword(air):
    """(e) With no table giving a TBS, the synchronous route records a
    failed result of TBS 0 and the two-codeword route records nothing."""
    c = _core(CELL_2RX)
    one, two = 0x1501, 0x1502
    c._handle_dl_dci(FE, 0, 2, _dci(one, mcs=29), 110, 1)
    c._handle_dl_dci(FE, 0, 2, _two_cw(two, mcs=29, mcs2=30), 110, 1)
    assert air.calls == []
    assert _results(c) == [(one, False, 0, None, False, Q64)]


def test_sync_route_handles_no_sib(air):
    """(g) A SIB1 decoded on the synchronous route (an SI-RNTI format-2A
    grant with one TB disabled) is not handled; on the batched route it
    is."""
    sib1 = rrc.encode_sib1(rrc.Sib1Info(
        mcc="901", mnc="55", tac=7, cell_identity=0x19B01, freq_band=7,
        scheduling=[(16, ["sibType3"])], si_window_ms=20))
    qm, tbs = _qm_tbs(4, 8, Q64)
    seen = []
    for fmt, two in (("2A", dict(mcs2=4, nof_tb=2)), ("1A", {})):
        c = _core()
        air.send(0xFFFF, 0, qm, tbs, sib1)
        a = _dci(0xFFFF, fmt=fmt, **(dict(mcs=0, rv=1, **two) if two
                                       else dict(mcs=4)))
        _subframe(c, 120, 5, [a])
        assert [r.crc_ok for r in c.results] == [True]
        seen.append(c.sib1_info is not None)
    assert seen == [False, True]


def test_two_codeword_route_treats_special_rntis_as_ues(air):
    """(h) A two-codeword grant of an RA-RNTI is classified, trialled on
    both tables and learns its table, as a UE's would."""
    c = _core(CELL_2RX)
    rnti = 0x30
    air.send(rnti, 0, *_qm_tbs(10, 8, Q256), _payload(rnti, 0))
    air.send(rnti, 1, *_qm_tbs(12, 8, Q256), _payload(rnti, 1))
    c._handle_dl_dci(FE, 0, 2, _two_cw(rnti), 130, 2)
    assert (sorted(c.harq.db), c.mcs.dl_table_of(rnti),
            [r.crc_ok for r in c.results]) == \
        ([(rnti, 1, 0), (rnti, 1, 1)], Q256, [True, True])


# ---------------------------------------------------------------------------
# RLC AM data PDUs whose length indicators run past the PDU
# ---------------------------------------------------------------------------
def _two_li_pdu() -> bytes:
    """An AM data PDU (D/C 1, RF 0, E 1) with two LIs, 3 and 2 octets:
    26 bits of E/LI fields padded to 4 octets, then 3 + 2 + 4 octets."""
    bits = [1] + [int(b) for b in f"{3:012b}"] + \
        [0] + [int(b) for b in f"{2:012b}"]
    bits += [0] * (32 - len(bits))
    li = bytes(int("".join(map(str, bits[i:i + 8])), 2)
               for i in range(0, 32, 8))
    return bytes([0x84, 0x07]) + li + bytes(range(1, 10))


@pytest.mark.parametrize("pdu, want", [
    (bytes([0x84, 0, 0]), None),
    (bytes([0x84, 0, 0x80, 0, 0]), None),
    (_two_li_pdu(), bytes(range(1, 10))),
], ids=["first_li_short", "second_li_short", "two_lis"])
def test_parse_rlc_am_data_short_li(pdu, want):
    assert mac.parse_rlc_am_data(pdu) == want


def test_learn_ue_config_survives_short_srb1_pdu():
    """A DL MAC PDU whose SRB1 SDU is a short AM data PDU with E set
    leaves the UE unconfigured instead of raising."""
    c = _core()
    pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=1,
                                           payload=bytes([0x84, 0, 0]))])
    c._learn_ue_config(0x1601, pdu)
    assert 0x1601 not in c.mcs.ue_config
