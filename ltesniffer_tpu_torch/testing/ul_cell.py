"""The bench's uplink cell, built in memory.

A 20 MHz (100 PRB), 2-port cell, one RX antenna, CFI 2, in UL mode: the
DL carrier carries GRANTS format-0 grants per subframe (8 PRB each at
prb_start = 8 g, UL MCS 6: QPSK, TBS 808, one code block of K = 832), and
each grant's PUSCH appears on the UL carrier 4 subframes later.  RNTIs
cycle through N_RNTI UEs.  It re-states the JAX package's
`bench.py:run_ul_e2e` scenario (whose module imports JAX at its top) with
the same random draws — `DualScenarioBuilder(seed=SEED)` and the TB bits
from `default_rng(SEED)` — so both packages see the same IQ.  The dual
trace carries no PBCH: the sniffer runs with the cell and SFN preset
(`acquire_sfn=False`).  Nothing is written to disk.

Beside it: `uci_scenario`, the streams of one PUSCH that carries
HARQ-ACK, RI and aperiodic CQI, and `log_dci0` / `result_rows`, which
record a UL core's run (of either package) for the expected record.
"""
from __future__ import annotations

import numpy as np

from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.phy import dci as dci_mod, grid as grid_mod
from ltesniffer_tpu_torch.phy import ra, search_space, tables, uci
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import trackers
from ltesniffer_tpu_torch.testing import encoder, scenario

CELL = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
N_SF = 1024
GRANTS = 8
N_RNTI = 40
RNTI0 = 0x400
UL_MCS = 6
N_PRB_GRANT = 8
SEED = 11
CFI = 2
BATCH = 256          # the bench's UL batch size, record and card alike
# the UCI scenario's cell (tests/test_ul_mode_e2e.py)
UCI_CELL = CellConfig(n_id_cell=147, n_prb=50, nof_ports=2, nof_rx_ant=1)


def params(n_sf: int = N_SF) -> dict:
    """The scenario's parameters, as the expected record stores them."""
    return dict(n_id_cell=CELL.n_id_cell, n_prb=CELL.n_prb,
                nof_ports=CELL.nof_ports, nof_rx_ant=CELL.nof_rx_ant,
                n_sf=n_sf, grants=GRANTS, n_rnti=N_RNTI, rnti0=RNTI0,
                ul_mcs=UL_MCS, n_prb_grant=N_PRB_GRANT, seed=SEED, cfi=CFI)


def build_streams(cell: CellConfig = CELL, n_sf: int = N_SF,
                  grants: int = GRANTS, seed: int = SEED):
    """-> (DL complex64 stream, UL complex64 stream, placed DCI0s, truth):
    truth holds one (stream index of the PUSCH, rnti, payload bytes) per
    PUSCH the UL stream carries."""
    rng = np.random.default_rng(seed)
    sb = scenario.DualScenarioBuilder(cell, cfi=CFI, seed=seed)
    _, itbs = tables.ul_mcs_to_qm_itbs(UL_MCS)
    tbs = tables.tbs_lookup(itbs, N_PRB_GRANT)
    placed = 0
    sent = {}                       # PUSCH stream index -> [(rnti, bytes)]
    for j in range(n_sf):
        txs = [scenario.UlTx(
            rnti=RNTI0 + ((j * grants + g) % N_RNTI),
            tb_bits=rng.integers(0, 2, tbs).astype(np.uint8),
            mcs=UL_MCS, prb_start=g * N_PRB_GRANT, n_prb=N_PRB_GRANT)
            for g in range(grants)]
        placed += sb.add_subframe(j % 10, txs, strict=False)
        # the grants placed in subframe j, as their PUSCH was queued
        sent[j + 4] = [(p["rnti"], np.packbits(p["tb_bits"]).tobytes())
                       for p in sb._pending.get(j + 4, [])]
    truth = [(k, rnti, pdu) for k in sorted(sent) if k < n_sf
             for rnti, pdu in sent[k]]
    dl, ul = sb.streams()
    return dl, ul, placed, truth


def build_packed(n_sf: int = N_SF, **kw):
    """-> (DL (words, scales), UL (words, scales), placed, truth): the
    pre-quantized form `LTESnifferCoreUL.run_dual_packed` takes."""
    dl, ul, placed, truth = build_streams(n_sf=n_sf, **kw)
    n = CELL.sf_len
    return (cplx.to_i8_packed(dl[:n_sf * n].reshape(n_sf, 1, n)),
            cplx.to_i8_packed(ul[:n_sf * n].reshape(n_sf, 1, n)),
            placed, truth)


def log_dci0(c) -> list:
    """Log every DCI0 a UL core (of either package) accepts, as
    [tti, rnti] in time order, by wrapping its `_handle_ul_dci`."""
    log = []
    inner = c._handle_ul_dci

    def handle(a, sfn, sf, nof_ack=0):
        log.append([sfn * 10 + sf, int(a.rnti)])
        return inner(a, sfn, sf, nof_ack=nof_ack)
    c._handle_ul_dci = handle
    return log


def result_rows(c) -> list:
    """A UL core's results as [sfn, sf_idx, rnti, crc_ok, tbs, table]."""
    return [[r.sfn, r.sf_idx, int(r.rnti), int(bool(r.crc_ok)), r.tbs,
             r.table.value] for r in c.ul_results]


def uci_scenario(cell: CellConfig = UCI_CELL):
    """tests/test_ul_mode_e2e.py:test_uci_ack_ri_through_core's streams:
    ten subframes, one PUSCH carrying HARQ-ACK + RI + aperiodic CQI (the
    DCI0's subframe also carries a DL assignment for the same RNTI, and the
    DCI0 requests CSI, so the sniffer must place the same UCI) ->
    (DL stream, UL stream, rnti, transmitted TB bits)."""
    rng = np.random.default_rng(7)
    rnti = 0x5a5a
    ul_mcs = 6
    prb_start, n_prb = 5, 10
    nof_cce = grid_mod.control_region(cell, CFI)["nof_pdcch_regs"] // 9
    qm, i_tbs = tables.ul_mcs_to_qm_itbs(ul_mcs)
    tbs = tables.tbs_lookup(i_tbs, n_prb)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    # the beta offsets the sniffer reads (default UE config)
    ue_cfg = trackers.UeConfig()
    n_ri, n_ack = uci.uci_symbol_counts(
        1, 1, ue_cfg.uci_offset_ack, ue_cfg.uci_offset_ri, n_prb, tbs)
    n_cqi = uci.cqi_q_prime(uci.aperiodic_cqi_bits(cell.n_prb),
                            ue_cfg.uci_offset_cqi, n_prb, tbs,
                            n_ri_syms=n_ri)
    h_dl = encoder.flat_channel(cell, 1, rng)
    dl_frames, ul_frames = [], []
    at = 2
    for j in range(10):
        txs = []
        if j == at:
            cands = [c for c in search_space.ue_candidates(rnti, j, nof_cce)
                     if c[0] == 2]
            (l0, ncce0), (l1, ncce1) = cands[0], cands[1]
            txs.append(encoder.TxDci(dci=dci_mod.Dci(
                fmt="0", rnti=rnti, fields=dict(
                    flag0_1a=0, hopping=0,
                    riv=ra.start_len_to_riv(prb_start, n_prb, cell.n_prb),
                    mcs=ul_mcs, ndi=1, tpc=0, dmrs_cs=2, cqi_request=1)),
                L=l0, ncce=ncce0))
            # DL assignment in the same subframe -> 1 ACK on the PUSCH
            txs.append(encoder.TxDci(dci=dci_mod.Dci(
                fmt="1A", rnti=rnti, fields=dict(
                    flag0_1a=1, vrb_flag=0,
                    riv=ra.start_len_to_riv(20, 4, cell.n_prb), mcs=5,
                    harq_pid=1, ndi=0, rv=0, tpc=0)), L=l1, ncce=ncce1))
        g = encoder.build_control_subframe(cell, j, CFI, txs)
        dl_frames.append(encoder.subframe_iq(
            cell, encoder.apply_channel(g, h_dl, 0.04, rng))[0])
        ug = (encoder.build_ul_subframe(cell, j, [dict(
            rnti=rnti, prb_start=prb_start, n_prb=n_prb, qm=qm, tb_bits=tb,
            dmrs_field=2, n_ri_syms=n_ri, n_ack_syms=n_ack,
            n_cqi_syms=n_cqi)]) if j == at + 4
            else np.zeros((1, 14, cell.n_sc), np.complex64))
        un = ug + 0.03 / np.sqrt(2) * (rng.standard_normal(ug.shape)
                                       + 1j * rng.standard_normal(ug.shape))
        ul_frames.append(encoder.ul_subframe_iq(
            cell, un.astype(np.complex64))[0])
    return np.concatenate(dl_frames), np.concatenate(ul_frames), rnti, tb
