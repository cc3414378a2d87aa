"""The loaded-cell downlink scenario, built in memory.

A 20 MHz (100 PRB), 2-port cell carrying N_RNTI active UEs with GRANTS
PDSCH grants per subframe under real CCE contention, PBCH on subframe 0,
and every third UE on the 256QAM MCS table (mcs 7 differs between the
tables, so the sniffer must dual-table-trial the first grant and learn).
It re-states the JAX package's `bench.py:build_stream` (whose module
imports JAX at its top) with the same random draws, so both packages see
the same IQ, format-2A load included: MIMO_DCIS two-codeword (format 2A)
DCIs per subframe, as `bench.py` sends them.  The cell has one RX
antenna, so both packages count each such grant as a wrong-MIMO config
(the reference's W_MIMO column) and decode no PDSCH for it.  Nothing is
written to disk.
"""
from __future__ import annotations


from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.mac_rrc import mac
from ltesniffer_tpu_torch.phy import tables
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.testing import scenario

CELL = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
N_SF = 512
N_RNTI = 150
GRANTS = 12
MIMO_DCIS = 1
SEED = 7
CFI = 2


def params(n_sf: int = N_SF) -> dict:
    """The scenario's parameters, as the expected record stores them."""
    return dict(n_id_cell=CELL.n_id_cell, n_prb=CELL.n_prb,
                nof_ports=CELL.nof_ports, nof_rx_ant=CELL.nof_rx_ant,
                n_sf=n_sf, n_rnti=N_RNTI, grants=GRANTS,
                mimo_dcis=MIMO_DCIS, seed=SEED, cfi=CFI)


def build_stream(cell: CellConfig = CELL, n_sf: int = N_SF,
                 n_rnti: int = N_RNTI, grants: int = GRANTS,
                 mimo_dcis: int = MIMO_DCIS, seed: int = SEED,
                 pdsch_free_sf: tuple = ()):
    """-> (complex64 IQ stream (n_sf * sf_len,), placed transport blocks,
    per-TB truth dicts (sf, sf_idx, rnti, tbs, mcs, pdu)).

    `pdsch_free_sf`: subframe indices (0-9) that carry no grant at all;
    the stream scenario leaves 0 and 5 free (`testing/stream_cell.py`)."""
    sb = scenario.ScenarioBuilder(cell, cfi=CFI, seed=seed)
    # the last few RNTIs are TM3 (format 2A) UEs: the RNTI manager's
    # per-RNTI DL-format lock means a UE is either 1A- or 2A-scheduled
    n_mimo_ues = max(1, 2 * mimo_dcis)
    rntis = [0x100 + i for i in range(n_rnti - n_mimo_ues)]
    mimo_rntis = [0x100 + n_rnti - n_mimo_ues + i
                  for i in range(n_mimo_ues)]
    mcs256 = 7
    qm256, itbs256 = tables.dl_mcs_to_qm_itbs(mcs256, True)
    tbs256 = tables.tbs_lookup(itbs256, 8)
    ndi = {}
    placed = 0
    for j in range(n_sf):
        sf = j % 10
        txs = []
        for g in range(0 if sf in pdsch_free_sf else grants):
            r = rntis[(j * grants + g) % len(rntis)]
            pid = (j // 8) % 8
            ndi[(r, pid)] = ndi.get((r, pid), 1) ^ 1
            on256 = (r - 0x100) % 3 == 2
            size = min(40 + 10 * (g % 3), tbs256 // 8 - 2)
            pdu = mac.build_mac_pdu([mac.MacSubPdu(
                lcid=3, payload=bytes([g]) * size)])
            txs.append(scenario.DlTx(
                rnti=r, mac_pdu=pdu, n_prb=8, prb_start=g * 8,
                harq_pid=pid, ndi=ndi[(r, pid)],
                mcs=mcs256 if on256 else None, table_256=on256))
        for m in range(0 if sf in pdsch_free_sf else mimo_dcis):
            # spatial-mux 2-TB grant (format 2A): W_MIMO tracker load
            txs.append(scenario.DlTx(
                rnti=mimo_rntis[(j + m) % len(mimo_rntis)], mac_pdu=b"",
                nof_tb=2, prb_start=96, n_prb=4,
                harq_pid=(j // 8) % 8))
        placed += sb.add_subframe(sf, txs, strict=False,
                                  with_pbch_sfn=j // 10 if sf == 0 else None)
    return sb.stream(), placed, sb.truth


def pack(stream, n_sf: int = N_SF):
    """A stream of `build_stream` -> ((n_sf, 1, n/2) packed int8 IQ words,
    (n_sf,) scales): the pre-quantized form `LTESnifferCore.run_packed`
    takes."""
    n = CELL.sf_len
    return cplx.to_i8_packed(stream[:n_sf * n].reshape(n_sf, 1, n))


def build_packed(n_sf: int = N_SF, **kw):
    """-> (packed int8 IQ words, scales, placed, truth): `pack` of
    `build_stream`."""
    stream, placed, truth = build_stream(n_sf=n_sf, **kw)
    words, scales = pack(stream, n_sf)
    return words, scales, placed, truth
