"""A 2x2 spatial-multiplexing downlink cell, built in memory.

A 20 MHz (100 PRB) cell with 2 TX ports, heard on 2 RX antennas, CFI 2,
PBCH on subframe 0.  Every subframe schedules up to N_TM3 format-2A (TM3,
open-loop CDD) grants, N_TM4 format-2 (TM4, closed-loop, PMI 0-2) grants
and N_SISO format-1A grants, each of 8 PRBs, to distinct UEs per DL format
(the RNTI manager locks one DL format per UE).  A third of the MIMO UEs
are on the 256QAM MCS table (mcs 7 differs between the tables), so the
sniffer runs its two-codeword dual-table trial and learns the table.
Each subframe sees its own random channel draw; DCIs that find no free
CCEs are dropped, as a loaded scheduler would.

Built from the test-side encoder's functions, as `tests/test_mimo.py`
builds its frames; nothing is written to disk.  With N_TM3 = N_TM4 = 0 the
same builder gives a 2-RX single-layer (TM2) cell.
"""
from __future__ import annotations

import numpy as np

from ltesniffer_tpu_torch.kernels import cplx
from ltesniffer_tpu_torch.phy import dci as dci_mod, grid as grid_mod
from ltesniffer_tpu_torch.phy import ra, search_space, tables
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.testing import encoder

CELL = CellConfig(n_id_cell=411, n_prb=100, nof_ports=2, nof_rx_ant=2)
N_SF = 64
N_TM3 = 4
N_TM4 = 4
N_SISO = 4
UES_PER_FORMAT = 6
N_PRB_GRANT = 8
SEED = 11
CFI = 2
NOISE = 0.02
# MCS per UE class: (mcs, mcs2) on the 64QAM table; the 256QAM-table UEs
# send mcs 7 (16QAM there, QPSK on the 64QAM table)
MIMO_MCS_64 = ((9, 9), (13, 11))
MIMO_MCS_256 = (7, 7)
SISO_MCS = 9


def params(n_sf: int = N_SF) -> dict:
    """The scenario's parameters, as the expected record stores them."""
    return dict(n_id_cell=CELL.n_id_cell, n_prb=CELL.n_prb,
                nof_ports=CELL.nof_ports, nof_rx_ant=CELL.nof_rx_ant,
                n_sf=n_sf, n_tm3=N_TM3, n_tm4=N_TM4, n_siso=N_SISO,
                ues_per_format=UES_PER_FORMAT, n_prb_grant=N_PRB_GRANT,
                seed=SEED, cfi=CFI, noise=NOISE)


def _bitmap(cell: CellConfig, prb_start: int, n_prb: int) -> int:
    """Type-0 RBG bitmap covering [prb_start, prb_start + n_prb)."""
    P = tables.rbg_size(cell.n_prb)
    n_rbg = -(-cell.n_prb // P)
    bm = 0
    for rbg in range(prb_start // P, min(-(-(prb_start + n_prb) // P),
                                          n_rbg)):
        bm |= 1 << (n_rbg - 1 - rbg)
    return bm


def _place(rnti: int, sf: int, nof_cce: int, used: set, prefer):
    """First free UE-specific candidate, aggregation levels in `prefer`
    order; None if every candidate overlaps a placed DCI."""
    cands = search_space.ue_candidates(rnti, sf, nof_cce)
    for want in prefer:
        for l, nc in cands:
            span = set(range(nc, nc + (1 << l)))
            if l == want and not span & used:
                used.update(span)
                return l, nc
    return None


def build_frames(cell: CellConfig = CELL, n_sf: int = N_SF,
                 n_tm3: int = N_TM3, n_tm4: int = N_TM4,
                 n_siso: int = N_SISO, seed: int = SEED,
                 noise: float = NOISE):
    """-> (complex64 IQ frames (n_sf, RX, sf_len), truth): truth lists one
    dict per transport block placed (sf, sf_idx, rnti, fmt, cw, mcs,
    table_256, tbs, payload bytes)."""
    rng = np.random.default_rng(seed)
    nof_cce = grid_mod.control_region(cell, CFI)["nof_pdcch_regs"] // 9
    pools = {f: [0x1000 * (k + 1) + i for i in range(UES_PER_FORMAT)]
             for k, f in enumerate(("2A", "2", "1A"))}
    counts = {"2A": n_tm3, "2": n_tm4, "1A": n_siso}
    ndi = {}
    frames, truth = [], []
    for j in range(n_sf):
        sf = j % 10
        used: set = set()
        txs, pdsch = [], []
        slot = 0
        for fmt in ("2A", "2", "1A"):
            pool = pools[fmt]
            for g in range(counts[fmt]):
                rnti = pool[(j * counts[fmt] + g) % len(pool)]
                prb_start = slot * N_PRB_GRANT
                slot += 1
                pid = (j // 2) % 8
                ndi[(rnti, pid)] = ndi.get((rnti, pid), 1) ^ 1
                mimo = fmt != "1A"
                pmi = 0
                pos = _place(rnti, sf, nof_cce, used,
                             (2, 1, 3, 0) if mimo else (1, 0, 2, 3))
                if pos is None:
                    continue
                mask = np.zeros(cell.n_prb, bool)
                mask[prb_start:prb_start + N_PRB_GRANT] = True
                if mimo:
                    on256 = pool.index(rnti) % 3 == 2
                    mcs, mcs2 = (MIMO_MCS_256 if on256 else
                                 MIMO_MCS_64[pool.index(rnti) % 2])
                    fields = dict(ra_header=0,
                                  bitmap=_bitmap(cell, prb_start,
                                                 N_PRB_GRANT),
                                  tpc=0, harq_pid=pid, tb_swap=0, mcs=mcs,
                                  ndi=ndi[(rnti, pid)], rv=0, mcs2=mcs2,
                                  ndi2=ndi[(rnti, pid)], rv2=0)
                    if fmt == "2":
                        pmi = (j + g) % 3
                        fields["precoding"] = pmi
                    cws = []
                    for m in (mcs, mcs2):
                        qm, itbs = tables.dl_mcs_to_qm_itbs(m, on256)
                        cws.append((qm, tables.tbs_lookup(itbs,
                                                          N_PRB_GRANT), m))
                else:
                    on256 = False
                    fields = dict(flag0_1a=1, vrb_flag=0,
                                  riv=ra.start_len_to_riv(
                                      prb_start, N_PRB_GRANT, cell.n_prb),
                                  mcs=SISO_MCS, harq_pid=pid,
                                  ndi=ndi[(rnti, pid)], rv=0, tpc=0)
                    qm, itbs = tables.dl_mcs_to_qm_itbs(SISO_MCS, False)
                    cws = [(qm, tables.tbs_lookup(itbs, N_PRB_GRANT),
                            SISO_MCS)]
                txs.append(encoder.TxDci(
                    dci=dci_mod.Dci(fmt=fmt, rnti=rnti, fields=fields),
                    L=pos[0], ncce=pos[1]))
                tbs_bits = []
                for q, (qm, tbs, m) in enumerate(cws):
                    tb = rng.integers(0, 2, tbs).astype(np.uint8)
                    tbs_bits.append(tb)
                    truth.append(dict(sf=j, sf_idx=sf, rnti=rnti, fmt=fmt,
                                      cw=q, mcs=m, table_256=on256, tbs=tbs,
                                      payload=np.packbits(tb).tobytes()))
                pdsch.append((fmt, rnti, mask, [c[0] for c in cws],
                              tbs_bits, pmi))
        g = encoder.build_control_subframe(cell, sf, CFI, txs)
        if sf == 0:
            encoder.add_pbch(g, cell, j // 10)
        for fmt, rnti, mask, qms, tbs_bits, pmi in pdsch:
            if fmt == "1A":
                encoder.add_pdsch(g, cell, sf, CFI, rnti, mask, qms[0],
                                  tbs_bits[0])
            else:
                encoder.add_pdsch_mimo(g, cell, sf, CFI, rnti, mask,
                                       tuple(qms), tbs_bits,
                                       tm=3 if fmt == "2A" else 4, pmi=pmi)
        h = encoder.flat_channel(cell, cell.nof_rx_ant, rng)
        frames.append(encoder.subframe_iq(
            cell, encoder.apply_channel(g, h, noise, rng)))
    return np.stack(frames).astype(np.complex64), truth


def build_packed(n_sf: int = N_SF, **kw):
    """-> ((n_sf, RX, n/2) packed int8 IQ words, (n_sf,) scales, truth):
    the pre-quantized form `LTESnifferCore.run_packed` takes."""
    frames, truth = build_frames(n_sf=n_sf, **kw)
    words, scales = cplx.to_i8_packed(frames)
    return words, scales, truth
