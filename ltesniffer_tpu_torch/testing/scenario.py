"""Scenario builder: scripted multi-subframe eNodeB streams for e2e tests.

Drives the test-side encoder to produce an IQ stream with control channels,
PDCCH DCIs and PDSCH transport blocks (MAC PDUs), so `LTESnifferCore` can be
validated like the reference validates against recorded traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ltesniffer_tpu_torch.phy import dci as dci_mod, ra, tables
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.phy import search_space
from . import encoder


@dataclasses.dataclass
class DlTx:
    """One scheduled DL transport block."""
    rnti: int
    mac_pdu: bytes
    mcs: int = None              # chosen automatically if None
    prb_start: int = 0
    n_prb: int = 10
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    L: Optional[int] = None      # aggregation exponent; auto if None
    ncce: Optional[int] = None
    # encode with the 256QAM-table interpretation of `mcs` (requires an
    # explicit mcs): the sniffer must dual-table-trial and learn
    table_256: bool = False
    # 2: emit a format 2A two-codeword DCI instead (spatial mux; on a
    # 1-RX receiver this is undecodable and exercises the reference's
    # W_MIMO counting path, `MCSTracking.cc:98-110`).  mac_pdu unused.
    nof_tb: int = 1


def _fit_mcs(pdu_len_bits: int, n_prb: int) -> Tuple[int, int]:
    """Smallest (mcs, tbs) whose TBS fits the PDU (QPSK/16QAM region)."""
    for mcs in range(0, 29):
        qm, itbs = tables.dl_mcs_to_qm_itbs(mcs)
        if itbs < 0:
            continue
        tbs = tables.tbs_lookup(itbs, n_prb)
        if tbs >= pdu_len_bits:
            return mcs, tbs
    raise ValueError("PDU too large for allocation")


class ScenarioBuilder:
    def __init__(self, cell: CellConfig, cfi: int = 2, noise: float = 0.04,
                 seed: int = 0, sfn0: int = 0):
        self.cell = cell
        self.cfi = cfi
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.h = encoder.flat_channel(cell, cell.nof_rx_ant, self.rng)
        self.subframes: List[np.ndarray] = []
        self.sfn0 = sfn0
        self.truth: List[dict] = []

    def add_subframe(self, sf_idx: int, dl_txs: Sequence[DlTx] = (),
                     with_pbch_sfn: Optional[int] = None,
                     strict: bool = True) -> int:
        """Encode one subframe.  With strict=False, transmissions whose DCI
        cannot be placed (all search-space candidates already used) are
        skipped instead of raising — loaded-cell scenarios hit real CCE
        contention just like a real scheduler.  Returns the number of
        transmissions actually placed."""
        cell = self.cell
        tx_dcis = []
        pdsch_jobs = []
        used_cce = set()
        for t in dl_txs:
            pdu_bits = len(t.mac_pdu) * 8
            mcs = t.mcs
            if t.nof_tb == 2:
                if mcs is None:
                    mcs = 9
                tbs = 0          # spatial mux: no decodable PDSCH at 1 RX
            elif mcs is None:
                mcs, tbs = _fit_mcs(pdu_bits, t.n_prb)
            else:
                qm, itbs = tables.dl_mcs_to_qm_itbs(mcs, t.table_256)
                if itbs < 0:
                    raise ValueError(f"mcs {mcs} has no TBS in this table")
                tbs = tables.tbs_lookup(itbs, t.n_prb)
            # place the DCI
            L, ncce = t.L, t.ncce
            if L is None or ncce is None:
                if t.rnti >= 0xFFF4 or t.rnti <= 0x3C:
                    cands = search_space.common_candidates(
                        self._nof_cce())
                else:
                    cands = search_space.ue_candidates(
                        t.rnti, sf_idx, self._nof_cce())
                placed = False
                for (l, nc) in cands:
                    span = set(range(nc, nc + (1 << l)))
                    if not span & used_cce:
                        L, ncce = l, nc
                        used_cce.update(span)
                        placed = True
                        break
                if not placed:
                    if strict:
                        raise ValueError("no free CCEs")
                    continue
            else:
                used_cce.update(range(ncce, ncce + (1 << L)))
            if t.nof_tb == 2:
                # format 2A two-codeword grant: RBG bitmap over the
                # allocation span (rounded to whole RBGs)
                P = tables.rbg_size(cell.n_prb)
                n_rbg = -(-cell.n_prb // P)
                r0 = t.prb_start // P
                r1 = -(-(t.prb_start + t.n_prb) // P)
                bitmap = 0
                for rbg in range(r0, min(r1, n_rbg)):
                    bitmap |= 1 << (n_rbg - 1 - rbg)
                fields = dict(bitmap=bitmap, tpc=0, harq_pid=t.harq_pid,
                              tb_swap=0, mcs=mcs, ndi=t.ndi, rv=t.rv,
                              mcs2=mcs, ndi2=t.ndi, rv2=t.rv)
                if cell.n_prb > 10:
                    fields["ra_header"] = 0
                d = dci_mod.Dci(fmt="2A", rnti=t.rnti, fields=fields)
                tx_dcis.append(encoder.TxDci(dci=d, L=L, ncce=ncce))
                continue                 # no PDSCH encoded (W_MIMO path)
            riv = ra.start_len_to_riv(t.prb_start, t.n_prb, cell.n_prb)
            d = dci_mod.Dci(fmt="1A", rnti=t.rnti, fields=dict(
                flag0_1a=1, vrb_flag=0, riv=riv, mcs=mcs,
                harq_pid=t.harq_pid, ndi=t.ndi, rv=t.rv, tpc=0))
            tx_dcis.append(encoder.TxDci(dci=d, L=L, ncce=ncce))
            # pad TB with the MAC padding structure is the caller's job;
            # here we zero-pad the PDU bytes up to TBS
            tb = np.zeros(tbs, dtype=np.uint8)
            pdu_bits_arr = np.unpackbits(
                np.frombuffer(t.mac_pdu, dtype=np.uint8))
            tb[:len(pdu_bits_arr)] = pdu_bits_arr
            qm, _ = tables.dl_mcs_to_qm_itbs(mcs, t.table_256)
            mask = np.zeros(cell.n_prb, dtype=bool)
            mask[t.prb_start:t.prb_start + t.n_prb] = True
            pdsch_jobs.append((t.rnti, mask, qm, tb, t.rv))
            self.truth.append(dict(sf=len(self.subframes), sf_idx=sf_idx,
                                   rnti=t.rnti, tbs=tbs, mcs=mcs,
                                   pdu=t.mac_pdu))
        g = encoder.build_control_subframe(cell, sf_idx, self.cfi, tx_dcis)
        if with_pbch_sfn is not None and sf_idx == 0:
            encoder.add_pbch(g, cell, with_pbch_sfn)
        for (rnti, mask, qm, tb, rv) in pdsch_jobs:
            encoder.add_pdsch(g, cell, sf_idx, self.cfi, rnti, mask, qm, tb,
                              rv=rv)
        rxg = encoder.apply_channel(g, self.h, self.noise, self.rng)
        self.subframes.append(encoder.subframe_iq(cell, rxg)[0])
        # placed count = DECODABLE transport blocks (2-TB spatial-mux
        # DCIs on a 1-RX scenario emit a DCI but no recoverable PDSCH)
        return len(pdsch_jobs)

    def _nof_cce(self):
        from ltesniffer_tpu_torch.phy import grid as grid_mod
        return grid_mod.control_region(self.cell, self.cfi)[
            "nof_pdcch_regs"] // 9

    def stream(self) -> np.ndarray:
        return np.concatenate(self.subframes).astype(np.complex64)


@dataclasses.dataclass
class UlTx:
    """One scheduled UL transport block (DCI0 at t, PUSCH at t+4)."""
    rnti: int
    tb_bits: np.ndarray
    mcs: int = 6                 # QPSK region: all UL tables agree
    prb_start: int = 0
    n_prb: int = 8
    ndi: int = 1


class DualScenarioBuilder:
    """Dual-carrier UL-mode stream: the DL carrier carries the PDCCH with
    format-0 grants; each grant's PUSCH appears on the UL carrier 4
    subframes later (the reference's ULSchedule t+4 rule,
    `ULSchedule.cc:112`)."""

    def __init__(self, cell: CellConfig, cfi: int = 2, noise: float = 0.04,
                 ul_noise: float = 0.03, seed: int = 0):
        self.cell = cell
        self.cfi = cfi
        self.noise = noise
        self.ul_noise = ul_noise
        self.rng = np.random.default_rng(seed)
        self.h = encoder.flat_channel(cell, cell.nof_rx_ant, self.rng)
        self.dl_subframes: List[np.ndarray] = []
        self.ul_subframes: List[np.ndarray] = []
        self._pending: Dict[int, list] = {}   # stream index -> UL grants

    def _nof_cce(self):
        from ltesniffer_tpu_torch.phy import grid as grid_mod
        return grid_mod.control_region(self.cell, self.cfi)[
            "nof_pdcch_regs"] // 9

    def add_subframe(self, sf_idx: int, ul_txs: Sequence[UlTx] = (),
                     strict: bool = True) -> int:
        cell = self.cell
        j = len(self.dl_subframes)
        tx_dcis = []
        used_cce = set()
        placed = 0
        for t in ul_txs:
            qm, itbs = tables.ul_mcs_to_qm_itbs(t.mcs)
            tbs = tables.tbs_lookup(itbs, t.n_prb)
            cands = search_space.ue_candidates(t.rnti, sf_idx,
                                               self._nof_cce())
            loc = None
            for (l, nc) in cands:
                span = set(range(nc, nc + (1 << l)))
                if not span & used_cce:
                    loc = (l, nc)
                    used_cce.update(span)
                    break
            if loc is None:
                if strict:
                    raise ValueError("no free CCEs")
                continue
            d = dci_mod.Dci(fmt="0", rnti=t.rnti, fields=dict(
                flag0_1a=0, hopping=0,
                riv=ra.start_len_to_riv(t.prb_start, t.n_prb, cell.n_prb),
                mcs=t.mcs, ndi=t.ndi, tpc=0, dmrs_cs=2, cqi_request=0))
            tx_dcis.append(encoder.TxDci(dci=d, L=loc[0], ncce=loc[1]))
            tb = np.zeros(tbs, dtype=np.uint8)
            bits = np.asarray(t.tb_bits, dtype=np.uint8).reshape(-1)
            tb[:min(tbs, len(bits))] = bits[:tbs]
            self._pending.setdefault(j + 4, []).append(dict(
                rnti=t.rnti, prb_start=t.prb_start, n_prb=t.n_prb,
                qm=qm, tb_bits=tb, dmrs_field=2))
            placed += 1
        g = encoder.build_control_subframe(cell, sf_idx, self.cfi, tx_dcis)
        rxg = encoder.apply_channel(g, self.h, self.noise, self.rng)
        self.dl_subframes.append(encoder.subframe_iq(cell, rxg)[0])
        grants = self._pending.pop(j, [])
        if grants:
            ug = encoder.build_ul_subframe(cell, sf_idx, grants)
        else:
            ug = np.zeros((1, 14, cell.n_sc), np.complex64)
        un = ug + self.ul_noise / np.sqrt(2) * (
            self.rng.standard_normal(ug.shape)
            + 1j * self.rng.standard_normal(ug.shape))
        self.ul_subframes.append(
            encoder.ul_subframe_iq(cell, un.astype(np.complex64))[0])
        return placed

    def streams(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.concatenate(self.dl_subframes).astype(np.complex64),
                np.concatenate(self.ul_subframes).astype(np.complex64))
