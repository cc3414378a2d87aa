"""One general generator for every traffic mix of `sniffbench/traffic/`.

A mix file gives a block length and, per subframe, groups of grants: a DCI
format, how many grants of it each subframe carries, the pool of UEs they
rotate over, their size in PRBs, MCS classes, the share of UEs on the
256QAM MCS table, and the payload kind.  The cell (bandwidth, ports, RX
antennas, cell id, CFI) comes from the configuration file.

Generation is in two steps.  `schedule` walks the block in order and fixes
every subframe's grants: RNTI, PRBs, HARQ process, NDI, MCS and the DCI's
place in the control region (first free candidate of the UE's search
space, as a scheduler under CCE contention would do; a grant that finds
no free candidate is dropped).  It draws nothing at random.
`encode_subframe` then builds one subframe from its plan alone, with the
random draws (payloads, channel, noise) taken from (seed, subframe index),
so subframes can be built in any order and on any number of processes and
still give the same block.  The channel of a mix with ``"channel":
"static"`` is drawn once from the seed; ``"none"`` is a cabled link (every
RX antenna takes every port at gain 1, as a conformance test's antenna
connector), with the mix's noise alone.

The two mixes this copies are the port's `testing/loaded_cell.py`
(`bench.py:build_stream`) and `testing/mimo_cell.py`; the draws differ
from theirs (they draw from one sequential stream), the work does not.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import tx
from .lte import dci as dci_mod, grid as grid_mod, ra, search_space, tables
from .lte.params import CellConfig, N_SYM_SF

CHANNEL_STREAM = 1 << 40     # seed-sequence word of the static channel's draws


def cell_of(config: dict) -> CellConfig:
    return CellConfig(n_id_cell=config["n_id_cell"], n_prb=config["n_prb"],
                      nof_ports=config["nof_ports"],
                      nof_rx_ant=config["nof_rx_ant"],
                      phich_resources=config.get("phich_resources", 1.0),
                      phich_length=config.get("phich_length", 0))


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Grant:
    """One placed DCI and what its PDSCH carries."""
    fmt: str
    rnti: int
    L: int                   # aggregation exponent
    ncce: int
    prb_start: int
    n_prb: int
    harq_pid: int
    ndi: int
    mcs: Tuple[int, ...]     # per codeword
    table_256: bool
    pmi: int = 0
    pdsch: bool = True
    payload: str = "random_bits"   # or "mac_sdu": one SDU, zero padding;
    #                                or "mac_fill": one SDU filling the block
    sdu_bytes: int = 0             # "mac_sdu": the SDU's length


def _rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *words])


def _bitmap(cell: CellConfig, prb_start: int, n_prb: int) -> int:
    """Type-0 RBG bitmap covering [prb_start, prb_start + n_prb)."""
    P = tables.rbg_size(cell.n_prb)
    n_rbg = -(-cell.n_prb // P)
    bm = 0
    for rbg in range(prb_start // P, min(-(-(prb_start + n_prb) // P),
                                          n_rbg)):
        bm |= 1 << (n_rbg - 1 - rbg)
    return bm


def _place(rnti: int, sf: int, nof_cce: int, used: set,
           levels: Optional[List[int]]):
    """First free UE-specific candidate, in the search space's order or
    with aggregation levels in `levels` order; None if none is free."""
    cands = search_space.ue_candidates(rnti, sf, nof_cce)
    order = ([c for want in levels for c in cands if c[0] == want]
             if levels else cands)
    for l, nc in order:
        span = set(range(nc, nc + (1 << l)))
        if not span & used:
            used.update(span)
            return l, nc
    return None


def _fit_mcs(pdu_bits: int, n_prb: int) -> int:
    """Smallest 64QAM-table MCS whose TBS holds the PDU."""
    for mcs in range(29):
        _qm, itbs = tables.dl_mcs_to_qm_itbs(mcs)
        if itbs >= 0 and tables.tbs_lookup(itbs, n_prb) >= pdu_bits:
            return mcs
    raise ValueError("PDU too large for the allocation")


def _sdu_cap(group: dict) -> Optional[int]:
    m256 = group.get("mcs256")
    if m256 is None:
        return None
    _qm, itbs = tables.dl_mcs_to_qm_itbs(m256[0], True)
    return tables.tbs_lookup(itbs, group["n_prb"]) // 8 - 2


def schedule(config: dict, mix: dict) -> List[List[Grant]]:
    """The block's grants, subframe by subframe."""
    cell = cell_of(config)
    cfi = config["cfi"]
    nof_cce = grid_mod.control_region(cell, cfi)["nof_pdcch_regs"] // 9
    period = mix["harq_period_sf"]
    ndi: Dict[tuple, int] = {}
    out = []
    for j in range(mix["block_sf"]):
        sf = j % 10
        used: set = set()
        prb = 0
        grants = []
        for group in mix["groups"]:
            fmt = group["fmt"]
            n_per = group["per_sf"]
            cap = _sdu_cap(group)
            for g in range(n_per):
                idx = (j * n_per + g) % group["ues"]
                rnti = group["rnti0"] + idx
                prb_start, prb = prb, prb + group["n_prb"]
                pid = (j // period) % 8
                if group.get("ndi") == "fixed0":
                    nd = 0
                else:
                    nd = ndi[(rnti, pid)] = ndi.get((rnti, pid), 1) ^ 1
                pos = _place(rnti, sf, nof_cce, used, group.get("levels"))
                if pos is None:
                    continue
                mod = group.get("table256_mod")
                on256 = bool(mod) and idx % mod[0] == mod[1]
                payload = group.get("payload", "random_bits")
                sdu = 0
                if payload == "mac_sdu":
                    sizes = group["sdu_bytes"]
                    sdu = sizes[g % len(sizes)]
                    sdu = min(sdu, cap) if cap is not None else sdu
                if on256:
                    mcs = tuple(group["mcs256"])
                elif group["mcs"] == "fit":
                    mcs = (_fit_mcs(8 * (sdu + 1), group["n_prb"]),)
                else:
                    classes = group["mcs"]
                    mcs = tuple(classes[idx % len(classes)])
                grants.append(Grant(
                    fmt=fmt, rnti=rnti, L=pos[0], ncce=pos[1],
                    prb_start=prb_start, n_prb=group["n_prb"],
                    harq_pid=pid, ndi=nd, mcs=mcs, table_256=on256,
                    pmi=(j + g) % 3 if fmt == "2" else 0,
                    pdsch=group.get("pdsch", True), payload=payload,
                    sdu_bytes=sdu))
        out.append(grants)
    return out


def _dci_of(cell: CellConfig, gr: Grant) -> dci_mod.Dci:
    if gr.fmt == "1A":
        return dci_mod.Dci(fmt="1A", rnti=gr.rnti, fields=dict(
            flag0_1a=1, vrb_flag=0,
            riv=ra.start_len_to_riv(gr.prb_start, gr.n_prb, cell.n_prb),
            mcs=gr.mcs[0], harq_pid=gr.harq_pid, ndi=gr.ndi, rv=0, tpc=0))
    fields = dict(bitmap=_bitmap(cell, gr.prb_start, gr.n_prb), tpc=0,
                  harq_pid=gr.harq_pid, tb_swap=0, mcs=gr.mcs[0],
                  ndi=gr.ndi, rv=0, mcs2=gr.mcs[1], ndi2=gr.ndi, rv2=0)
    if cell.n_prb > 10:
        fields["ra_header"] = 0
    if gr.fmt == "2":
        fields["precoding"] = gr.pmi
    return dci_mod.Dci(fmt=gr.fmt, rnti=gr.rnti, fields=fields)


def static_channel(config: dict, mix: dict, seed: int) -> Optional[np.ndarray]:
    """The block's one channel, or None where each subframe draws its own."""
    cell = cell_of(config)
    kind = mix.get("channel", "per_subframe")
    if kind == "none":
        return np.ones((cell.nof_rx_ant, cell.nof_ports, N_SYM_SF,
                        cell.n_sc), np.complex64)
    if kind == "static":
        return tx.flat_channel(cell, cell.nof_rx_ant,
                               _rng(seed, CHANNEL_STREAM))
    if kind != "per_subframe":
        raise ValueError(f"unknown channel {kind!r}")
    return None


def encode_subframe(config: dict, mix: dict, j: int, grants: List[Grant],
                    seed: int, h_static: Optional[np.ndarray] = None):
    """-> ((RX, sf_len) complex64 IQ, truth of subframe j).

    The truth: every placed DCI as (rnti, format, L, ncce), and every
    transport block as dict(rnti, cw, fmt, tbs, payload bytes)."""
    cell = cell_of(config)
    cfi = config["cfi"]
    sf = j % 10
    rng = _rng(seed, j)
    mask = np.zeros(cell.n_prb, bool)
    tx_dcis, tbs_out, jobs = [], [], []
    for gr in grants:
        tx_dcis.append(tx.TxDci(dci=_dci_of(cell, gr), L=gr.L, ncce=gr.ncce))
        if not gr.pdsch:
            continue
        m = mask.copy()
        m[gr.prb_start:gr.prb_start + gr.n_prb] = True
        bits_cw = []
        for cw, mcs in enumerate(gr.mcs):
            qm, itbs = tables.dl_mcs_to_qm_itbs(mcs, gr.table_256)
            tbs = tables.tbs_lookup(itbs, gr.n_prb)
            if gr.payload in ("mac_sdu", "mac_fill"):
                n = gr.sdu_bytes if gr.payload == "mac_sdu" else tbs // 8 - 1
                sdu = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                pdu = tx.mac_pdu_one_sdu(3, sdu)
                tb = np.zeros(tbs, np.uint8)
                pb = np.unpackbits(np.frombuffer(pdu, np.uint8))
                tb[:len(pb)] = pb
            else:
                tb = rng.integers(0, 2, tbs).astype(np.uint8)
            bits_cw.append((qm, tb))
            tbs_out.append(dict(rnti=gr.rnti, cw=cw, fmt=gr.fmt, tbs=tbs,
                                payload=np.packbits(tb).tobytes()))
        jobs.append((gr, m, bits_cw))
    g = tx.build_control_subframe(cell, sf, cfi, tx_dcis)
    if sf == 0 and mix.get("pbch", True):
        tx.add_pbch(g, cell, (j // 10) % 1024)
    for gr, m, bits_cw in jobs:
        if len(bits_cw) == 1:
            tx.add_pdsch(g, cell, sf, cfi, gr.rnti, m, bits_cw[0][0],
                         bits_cw[0][1])
        else:
            tx.add_pdsch_mimo(g, cell, sf, cfi, gr.rnti, m,
                              tuple(b[0] for b in bits_cw),
                              [b[1] for b in bits_cw],
                              tm=3 if gr.fmt == "2A" else 4, pmi=gr.pmi)
    h = h_static if h_static is not None else tx.flat_channel(
        cell, cell.nof_rx_ant, rng)
    iq = tx.subframe_iq(cell, tx.apply_channel(g, h, mix["noise"], rng))
    truth = dict(dcis=[(gr.rnti, gr.fmt, gr.L, gr.ncce) for gr in grants],
                 tbs=tbs_out)
    return iq, truth

