"""Downlink mode: `LTESnifferCore.run_packed` on 8-bit packed IQ words,
judged by `reference.compare` (accepted DCIs, transport blocks and their
payloads, MAC-LTE pcap records)."""
from __future__ import annotations

from array import array
from typing import List

from sniffbench.gen import block
from sniffbench.reference import compare as _compare

PHASES = ("_phase1_chunk", "_phase2", "_phase3", "_phase4", "_phase5")
compare = _compare.compare


def build_input(config: dict, mix: dict, seed: int, workers: int, n_sf):
    words, scales, truth = block.build(config, mix, seed, workers=workers,
                                       n_sf=n_sf)
    return (words, scales), truth


def make_core(config: dict, device: str, pcap_path: str):
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer.core import LTESnifferCore, SnifferConfig
    c = config
    return LTESnifferCore(SnifferConfig(
        cell=CellConfig(n_id_cell=c["n_id_cell"], n_prb=c["n_prb"],
                        nof_ports=c["nof_ports"], nof_rx_ant=c["nof_rx_ant"],
                        phich_resources=c.get("phich_resources", 1.0),
                        phich_length=c.get("phich_length", 0)),
        device=device, pcap_path=pcap_path))


def call(core, inputs, sf_idx0: int):
    words, scales = inputs
    core.run_packed(words, scales, sf_idx0=sf_idx0)


class Recorder:
    """Each resolved subframe's accepted DCIs as flat (TTI, RNTI, format
    code) integers, so the window keeps no object of its own alive; the
    transport blocks are the program's own `core.results`."""

    def __init__(self, core):
        self.core = core
        self.dci = array("q")
        self.fmts: dict = {}
        self.marks: List[tuple] = []
        fmts, dci = self.fmts, self.dci

        def hook(d):
            tti = d["sfn"] * 10 + d["sf"]
            for a in d["accepted"]:
                f = fmts.get(a.fmt)
                if f is None:
                    f = fmts[a.fmt] = len(fmts)
                dci.extend((tti, a.rnti, f))
        core.on_subframe = hook

    def start_call(self, k: int):
        self.marks.append((k, len(self.dci), len(self.core.results)))

    def calls(self) -> List[dict]:
        name = {v: k for k, v in self.fmts.items()}
        res = self.core.results
        ends = [m[1:] for m in self.marks[1:]] + [(len(self.dci), len(res))]
        out = []
        for (k, d0, r0), (d1, r1) in zip(self.marks, ends):
            d = self.dci[d0:d1]
            out.append(dict(
                c=k,
                dcis=[(d[i], [(d[i + 1], name[d[i + 2]])])
                      for i in range(0, len(d), 3)],
                results=[(r.dci.sfn * 10 + r.dci.sf_idx, r.dci.rnti,
                          bool(r.crc_ok), r.payload) for r in res[r0:r1]]))
        return out


def work_tbs(truth) -> List[int]:
    return [tb["tbs"] for t in truth for tb in t["tbs"]]
