"""DCI format definitions: sizes, field layouts, pack/unpack (36.212 5.3.3).

Covers the reference's 9 blind-searched formats 0, 1, 1A, 1B, 1C, 1D, 2, 2A,
2B (`src/src/DCISearch.cc:84-95`) for FDD, no carrier aggregation / CIF.

Sizes implement the spec padding rules: format 0 padded up to format 1A,
format 1 bumped off the 0/1A size, and every format bumped off the ambiguous
sizes {12,14,16,20,24,26,32,40,44,56} (36.212 Table 5.3.3.1.2-1).
Verified sizes for 50 PRB / 2 ports: 0/1A=27, 1=31, 1B=29, 1C=13, 1D=29,
2=43, 2A=40->41?  (see tests for the full matrix).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

from . import ra, tables
from .params import CellConfig

AMBIGUOUS_SIZES = frozenset({12, 14, 16, 20, 24, 26, 32, 40, 44, 56})

FORMATS = ("0", "1", "1A", "1B", "1C", "1D", "2", "2A", "2B")
DL_FORMATS = ("1", "1A", "1B", "1C", "1D", "2", "2A", "2B")


def _n_rbg(n_prb: int) -> int:
    return -(-n_prb // tables.rbg_size(n_prb))


def _fields(fmt: str, cell: CellConfig) -> List[Tuple[str, int]]:
    """Raw field layout (name, nbits) before padding."""
    N = cell.n_prb
    riv = ra.riv_nbits(N)
    ports = cell.nof_ports
    tpmi = 2 if ports <= 2 else 4
    if fmt == "0":
        return [("flag0_1a", 1), ("hopping", 1), ("riv", riv), ("mcs", 5),
                ("ndi", 1), ("tpc", 2), ("dmrs_cs", 3), ("cqi_request", 1)]
    if fmt == "1A":
        return [("flag0_1a", 1), ("vrb_flag", 1), ("riv", riv), ("mcs", 5),
                ("harq_pid", 3), ("ndi", 1), ("rv", 2), ("tpc", 2)]
    if fmt == "1":
        f = []
        if N > 10:
            f.append(("ra_header", 1))
        f += [("bitmap", _n_rbg(N)), ("mcs", 5), ("harq_pid", 3), ("ndi", 1),
              ("rv", 2), ("tpc", 2)]
        return f
    if fmt == "1B":
        return [("vrb_flag", 1), ("riv", riv), ("mcs", 5), ("harq_pid", 3),
                ("ndi", 1), ("rv", 2), ("tpc", 2), ("tpmi", tpmi),
                ("pmi_confirm", 1)]
    if fmt == "1C":
        f = []
        if N >= 50:
            f.append(("gap", 1))
        step = 2 if N < 50 else 4
        ngap = tables.n_gap1(N)
        n_vrb_p = (2 * min(ngap, N - ngap)) // step
        f += [("riv", ra.riv_nbits(n_vrb_p)), ("mcs", 5)]
        return f
    if fmt == "1D":
        return [("vrb_flag", 1), ("riv", riv), ("mcs", 5), ("harq_pid", 3),
                ("ndi", 1), ("rv", 2), ("tpc", 2), ("tpmi", tpmi),
                ("dl_power_offset", 1)]
    if fmt in ("2", "2A", "2B"):
        f = []
        if N > 10:
            f.append(("ra_header", 1))
        f += [("bitmap", _n_rbg(N)), ("tpc", 2), ("harq_pid", 3)]
        if fmt == "2B":
            f.append(("scrambling_id", 1))
        else:
            f.append(("tb_swap", 1))
        f += [("mcs", 5), ("ndi", 1), ("rv", 2),
              ("mcs2", 5), ("ndi2", 1), ("rv2", 2)]
        if fmt == "2":
            f.append(("precoding", 3 if ports <= 2 else 6))
        elif fmt == "2A" and ports == 4:
            f.append(("precoding", 2))
        return f
    raise ValueError(fmt)


@functools.lru_cache(maxsize=32)
def format_sizes(cell: CellConfig) -> Dict[str, int]:
    """Final (padded) DCI payload sizes for every format."""
    raw = {f: sum(n for _, n in _fields(f, cell)) for f in FORMATS}
    # format 1A: bump off ambiguous sizes
    s1a = raw["1A"]
    while s1a in AMBIGUOUS_SIZES:
        s1a += 1
    # format 0 padded up to 1A (0 is never longer for equal UL/DL bw)
    s0 = max(raw["0"], s1a)
    sizes = {"0": s0, "1A": s1a}
    for f in ("1", "2", "2A", "2B", "1B", "1D"):
        s = raw[f]
        while s in AMBIGUOUS_SIZES or s == s1a:
            s += 1
        sizes[f] = s
    sizes["1C"] = raw["1C"]
    return sizes


@dataclasses.dataclass
class Dci:
    fmt: str
    rnti: int
    fields: Dict[str, int]

    def __getitem__(self, k):
        return self.fields.get(k, 0)


def pack(dci: Dci, cell: CellConfig) -> np.ndarray:
    """DCI -> payload bits (without CRC)."""
    layout = _fields(dci.fmt, cell)
    total = format_sizes(cell)[dci.fmt]
    bits = []
    for name, n in layout:
        v = dci.fields.get(name, 0)
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))
    bits.extend([0] * (total - len(bits)))
    return np.array(bits, dtype=np.uint8)


def unpack(bits: np.ndarray, fmt: str, cell: CellConfig, rnti: int = 0) -> Dci:
    """Payload bits -> DCI fields.  For format 0/1A pass fmt after resolving
    the flag bit (bit 0): 0 -> format 0, 1 -> format 1A."""
    layout = _fields(fmt, cell)
    fields = {}
    i = 0
    for name, n in layout:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(bits[i])
            i += 1
        fields[name] = v
    return Dci(fmt=fmt, rnti=rnti, fields=fields)


# ---------------------------------------------------------------------------
# DCI -> grant interpretation (the sniffer's trace layer)
# ---------------------------------------------------------------------------
