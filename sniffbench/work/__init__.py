"""The least work the cells' inputs need, by the frozen arithmetic of the
port's kernels (copied from `kernels/turbo_decode.py` `bytes_moved` /
`ops` and `kernels/viterbi.py` `bytes_moved` / `ops`), counted from what
the transmitter sent and the configuration's search space, never from
what the program launched.  A share of the roofline is the least time
(the larger of operations over peak FLOP/s and bytes over peak bytes/s)
over the device time of the kernels that do the work.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Tuple

from sniffbench.gen import mix as mix_mod
from sniffbench.gen.lte import dci as dci_mod, grid as grid_mod
from sniffbench.gen.lte import search_space, turbo as turbo_mod

TURBO_OPS_PER_STEP = 107     # float32 operations per trellis step and pass
VITERBI_OPS_PER_STEP = 2 * 4 + 128 + 64 + 63 + 64
SEARCH_WRAP = 32             # the search entry's tail-biting wrap


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def least_seconds(ops: float, nbytes: float) -> float:
    p = peaks()
    return max(ops / p["float32_flops"], nbytes / p["hbm_bytes_per_s"])


# --- turbo decode (kernels/turbo_decode.py) -------------------------------
def turbo_bytes(K: int, B: int) -> int:
    """d_llrs (B, 3, K+4) f32 read once, llr (B, K) f32 and bits (B, K) u8
    written once."""
    return B * 3 * (K + 4) * 4 + B * K * 4 + B * K


def turbo_ops(K: int, B: int, n_iter: int) -> int:
    """OPS_PER_STEP per trellis step of each of the 2 n_iter constituent
    passes, and the final LLR's two adds."""
    return TURBO_OPS_PER_STEP * 2 * n_iter * K * B + 2 * K * B


def code_blocks(tbs: int) -> Iterable[int]:
    """The code block sizes K of a transport block of `tbs` bits
    (36.212 5.1.2)."""
    return turbo_mod.segment_sizes(tbs).K


def turbo_least_seconds(tbs_sizes: Iterable[int], n_iter: int) -> float:
    """Least time of one decode of every code block of these transport
    blocks at `n_iter` iterations."""
    ops = nbytes = 0
    for tbs in tbs_sizes:
        for K in code_blocks(tbs):
            ops += turbo_ops(K, 1, n_iter)
            nbytes += turbo_bytes(K, 1)
    return least_seconds(ops, nbytes)


# --- the blind search's tail-biting Viterbi (kernels/viterbi.py) ----------
def viterbi_ops(shapes: Iterable[Tuple[int, int]], wrap: int) -> int:
    """OPS_PER_STEP for each of a codeword's own D + 2 min(wrap, D) steps,
    over groups of (N codewords, D)."""
    return VITERBI_OPS_PER_STEP * sum(n * (d + 2 * min(wrap, d))
                                      for n, d in shapes)


def search_space_of(config: dict) -> dict:
    """Per subframe: the blind search's locations over the CFI's control
    region and the distinct coded lengths D (payload + 16 CRC bits) of
    the DCI formats."""
    cell = mix_mod.cell_of(config)
    reg = grid_mod.control_region(cell, config["cfi"])
    nof_cce = reg["nof_pdcch_regs"] // 9
    locs = search_space.all_locations(nof_cce)
    sizes = dci_mod.format_sizes(cell)
    ds = sorted({sizes[f] + 16 for f in dci_mod.FORMATS})
    return dict(n_loc=len(locs), ds=ds, nof_cce=nof_cce,
                n_bits=8 * reg["nof_pdcch_regs"])


def search_least_seconds(config: dict, n_subframes: int) -> float:
    """Least time of one tail-biting decode of every candidate of the
    search space, over n_subframes subframes: the operations bound; the
    bytes are the control region's LLRs read once and every codeword's
    three words written once."""
    s = search_space_of(config)
    n = n_subframes * s["n_loc"]
    ops = viterbi_ops([(n, d) for d in s["ds"]], SEARCH_WRAP)
    nbytes = n_subframes * 4 * s["n_bits"] + 12 * n * len(s["ds"])
    return least_seconds(ops, nbytes)
