"""Seeded batches of single-layer PDSCH grants for holding the batched
eq/demap kernel (`kernels/pdsch_eq.py`) against its plain version: the
batches, their descriptor tables and the tolerance.

- "mixed": a 25-PRB cell, 4 subframes (indices 0, 5, 3, 1), grants of
  every qm and CFI on PRB lists (one at subframe 0 off the centre), on
  the centre PRBs of subframes 0 and 5 (one allocation twice), one with
  two slot masks, p_a of 1 and of -3 dB; any RX count and port count.
- "loaded": one batch of 32 subframes of the benchmark's loaded cell (100
  PRB, 2 ports, 12 grants of 8 PRB a subframe, qm 2, every third UE's on
  the 256QAM table; grants 5 and 6 cross the centre at subframes 0 and 5).
- "etm31": one batch of 32 subframes of its E-TM 3.1 cell (4 grants of 25
  PRB at 64QAM a subframe).
Grids, channels and noise are random: the comparison is of arithmetic.
Used by the CPU tests (`tests/test_torch_pdsch_eq.py`), the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py` phase 2f.

Tolerance: rtol 1e-6 plus atol 1e-6 of the peak.  The kernel follows the
plain version's operations one rounding each (no contraction under
--fmad=false, the demapper's reciprocal multiply as PyTorch does on the
card), so on the card it should give the same floats; the tolerance only
bounds what a difference of an ulp or two in a sum would give.
"""
from __future__ import annotations

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod, tables
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx

RTOL, ATOL_PEAK = 1e-6, 1e-6
PA = float(10.0 ** (-3.0 / 20.0))
MIXED_SFS = (0, 5, 3, 1)
MIXED_PRB = 25                 # centre PRBs 9-15

# (name, rx, ports) of the card's comparisons
VARIANTS = [("mixed", 1, 1), ("mixed", 1, 2), ("mixed", 1, 4),
            ("mixed", 2, 1), ("mixed", 2, 2), ("mixed", 2, 4),
            ("loaded", 1, 2), ("loaded", 2, 2), ("etm31", 1, 2)]


def variant_id(v) -> str:
    return f"{v[0]}-rx{v[1]}-p{v[2]}"


def _mask(n_prb, *ranges):
    m = np.zeros(n_prb, bool)
    for a, b in ranges:
        m[a:b] = True
    return m


def _mixed():
    """(b, qm, slot-0 mask, slot-1 mask or None, cfi, p_a) of "mixed"."""
    m = lambda *r: _mask(MIXED_PRB, *r)            # noqa: E731
    return [(2, 2, m((0, 4)), None, 2, 1.0),
            (0, 4, m((9, 15)), None, 2, 1.0),
            (2, 4, m((20, 25)), None, 1, PA),
            (1, 2, m((10, 14)), None, 2, PA),
            (2, 6, m((5, 6), (7, 8), (9, 10)), None, 3, 1.0),
            (0, 6, m((0, 5)), None, 2, 1.0),
            (2, 6, m((0, 3)), m((20, 23)), 2, 1.0),
            (3, 8, m((16, 19)), None, 2, 1.0),
            (1, 8, m((10, 14)), None, 2, 1.0),
            (3, 2, m((0, 25)), None, 1, PA)]


def _loaded():
    qm256 = tables.dl_mcs_to_qm_itbs(7, True)[0]
    out = []
    for b in range(32):
        for g in range(12):
            r = (b * 12 + g) % 148
            out.append((b, qm256 if r % 3 == 2 else 2,
                        _mask(100, (8 * g, 8 * g + 8)), None, 2, 1.0))
    return out


def _etm31():
    return [(b, 6, _mask(100, (25 * u, 25 * u + 25)), None, 2, 1.0)
            for b in range(32) for u in range(4)]


def batch(name: str, rx: int, ports: int, seed: int = 0):
    """(cell, grids, h, noise_var, jobs, re_of) of a seeded batch, as CPU
    tensors: grids (B, rx, 14, n_sc, 2), h (B, rx, ports, 14, n_sc, 2),
    noise_var (B,); jobs `pdsch_rx.GrantJob`s, re_of their REs."""
    grants, n_prb, sfs = {
        "mixed": (_mixed, MIXED_PRB, MIXED_SFS),
        "loaded": (_loaded, 100, tuple(b % 10 for b in range(32))),
        "etm31": (_etm31, 100, tuple(b % 10 for b in range(32)))}[name]
    cell = CellConfig(n_id_cell=301 + seed, n_prb=n_prb, nof_ports=ports,
                      nof_rx_ant=rx)
    rng = np.random.default_rng(
        [seed, rx, ports, ("mixed", "loaded", "etm31").index(name)])
    B, n_sc = len(sfs), cell.n_sc
    grids = rng.normal(size=(B, rx, 14, n_sc, 2)).astype(np.float32)
    h = rng.normal(size=(B, rx, ports, 14, n_sc, 2)).astype(np.float32)
    nv = (np.abs(rng.normal(size=B)) * 0.1 + 0.01).astype(np.float32)
    jobs = [pdsch_rx.GrantJob(b=b, sf_idx=sfs[b], cfi=cfi,
                              rnti=int(rng.integers(1, 0xFFF4)), prb_mask=m0,
                              qm=qm, tbs=1000, prb_mask_slot1=m1, pa=pa)
            for b, qm, m0, m1, cfi, pa in grants()]
    re_of = [pdsch_mod.grant_re_indices(cell, j.sf_idx, j.cfi, j.prb_mask,
                                        j.prb_mask_slot1) for j in jobs]
    return (cell, torch.from_numpy(grids), torch.from_numpy(h),
            torch.from_numpy(nv), jobs, re_of)


def table(cell, h, jobs, device):
    """(`pdsch_eq.Table`, RE table on `device` or None) of every job, in
    job order: the dispatch's own builder."""
    return pdsch_rx._eq_table(cell, int(h.shape[2]), jobs,
                              list(range(len(jobs))),
                              [pdsch_rx._src_of(cell, j) for j in jobs],
                              device)


def max_err(got, want):
    """(largest |got - want|, largest |got - want| / |want| over nonzero
    want, floats that differ, whether every float is within the
    tolerance)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    if got.shape != want.shape:
        return float("inf"), float("inf"), -1, False
    diff = np.abs(got.astype(np.float64) - want)
    peak = float(np.max(np.abs(want))) or 1.0
    nz = want != 0
    rel = float(np.max(diff[nz] / np.abs(want[nz]))) if nz.any() else 0.0
    ok = bool(np.all(diff <= ATOL_PEAK * peak + RTOL * np.abs(want)))
    return float(diff.max()) if diff.size else 0.0, rel, \
        int(np.count_nonzero(got != want)), ok
