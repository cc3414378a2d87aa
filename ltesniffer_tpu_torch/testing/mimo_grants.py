"""Seeded two-codeword grants for holding the eq/demap kernel
(`kernels/mimo_eq.py`) against its plain version: the variants, random
inputs of one grant, and the tolerance.

The variants cover TM3 and TM4, 2 and 4 ports, several PMIs, unequal
qm, n_re at a 256 boundary and just past one, and 1 and 2 receive
antennas.  Used by the CPU tests (`tests/test_torch_mimo_eq.py`), the
card-only tests (`tests/test_torch_cuda.py`) and `chip_smoke.py`
phase 2c.

Tolerance: rtol 1e-4 plus atol 5e-4 of the peak, as
`tests/test_torch_mimo.py` states for the decode's LLRs: the 2x2 MMSE
divides by det(H^H H + noise I), which amplifies rounding differences
(the constant-matrix products' sum order, a reciprocal multiply in place
of a division) on ill-conditioned REs.
"""
from __future__ import annotations

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod

RTOL, ATOL_PEAK = 1e-4, 5e-4
RE_BUCKET = 256          # sniffer/pdsch_rx.py's RE bucket

# (tm, ports, pmi, qm0, qm1, n_re, rx)
VARIANTS = [
    (4, 2, 0, 2, 2, 256, 2),
    (4, 2, 1, 4, 6, 257, 2),
    (4, 2, 2, 8, 2, 300, 2),
    (3, 2, 0, 2, 4, 256, 2),
    (3, 2, 0, 6, 8, 257, 2),
    (4, 4, 3, 4, 2, 256, 2),
    (4, 4, 9, 2, 6, 257, 2),
    (4, 4, 15, 8, 4, 511, 2),
    (3, 4, 0, 4, 4, 257, 2),
    (3, 4, 0, 2, 8, 512, 2),
    (4, 2, 1, 4, 4, 257, 1),
    (3, 4, 0, 2, 2, 256, 1),
]


def variant_id(v) -> str:
    tm, ports, pmi, qm0, qm1, n_re, rx = v
    return f"tm{tm}-p{ports}-pmi{pmi}-qm{qm0}{qm1}-n{n_re}-rx{rx}"


def random_grant(variant, seed: int = 0, n_sc: int = 72):
    """Seeded numpy inputs of one grant of `variant` on a grid of n_sc
    subcarriers: (grid (rx, 14 n_sc, 2), h (rx, ports, 14 n_sc, 2), noise
    f32, the padded (n_pad,) int64 RE index, [c_init0, c_init1])."""
    tm, ports, pmi, qm0, qm1, n_re, rx = variant
    L = 14 * n_sc
    rng = np.random.default_rng(1000 * seed + 97 * tm + 13 * ports + pmi
                                + 7 * n_re + rx)
    grid = rng.normal(size=(rx, L, 2)).astype(np.float32)
    h = rng.normal(size=(rx, ports, L, 2)).astype(np.float32)
    nv = np.float32(abs(rng.normal()) * 0.05 + 0.01)
    re = np.sort(rng.choice(L, n_re, replace=False)).astype(np.int64)
    n_pad = -(-n_re // RE_BUCKET) * RE_BUCKET
    idx = np.full(n_pad, re[-1], np.int64)
    idx[:n_re] = re
    rnti = int(rng.integers(1, 0xFFF4))
    ci = [pdsch_mod.scrambling_cinit(rnti, q, 3, 301) for q in (0, 1)]
    return grid, h, nv, idx, ci


def tensors(inp, device):
    """random_grant's arrays as the wrapper's tensors on `device`:
    (grid_flat, h_flat, noise_var 0-d, re_idx)."""
    grid, h, nv, idx, _ = inp
    return (torch.from_numpy(grid).to(device), torch.from_numpy(h).to(device),
            torch.tensor(nv).to(device), torch.from_numpy(idx).to(device))


def max_err(got, want):
    """(largest |got - want|, whether it is within the tolerance)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    if got.shape != want.shape:
        return float("inf"), False
    peak = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    ok = bool(np.all(np.abs(got - want)
                     <= ATOL_PEAK * peak + RTOL * np.abs(want)))
    return err, ok
