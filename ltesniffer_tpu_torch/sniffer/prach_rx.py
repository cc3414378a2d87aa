"""PRACH preamble detection (36.211 5.7) — format 0, FDD.

Zadoff-Chu root correlation in the 1.25 kHz PRACH frequency grid: window the
preamble, FFT, extract the 839 PRACH bins, correlate against the configured
roots (conj multiply + 839-IFFT), detect cyclic-shift peaks -> preamble index
+ timing advance.  Replaces srsRAN `prach` as used for the reference's debug
PRACH output (`src/src/UL_Sniffer_PUSCH.cc:657-713`).

`detect` takes PHYSICAL roots; the SIB2 logical rootSequenceIndex is
translated by `phy.prach_roots` (Table 5.7.2-4) in `core._work_prach`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np

from ltesniffer_tpu_torch.phy.params import CellConfig

N_ZC = 839
T_SEQ = 0.0008          # format 0 sequence duration (s)
T_CP = 0.000103         # format 0 CP (~103 us)


def zc_root(u: int) -> np.ndarray:
    n = np.arange(N_ZC)
    return np.exp(-1j * np.pi * u * n * (n + 1) / N_ZC).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _geometry(srate: float, n_prb: int, prach_freq_offset: int):
    n_fft = int(round(srate * T_SEQ))            # 1.25 kHz bins
    # PRACH occupies 6 PRBs starting at prach_freq_offset; its center:
    # bins relative to band center (864 = 6 PRB * 12 sc * 12 (15k/1.25k))
    k0 = int((prach_freq_offset * 12 - n_prb * 6) * 12 + (864 - N_ZC) // 2 + 12)
    bins = (np.arange(N_ZC) + k0) % n_fft
    return n_fft, bins


def prach_tx(cell: CellConfig, u: int, shift: int,
             prach_freq_offset: int = 4) -> np.ndarray:
    """Synthesize a format-0 preamble at the cell sample rate (test side)."""
    srate = cell.srate
    n_fft, bins = _geometry(srate, cell.n_prb, prach_freq_offset)
    x = np.roll(zc_root(u), -shift)
    X = np.fft.fft(x) / np.sqrt(N_ZC)
    spec = np.zeros(n_fft, dtype=np.complex64)
    spec[bins] = X
    td = np.fft.ifft(spec) * np.sqrt(n_fft)
    cp = int(round(srate * T_CP))
    return np.concatenate([td[-cp:], td]).astype(np.complex64)


@dataclasses.dataclass
class PrachDetection:
    root: int
    preamble: int
    shift: int
    peak: float
    ta_samples: float


def detect(samples: np.ndarray, cell: CellConfig, roots: Sequence[int],
           n_cs: int = 13, prach_freq_offset: int = 4,
           threshold: float = 6.0) -> List[PrachDetection]:
    """Detect preambles in a window starting at the preamble sequence."""
    srate = cell.srate
    n_fft, bins = _geometry(srate, cell.n_prb, prach_freq_offset)
    if len(samples) < n_fft:
        return []
    Y = np.fft.fft(samples[:n_fft])[bins] / np.sqrt(n_fft)
    out: List[PrachDetection] = []
    n_shifts = N_ZC // n_cs if n_cs > 0 else 1
    for u in roots:
        Xu = np.fft.fft(zc_root(u)) / np.sqrt(N_ZC)
        z = np.fft.ifft(Y * np.conj(Xu)) * np.sqrt(N_ZC)
        p = np.abs(z) ** 2
        noise = np.median(p) + 1e-12
        for pi in range(n_shifts):
            # preamble v=pi (shift C_v = pi*n_cs) peaks at (N_zc - C_v + d):
            base = (N_ZC - pi * n_cs) % N_ZC
            idx = (base + np.arange(n_cs)) % N_ZC
            w = p[idx]
            j = int(np.argmax(w))
            if w[j] > threshold * noise:
                out.append(PrachDetection(
                    root=u, preamble=pi, shift=pi * n_cs,
                    peak=float(w[j] / (np.median(p) + 1e-12)),
                    ta_samples=float(j) * n_fft / N_ZC))
    return out
