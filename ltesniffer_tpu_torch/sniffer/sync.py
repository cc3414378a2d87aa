"""PSS/SSS cell search, timing acquisition and CFO estimation (host numpy).

Counterpart of `ltesniffer_tpu/sniffer/sync.py`, which computes in numpy
as well: every float operation is kept in the reference's order, so the
tracker's integer decisions (peak index, drift, the re-acquire candidate)
come out equal.  Replaces the srsRAN `ue_sync`/cell-search surface used by
the reference (`srsran_ue_sync_zerocopy` at `src/src/LTESniffer_Core.cc:365`,
`rf_search_and_decode_mib` at `:196`): FFT-based PSS matched filtering over
the three Zadoff-Chu roots, coherent SSS detection (one (336 x 62) matmul
over all N_ID_1 x {sf0, sf5} hypotheses), fractional CFO from the PSS
half-symbol phase, and a per-subframe tracker for stream framing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ltesniffer_tpu_torch.phy import params, sequences
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.kernels import ofdm


@functools.lru_cache(maxsize=8)
def pss_time_replicas(n_fft: int) -> np.ndarray:
    """(3, n_fft) time-domain PSS replicas (unit energy)."""
    out = np.zeros((3, n_fft), dtype=np.complex64)
    n_sc_used = 62
    for r in range(3):
        spec = np.zeros(n_fft, dtype=np.complex64)
        d = sequences.pss_sequence(r)
        # center 62 subcarriers around DC (DC unused)
        for i, f in enumerate(range(-31, 0)):
            spec[n_fft + f] = d[i]
        for i, f in enumerate(range(1, 32)):
            spec[f] = d[31 + i]
        td = np.fft.ifft(spec)
        out[r] = (td / np.linalg.norm(td)).astype(np.complex64)
    return out


@dataclasses.dataclass
class PssDetection:
    offset: int          # sample index of the PSS symbol's data part
    n_id_2: int
    peak: float          # normalized correlation peak (0..1)
    cfo: float           # fractional CFO in subcarrier units


def find_pss(samples: np.ndarray, n_fft: int) -> PssDetection:
    """Search a sample window for the strongest PSS occurrence."""
    reps = pss_time_replicas(n_fft)
    N = len(samples)
    L = 1 << int(np.ceil(np.log2(N + n_fft)))
    X = np.fft.fft(samples, L)
    best = None
    for r in range(3):
        R = np.fft.fft(reps[r], L)
        corr = np.fft.ifft(X * np.conj(R))[:N - n_fft + 1]
        mag = np.abs(corr)
        i = int(np.argmax(mag))
        # normalize by local energy
        e = np.linalg.norm(samples[i:i + n_fft]) + 1e-12
        score = mag[i] / e
        if best is None or score > best[0]:
            best = (float(score), i, r)
    score, off, nid2 = best
    # fractional CFO: phase between correlations of the two replica halves
    half = n_fft // 2
    rep = reps[nid2]
    c1 = np.vdot(rep[:half], samples[off:off + half])
    c2 = np.vdot(rep[half:], samples[off + half:off + n_fft])
    cfo = float(np.angle(c2 * np.conj(c1)) / np.pi / 2.0 * 2.0)  # subcarriers
    return PssDetection(offset=off, n_id_2=nid2, peak=score, cfo=cfo)


def sss_detect(samples: np.ndarray, pss: PssDetection, n_fft: int):
    """Detect N_ID_1 and frame half from the symbol preceding the PSS.

    Returns (n_id_1, is_subframe5, score).
    """
    cp = params.cp_lengths(n_fft)[1]  # SSS is a non-first symbol (normal CP)
    sss_start = pss.offset - (n_fft + cp)
    if sss_start < 0:
        return None
    def fft62(start):
        td = samples[start:start + n_fft]
        spec = np.fft.fft(td)
        return np.concatenate([spec[n_fft - 31:], spec[1:32]])
    y_sss = fft62(sss_start)
    y_pss = fft62(pss.offset)
    h = y_pss * np.conj(sequences.pss_sequence(pss.n_id_2))
    # coherent combining; normalize channel
    x = y_sss * np.conj(h) / (np.abs(h) ** 2 + 1e-9)
    rows = np.stack([
        sequences.sss_sequence(n1, pss.n_id_2, s5)
        for n1 in range(168) for s5 in (False, True)])
    corr = rows @ np.real(x) / (np.linalg.norm(np.real(x)) + 1e-12)
    i = int(np.argmax(np.abs(corr)))
    return i // 2, bool(i % 2), float(np.abs(corr[i]) / np.sqrt(62))


@dataclasses.dataclass
class CellSearchResult:
    n_id_cell: int
    is_subframe5: bool
    subframe_offset: int     # sample index where that subframe starts
    cfo: float               # subcarrier units
    peak: float


def find_cell(samples: np.ndarray, n_fft: int) -> Optional[CellSearchResult]:
    """Full cell search over a window (>= 5 ms of samples)."""
    pss = find_pss(samples, n_fft)
    if pss.peak < 0.3:
        return None
    det = sss_detect(samples, pss, n_fft)
    if det is None:
        return None
    n_id_1, is_sf5, score = det
    starts = ofdm.symbol_starts(n_fft)
    sf_start = pss.offset - starts[6]
    return CellSearchResult(
        n_id_cell=3 * n_id_1 + pss.n_id_2,
        is_subframe5=is_sf5,
        subframe_offset=sf_start,
        cfo=pss.cfo,
        peak=pss.peak)


def correct_cfo(samples: np.ndarray, cfo_subcarriers: float, n_fft: int) -> np.ndarray:
    """Mix down a fractional CFO (in subcarrier units)."""
    n = np.arange(len(samples))
    rot = np.exp(-2j * np.pi * cfo_subcarriers * n / n_fft)
    return (samples * rot).astype(np.complex64)


class SubframeTracker:
    """Frames a continuous stream into subframes, tracking timing via PSS.

    Offline-replay equivalent of srsRAN ue_sync's stream alignment
    (`srsran_ue_sync_zerocopy`, `LTESniffer_Core.cc:365`):

    * every PSS-bearing subframe (sf 0 and 5) the tracker re-correlates
      the cell's PSS replica in a +-`track_win` window around its expected
      position and corrects integer sample drift;
    * fractional CFO from each PSS hit feeds a running mixer;
    * `track_win` misses count as sync losses; after `max_losses`
      consecutive misses the tracker re-acquires with a full-window PSS
      search (the offline analog of the reference's 5-loss -> DECODE_MIB
      fallback, `LTESniffer_Core.cc:506-525`) and flags the event so the
      core can re-acquire the SFN from the MIB.
    """

    def __init__(self, cell: CellConfig, start_offset: int, sf_idx0: int,
                 cfo: float = 0.0, track_win: int = 32,
                 peak_threshold: float = 0.25, max_losses: int = 5):
        self.cell = cell
        self.offset = start_offset
        self.sf_idx = sf_idx0
        self.cfo = cfo
        self.track_win = track_win
        self.peak_threshold = peak_threshold
        self.max_losses = max_losses
        self.consecutive_losses = 0
        self.resyncs = 0           # full re-acquisitions performed
        self.drift_corrections = 0
        self.sync_lost = False     # set while re-acquired timing is fresh:
        #                            the consumer must re-acquire the SFN
        self._rep = pss_time_replicas(cell.n_fft)[cell.n_id_cell % 3]
        self._pss_sym_off = ofdm.symbol_starts(cell.n_fft)[6]
        self._cfo_obs: list = []

    # -- internals -----------------------------------------------------
    def _pss_metric(self, seg: np.ndarray) -> float:
        e = np.linalg.norm(seg) + 1e-12
        return float(np.abs(np.vdot(self._rep, seg)) / e)

    def _recorrelate(self, samples: np.ndarray, pos: int):
        """Track PSS around its expected spot; returns drift or None."""
        n_fft = self.cell.n_fft
        exp = pos + self._pss_sym_off
        w = self.track_win
        lo = max(exp - w, 0)
        hi = min(exp + w, len(samples) - n_fft)
        if hi <= lo:
            return None
        win = samples[lo:hi + n_fft]
        corr = np.abs(np.correlate(win, self._rep, mode="valid"))
        i = int(np.argmax(corr))
        seg = win[i:i + n_fft]
        if self._pss_metric(seg) < self.peak_threshold:
            return None
        # fractional CFO from the two replica halves: an observation of the
        # residual left after this chunk's mixer (averaged at chunk end —
        # every hit in the chunk measures the same residual)
        half = n_fft // 2
        c1 = np.vdot(self._rep[:half], seg[:half])
        c2 = np.vdot(self._rep[half:], seg[half:])
        self._cfo_obs.append(float(np.angle(c2 * np.conj(c1))
                                   / (2.0 * np.pi)))
        return (lo + i) - exp

    def _reacquire(self, samples: np.ndarray, pos: int) -> Optional[int]:
        """Full-window search after sync loss; returns new subframe start
        position (>= pos) or None if the stream has no usable PSS left.

        Takes the EARLIEST strong PSS of the cell's own root (not the
        window argmax) so as few subframes as possible are lost."""
        n_fft = self.cell.n_fft
        window = np.asarray(samples[pos:pos + 12 * self.cell.sf_len])
        if len(window) < 2 * self.cell.sf_len:
            return None
        corr = np.abs(np.correlate(window, self._rep, mode="valid"))
        peak = float(corr.max())
        if peak <= 0:
            return None
        # earliest index within 60% of the global max that verifies
        cands = np.nonzero(corr > 0.6 * peak)[0]
        for i in map(int, cands):
            seg = window[i:i + n_fft]
            if self._pss_metric(seg) < max(self.peak_threshold, 0.15):
                continue
            det = PssDetection(offset=i, n_id_2=self.cell.n_id_cell % 3,
                               peak=1.0, cfo=0.0)
            sss = sss_detect(window, det, n_fft)
            if sss is None:
                continue
            n_id_1, is_sf5, _ = sss
            if 3 * n_id_1 + det.n_id_2 != self.cell.n_id_cell:
                continue
            half = n_fft // 2
            c1 = np.vdot(self._rep[:half], seg[:half])
            c2 = np.vdot(self._rep[half:], seg[half:])
            self._cfo_obs.append(float(np.angle(c2 * np.conj(c1))
                                       / (2.0 * np.pi)))
            self.sf_idx = 5 if is_sf5 else 0
            self.sync_lost = True
            self.resyncs += 1
            self.consecutive_losses = 0
            new_pos = pos + i - self._pss_sym_off
            return new_pos if new_pos >= 0 else None
        return None

    # -- main loop -------------------------------------------------------
    def frames(self, samples: np.ndarray, aux: np.ndarray = None):
        """Yield (sf_idx, subframe_samples) tuples from the stream.

        aux: an optional second sample stream on the SAME sample clock
        (the UL carrier of the reference's dual-channel rf open,
        `LTESniffer_Core.cc:176-191`): every yielded tuple grows a third
        element sliced at the identical positions, so the aux stream is
        slaved to the DL PSS timing — drift corrections and re-acquires
        apply to both.  No DL CFO correction is applied to aux (separate
        carrier; the UL chain estimates its own channel from DMRS)."""
        n = self.cell.sf_len
        if abs(self.cfo) > 1e-4:
            # mix the whole chunk by the running estimate; the residual
            # observed during this chunk is folded in at chunk end
            samples = correct_cfo(samples, self.cfo, self.cell.n_fft)
        self._cfo_obs = []
        pos = self.offset
        while pos + n <= len(samples):
            if self.sf_idx % 5 == 0 and pos >= 0:
                drift = self._recorrelate(samples, pos)
                if drift is None:
                    self.consecutive_losses += 1
                    if self.consecutive_losses >= self.max_losses:
                        newpos = self._reacquire(samples, max(pos, 0))
                        if newpos is None:
                            break   # nothing decodable left in this chunk
                        pos = newpos
                        if pos + n > len(samples):
                            break
                else:
                    self.consecutive_losses = 0
                    if drift:
                        self.drift_corrections += 1
                        pos += drift
                        if pos < 0 or pos + n > len(samples):
                            pos = max(pos, 0)
                            if pos + n > len(samples):
                                break
            if aux is None:
                yield self.sf_idx, samples[pos:pos + n]
            else:
                a = aux[pos:pos + n] if pos + n <= len(aux) \
                    else np.zeros(n, np.complex64)
                yield self.sf_idx, samples[pos:pos + n], a
            self.sf_idx = (self.sf_idx + 1) % 10
            pos += n
        self.offset = pos - len(samples)
        if self._cfo_obs:
            self.cfo += float(np.mean(self._cfo_obs))
