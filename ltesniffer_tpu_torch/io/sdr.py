"""SDR / live sample sources (the reference's L0 RF I-O layer).

Counterpart of `ltesniffer_tpu/io/sdr.py`, copied: the sources are host
numpy and carry nothing device-specific.

The reference opens the radio via srsRAN's rf layer
(`srsran_rf_open_multi/set_rx_freq/set_rx_srate/recv_with_time_multi`,
`src/src/LTESniffer_Core.cc:151-236,591-601`).  Here the ingest is a small
source protocol so the sniffer core is transport-agnostic:

* `SampleSource`: anything with `.srate` and `.read(n) -> complex64 array
  or None at end-of-stream`.
* `FileSource`: chunked reads from an IQ trace (offline replay; also the
  deterministic stand-in for radio tests).
* `ArraySource`: an in-memory stream (tests).
* `SoapySource`: SoapySDR-based live receiver (UHD/bladeRF/rtl-sdr via the
  Soapy driver ecosystem), import-guarded — constructing it without the
  SoapySDR python module raises with a clear message.

Dual-carrier (UL mode) live capture needs two time-aligned sources — one
per center frequency — mirroring the reference's two-channel rf open
(`LTESniffer_Core.cc:176-191`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class FileSource:
    """Chunked IQ trace reader (srsRAN complex-float binary format)."""

    def __init__(self, path: str, srate: float):
        self.path = path
        self.srate = srate
        self._f = open(path, "rb")

    def read(self, n: int) -> Optional[np.ndarray]:
        buf = self._f.read(8 * n)
        if not buf:
            return None
        return np.frombuffer(buf, dtype=np.complex64)

    def close(self):
        self._f.close()


class ArraySource:
    """In-memory sample stream (tests / generated scenarios)."""

    def __init__(self, samples: np.ndarray, srate: float,
                 chunk_limit: Optional[int] = None):
        self.samples = np.asarray(samples, dtype=np.complex64)
        self.srate = srate
        self.pos = 0
        self.chunk_limit = chunk_limit

    def read(self, n: int) -> Optional[np.ndarray]:
        if self.pos >= len(self.samples):
            return None
        if self.chunk_limit:
            n = min(n, self.chunk_limit)
        out = self.samples[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def close(self):
        pass


class SoapySource:
    """Live SDR receive stream via SoapySDR (import-guarded).

    Mirrors the reference's radio bring-up: open by driver args, set
    sample rate / center frequency / gain (or AGC when gain is None,
    `LTESniffer_Core.cc:163-171`), then stream chunks."""

    def __init__(self, driver_args: str, srate: float, freq_hz: float,
                 gain_db: Optional[float] = None, channel: int = 0):
        try:
            import SoapySDR
            from SoapySDR import SOAPY_SDR_RX, SOAPY_SDR_CF32
        except ImportError as e:          # pragma: no cover - no SDR in CI
            raise RuntimeError(
                "SoapySDR python module not available - install a Soapy "
                "driver stack for live capture, or use file replay") from e
        self.srate = srate
        self._dev = SoapySDR.Device(driver_args)
        self._dev.setSampleRate(SOAPY_SDR_RX, channel, srate)
        self._dev.setFrequency(SOAPY_SDR_RX, channel, freq_hz)
        if gain_db is None:
            try:
                self._dev.setGainMode(SOAPY_SDR_RX, channel, True)  # AGC
            except Exception:
                pass
        else:
            self._dev.setGain(SOAPY_SDR_RX, channel, gain_db)
        self._stream = self._dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32,
                                             [channel])
        self._dev.activateStream(self._stream)
        self._buf = np.zeros(1 << 16, np.complex64)

    def read(self, n: int) -> Optional[np.ndarray]:   # pragma: no cover
        out = np.empty(n, np.complex64)
        got = 0
        while got < n:
            want = min(n - got, len(self._buf))
            sr = self._dev.readStream(self._stream, [self._buf], want)
            if sr.ret <= 0:
                if got == 0:
                    return None
                break
            out[got:got + sr.ret] = self._buf[:sr.ret]
            got += sr.ret
        return out[:got]

    def close(self):                                   # pragma: no cover
        self._dev.deactivateStream(self._stream)
        self._dev.closeStream(self._stream)
