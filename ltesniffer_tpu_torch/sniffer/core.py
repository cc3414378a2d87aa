"""Sniffer core: the batched processing loops (torch).

Counterpart of `ltesniffer_tpu/sniffer/core.py`: `LTESnifferCore` for the
downlink, and `LTESnifferCoreUL` below for UL mode (the DL carrier's DCI0
grants decoded on the UL carrier).  The DL loop is a re-design of
`LTESniffer_Core::run` + `SubframeWorker::work`
(`src/src/LTESniffer_Core.cc:107-528`, `src/src/SubframeWorker.cc:142-234`).
Instead of a ring of 20 worker threads each processing one subframe, the
stream is framed into batches of B subframes that move through the device
pipeline together:

  frames -> frontend (demod+chest+CFI) -> blind search (cfi as data) ->
  sequential host resolve (RNTI state in TTI order) -> PDSCH decode per
  accepted DL DCI (HARQ-aware, dual-MCS-table trial) -> MAC parse ->
  pcap / RAR / statistics.

The host resolve + trackers mirror the reference's mutex-guarded L5 state
but run single-threaded over the batch (they are bookkeeping, not DSP).
The phase order of the pipelined driver is the JAX package's, exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import dci as dci_mod, tables
from ltesniffer_tpu_torch.phy.params import (CellConfig, SIRNTI, PRNTI,
                                       RARNTI_START, RARNTI_END)

# FDD RA-RNTI = 1 + t_id (36.321 5.1.4: + 10*f_id, but f_id = 0 for FDD —
# the reference is FDD-only, `README.md:36-37`), so a REAL RAR's RA-RNTI
# is always <= 10.  RA-range accepts above it (possible CRC-collision
# false positives within the 1..60 evergreen window) decode through the
# BATCHED special path instead of the synchronous in-resolve path: each
# sync handling costs a per-grant device round-trip, so only RNTIs whose
# T-CRNTI activation can genuinely gate the same batch's later subframes
# pay for it.
RARNTI_FDD_END = RARNTI_START + 9
from ltesniffer_tpu_torch.io import iq as iq_mod, pcap as pcap_mod
from ltesniffer_tpu_torch.io import sdr as sdr_mod
from ltesniffer_tpu_torch.mac_rrc import mac as mac_mod
from ltesniffer_tpu_torch.kernels import cplx
from . import (dci_search, frontend, pbch_rx, pdcch_rx, pdsch_rx, prof,
               rnti_manager, security_api, sync, trackers)


@dataclasses.dataclass
class SnifferConfig:
    cell: CellConfig
    batch_size: int = 32
    pcap_path: Optional[str] = None
    api_pcap_path: Optional[str] = None
    histogram_threshold: int = 5
    sfn0: int = 0
    decode_pdsch: bool = True
    api_mode: int = -1
    max_harq_retx_buffers: int = 4096
    # the host resolver: True = the C++ resolver/RNTI manager
    # (`ltesniffer_tpu_torch/native.py`, built with g++ at first use; the
    # core raises if it cannot be built), False = the Python copy
    use_native: bool = True
    # IQ ingest quantization: "i8" (packed int8, per-subframe AGC, 4x fewer
    # H2D elements), "i16" (global scale), or "f32" (none).  ingest_int16
    # is the legacy alias: False forces "f32".  Tradeoff: i8's per-subframe
    # AGC puts the quantization floor ~42 dB below each subframe's PEAK —
    # in an extreme near-far/blocker subframe a weak co-scheduled grant
    # loses margin vs the globally-scaled i16 path; switch to "i16" for
    # such captures (real 8-bit SDR front-ends have the same floor).
    ingest: str = "i8"
    ingest_int16: bool = True
    # primary-pass turbo iterations: 2 matches srsRAN's effective average
    # (its per-CB early stop exits after 1-2 iterations at working SNR);
    # CRC failures re-decode from the stored LLRs at turbo_iters_max
    turbo_iters: int = 2
    turbo_iters_max: int = 12  # escalation retry cap (`SubframeWorker.cc:365`)
    dci_trace_path: Optional[str] = None   # tab-separated per-DCI trace
    mcs_csv_path: Optional[str] = None     # mcs_statistic.csv on close()
    heartbeat: bool = False                # per-1000-subframe progress line
    table_every_s: float = 0.0             # >0: periodic DL/UL tables
    draw_maps: bool = False                # ASCII RB/power maps per subframe
    # batches in flight in run_samples: 1 = fully synchronous, 2 = read
    # batch k's results while batch k+1 computes, 3 = the 5-phase deep
    # pipeline (the host resolve overlaps device compute)
    pipeline_depth: int = 3
    # live-mode overload shedding (`LTESniffer_Core.cc:443-451`): when
    # run_source falls more than live_buffer_sf subframes behind the
    # radio's 1 ms cadence, incoming subframes are DROPPED and counted
    # (the reference drops when its 20-worker ring is exhausted)
    live_mode: bool = False
    live_buffer_sf: int = 20
    # False = file-mode parity with the reference: cell/SFN preset from
    # the command line, DECODE_MIB state skipped entirely
    # (`LTESniffer_Core.cc:239`); True = acquire the SFN from PBCH
    acquire_sfn: bool = True
    # torch device of the DSP path; "cpu" is for the tests.  No path falls
    # back to the CPU on its own: asking for "cuda" without a card raises.
    device: str = "cuda"


@dataclasses.dataclass
class AcceptedPdsch:
    dci: dci_search.AcceptedDci
    crc_ok: bool
    tbs: int
    payload: Optional[bytes]
    is_retx: bool
    table: trackers.McsTable


@dataclasses.dataclass(slots=True)
class _DlTb:
    """One DL transport block from its DCI to its record: what
    `_record_dl` needs, carried as `GrantJob.tag` on the batched route."""
    a: dci_search.AcceptedDci
    grant: dci_mod.DlGrant
    sfn: int
    sf: int
    is_special: bool    # SI-, P- or RA-RNTI: no HARQ, no table learning
    tables: tuple       # the MCS tables to try, in order (`_new_dl_tb`)
    table: trackers.McsTable    # the table of the decode recorded
    q: int = 0          # codeword
    is_retx: bool = False


def _is_special(rnti: int) -> bool:
    return rnti in (SIRNTI, PRNTI) or RARNTI_START <= rnti <= RARNTI_END


def _qm_tbs(mcs: int, n_prb: int, table: trackers.McsTable) -> tuple:
    """(Q_m, TBS) of a DL MCS on an MCS table (36.213 7.1.7); TBS 0 for a
    reserved MCS (a re-TX's size then comes from HARQ) or no PRB."""
    qm, i_tbs = tables.dl_mcs_to_qm_itbs(
        mcs, table == trackers.McsTable.QAM256)
    return qm, tables.tbs_lookup(i_tbs, n_prb)


@prof.factory(65536)
def _derive_dci(cell: CellConfig, fmt: str, payload: bytes,
                rnti: int) -> tuple:
    """(Dci, grant) of a DCI's payload bits (uint8 bytes): the UL grant for
    format 0, else the DL grant.  A loaded cell re-issues the same
    allocations every frame; unpack + grant math in python was a
    per-candidate hot-path cost (~30 us x thousands per batch).  Values are
    immutable templates: `_grant_of` returns a shallow copy because
    handlers mutate grant fields."""
    d = dci_mod.unpack(np.frombuffer(payload, np.uint8), fmt, cell,
                       rnti=rnti)
    g = (dci_mod.ul_grant_from_dci(d, cell) if fmt == "0"
         else dci_mod.dl_grant_from_dci(d, cell))
    return d, g


class LTESnifferCore:
    def __init__(self, cfg: SnifferConfig):
        self.cfg = cfg
        self.cell = cfg.cell
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SnifferConfig.device={cfg.device!r} but "
                               "no CUDA device is available")
        # Full float32 products: the OFDM DFT (`kernels/ofdm.py`) and the
        # channel-estimate interpolation (`kernels/chest.py`) are float32
        # matmuls/einsums, and TF32 would shift LLRs enough to flip
        # borderline decodes.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cfg.use_native:
            from ltesniffer_tpu_torch import native
            self.rm = native.default_native_manager(cfg.histogram_threshold)
            self.search = native.NativeDciBlindSearch(self.cell, self.rm)
        else:
            self.rm = rnti_manager.default_manager(cfg.histogram_threshold)
            self.search = dci_search.DciBlindSearch(self.cell, self.rm)
        self.mcs = trackers.MCSTracking()
        self.harq = trackers.HarqEntity()
        self.ulsche = trackers.ULSchedule()
        self.soft_buffers = trackers.SoftBufferPool(cfg.max_harq_retx_buffers)
        self.harq_skipped = 0
        self.sf_skipped = 0       # live-mode overload drops
        self.frontend = frontend.make_frontend(self.cell)
        self.sfn = cfg.sfn0
        self.sf_count = 0
        self.processed = 0
        self.pcap = (pcap_mod.MacLtePcapWriter(cfg.pcap_path)
                     if cfg.pcap_path else None)
        self.api_records: List[dict] = []
        self.api = (security_api.SecurityApi(cfg.api_pcap_path)
                    if cfg.api_mode >= 0 else None)
        self.results: List[AcceptedPdsch] = []
        self.on_subframe = None   # hook(sf_ctx) for extensions
        self._mib_synced = not cfg.acquire_sfn
        self._mib_sf0_seen = 0
        self._sf_dispatched = 0
        self._seg_base = 0        # dispatch index where the segment began
        self._seg_sf0 = 0         # sf_idx at the segment start
        self._low_snr_run = 0     # consecutive low-SNR subframes
        self.sync_losses = 0
        self.est_cfo = 0.0        # residual CFO (subcarriers), integrator-tracked
        self.tracker = None       # SubframeTracker when run_source is used
        self.sib1_info = None     # decoded SIB1 (PLMN, SI scheduling)
        self.stop_requested = False   # SIGINT gate (`SignalManager.h:41-56`)
        from . import observability as obs_mod
        self.heartbeat = obs_mod.Heartbeat() if cfg.heartbeat else None
        self.dci_trace = (obs_mod.DciTraceFile(cfg.dci_trace_path)
                          if cfg.dci_trace_path else None)
        self._last_table_t = time.monotonic()

    # ------------------------------------------------------------------
    def request_stop(self):
        """Graceful-stop gate: the batch loops drain in-flight work, then
        return; pcap/trace files are flushed by close().  The reference's
        SIGINT path (`SignalManager.cc`, `LTESniffer_Core.cc:540-556`)."""
        self.stop_requested = True

    def _tick_observers(self, n_subframes: int):
        if self.heartbeat is not None:
            self.heartbeat.tick(n_subframes)
        if self.cfg.table_every_s > 0:
            now = time.monotonic()
            if now - self._last_table_t >= self.cfg.table_every_s:
                self._last_table_t = now
                from . import observability as obs_mod
                print(obs_mod.format_dl_table(self.mcs, self.rm))
                if self.mcs.stats_ul:
                    print(obs_mod.format_ul_table(self.mcs))

    # ------------------------------------------------------------------
    def run_file(self, path: str, sf_offset: int = 0, sf_idx0: int = 0,
                 max_subframes: Optional[int] = None):
        """Offline replay of an IQ trace (single RX antenna file)."""
        samples = iq_mod.read_iq(path)
        return self.run_samples(samples[sf_offset:], sf_idx0, max_subframes)

    def run_stream(self, samples: np.ndarray,
                   max_subframes: Optional[int] = None,
                   chunk_subframes: int = 256):
        """Continuous-stream entry with real timing acquisition (see
        `run_source`; this wraps an in-memory array as the source)."""
        return self.run_source(
            sdr_mod.ArraySource(np.asarray(samples), self.cell.srate),
            max_subframes=max_subframes, chunk_subframes=chunk_subframes)

    def run_source(self, source, max_subframes: Optional[int] = None,
                   chunk_subframes: int = 256):
        """Live-capable ingest from a `SampleSource` (SDR, file, array):
        PSS/SSS cell search on the first blocks, PSS-tracked framing with
        drift correction across block boundaries, sync-loss recovery
        (full re-acquire + SFN re-sync from the MIB), and live-mode
        overload shedding — the reference's sync loop + DECODE_MIB
        fallback + radio receive path (`LTESniffer_Core.cc:361-528,
        591-601`).  The tracker runs on the host; each segment of framed
        subframes goes through `run_samples`."""
        n = self.cell.sf_len
        # --- acquire: buffer enough for the cell search ----------------
        need = 12 * n
        acc: List[np.ndarray] = []
        got = 0
        while got < need:
            blk = source.read(need - got)
            if blk is None:
                break
            acc.append(np.asarray(blk, dtype=np.complex64))
            got += len(blk)
        carry = (np.concatenate(acc) if acc
                 else np.zeros(0, np.complex64))
        det = sync.find_cell(carry[:12 * n], self.cell.n_fft)
        if det is None:
            raise RuntimeError("cell search failed: no PSS/SSS found")
        if det.n_id_cell != self.cell.n_id_cell:
            raise RuntimeError(
                f"cell ID mismatch: found {det.n_id_cell}, "
                f"configured {self.cell.n_id_cell}")
        self.tracker = sync.SubframeTracker(
            self.cell, det.subframe_offset, 5 if det.is_subframe5 else 0,
            cfo=det.cfo)
        seg: List[np.ndarray] = []
        seg_sf0 = self.tracker.sf_idx
        done = 0
        t0 = time.monotonic()

        def flush():
            nonlocal seg
            if seg:
                self.run_samples(np.concatenate(seg), sf_idx0=seg_sf0)
                seg = []

        eos = done_limit = False
        while not eos and not done_limit and not self.stop_requested:
            yielded = 0
            for sf_idx, frame in self.tracker.frames(carry):
                yielded += 1
                if self.stop_requested:
                    break
                if self.tracker.sync_lost:
                    # timing re-acquired after losses: subframe continuity
                    # broke, so flush and re-acquire the SFN from the MIB
                    flush()
                    seg_sf0 = sf_idx
                    self._mib_synced = False
                    self._mib_sf0_seen = 0
                    self.sync_losses += 1
                    self.tracker.sync_lost = False
                done += 1
                if self.cfg.live_mode:
                    # overload shedding: this subframe "arrived" at done ms
                    # on the radio clock; if processing lags more than the
                    # buffer ring absorbs, drop + count (`LTESniffer_Core.
                    # cc:443-451,557-562` getAvailImmediate + skip counter)
                    lag_sf = (time.monotonic() - t0) * 1e3 - done
                    if lag_sf > self.cfg.live_buffer_sf:
                        self.sf_skipped += 1
                        if self.heartbeat is not None:
                            self.heartbeat.tick(0, skipped=1)
                        if seg:             # keep subframe continuity
                            flush()
                        seg_sf0 = (sf_idx + 1) % 10
                        continue
                seg.append(frame)
                if len(seg) >= chunk_subframes:
                    flush()
                    seg_sf0 = self.tracker.sf_idx
                if max_subframes is not None and done >= max_subframes:
                    done_limit = True
                    break
            # carry the unconsumed tail into the next block (the tracker's
            # end-of-array offset is relative to the array end)
            tail_start = len(carry) + self.tracker.offset
            tail = (carry[tail_start:] if 0 <= tail_start <= len(carry)
                    else np.zeros(0, np.complex64))
            if yielded == 0 and len(tail) > 4 * n:
                # nothing decodable in a whole block: keep only a resync
                # window so garbage input cannot grow the buffer unboundedly
                tail = tail[-2 * n:]
            nxt = source.read(chunk_subframes * n)
            if nxt is None:
                eos = True
                carry = np.zeros(0, np.complex64)
            else:
                carry = np.concatenate([tail,
                                        np.asarray(nxt, np.complex64)])
                self.tracker.offset = 0   # next unconsumed = tail head
        flush()
        return self.results

    def run_samples(self, samples: np.ndarray, sf_idx0: int = 0,
                    max_subframes: Optional[int] = None):
        """Complex64 single-antenna IQ, quantized as `cfg.ingest` says
        (`ingest_int16=False` forces "f32"): "i8" packs int8 with a
        per-subframe AGC (`cplx.to_i8_packed`; ~42 dB below each
        subframe's peak, the fidelity of an 8-bit SDR front-end), "i16"
        scales to int16 globally (`cplx.to_i16`), "f32" sends the floats.
        Then the pipelined driver."""
        n = self.cell.sf_len
        total = len(samples) // n
        if max_subframes is not None:
            total = min(total, max_subframes)
        frames = samples[:total * n].reshape(total, 1, n)
        scale = None
        quant = self.cfg.ingest if self.cfg.ingest_int16 else "f32"
        if quant == "i8":
            frames, scale = cplx.to_i8_packed(frames)
        elif quant == "i16":
            frames, scale = cplx.to_i16(frames)
        else:
            quant = "f32"
        return self._run_quantized(frames, scale, quant, total, sf_idx0)

    def run_packed(self, packed: np.ndarray, scales: np.ndarray,
                   sf_idx0: int = 0, max_subframes: Optional[int] = None):
        """Pre-quantized ingest: (T, RX, n/2) packed-int8 IQ words +
        per-subframe scales, as an 8-bit SDR front-end delivers them
        (`cplx.to_i8_packed` produces the same layout from complex64)."""
        total = packed.shape[0]
        if max_subframes is not None:
            total = min(total, max_subframes)
        return self._run_quantized(packed[:total], scales[:total], "i8",
                                   total, sf_idx0)

    # batches copied to the device ahead of the compute frontier
    PREFETCH_BATCHES = 3

    def _put_chunk(self, chunks: dict, w64, scale, sf_idx, k: int,
                   total: int):
        a = k * self.cfg.batch_size
        if k in chunks or a >= total:
            return
        b = min(a + self.cfg.batch_size, total)
        dev = self.device
        chunks[k] = (torch.from_numpy(np.ascontiguousarray(w64[a:b])).to(dev),
                     torch.from_numpy(np.ascontiguousarray(scale[a:b])).to(dev),
                     sf_idx[a:b].astype(np.int64))

    def _run_quantized(self, frames, scale, quant: str, total: int,
                       sf_idx0: int):
        """Pipelined batch driver: batch N+1's device work is queued before
        batch N's host-side resolve runs, so host work overlaps device
        compute (the analog of the reference's sync-thread / worker-pool
        overlap, `Phy.cc:29-55`).  "i8" frames are packed words copied a
        few batches ahead (`_put_chunk`); "i16" and "f32" frames go a
        batch at a time through `_phase1`."""
        self._seg_base = self._sf_dispatched
        self._seg_sf0 = sf_idx0
        n = self.cell.sf_len
        sf_idx = (sf_idx0 + np.arange(total)) % 10
        # int64 carrier: 8 int8 IQ bytes per element
        w64 = cplx.view_i64(frames) if quant == "i8" else None
        chunks: dict = {}
        depth = max(1, self.cfg.pipeline_depth)
        from collections import deque
        q: deque = deque()
        for kk, a in enumerate(range(0, total, self.cfg.batch_size)):
            if self.stop_requested:
                break
            b = min(a + self.cfg.batch_size, total)
            if w64 is not None:
                for kp in range(kk, kk + 1 + self.PREFETCH_BATCHES):
                    self._put_chunk(chunks, w64, scale, sf_idx, kp, total)
                q.append(self._phase1_chunk(*chunks.pop(kk)))
            else:
                blk = frames[a:b]
                if scale is None and abs(self.est_cfo) > 2e-3:
                    # worker-estimated CFO fed back into the stream,
                    # mirroring the reference's est_cfo channel
                    # (`SubframeWorker.cc:203`); pipelining adds ~2 batches
                    # of feedback latency (quantized ingest applies the
                    # same rotation on the device instead)
                    rot = np.exp(-2j * np.pi * self.est_cfo
                                 * np.arange(n) / self.cell.n_fft)
                    blk = (blk * rot[None, None, :]).astype(np.complex64)
                q.append(self._phase1(blk, sf_idx[a:b], scale=scale))
            if depth >= 3:
                # deep 5-phase pipeline (2+ batches of device work
                # queued).  Phase ORDER within the iteration matters on
                # the in-order device queue: phase4's escalation/retry
                # dispatches land BEFORE this iteration's search dispatch
                # (phase2), so next iteration's phase5 read waits only on
                # a sliver of compute instead of draining a whole batch.
                # finalize(k) must still run before build(k+1): trackers
                # (HARQ/MCS) that batch k's results update gate batch
                # k+1's decisions — phase5(k-4) precedes phase3(k-2).
                # (The JAX package's order, kept exactly: the golden pcap
                # depends on it.)
                if len(q) >= 5:
                    self._phase5(q.popleft())
                if len(q) >= 4:
                    self._phase4(q[-4])
                if len(q) >= 2:
                    self._phase2(q[-2])
                if len(q) >= 3:
                    self._phase3(q[-3])
            elif depth == 2:
                # queue this batch's full device chain, then read the
                # PREVIOUS batch's results while this one computes
                self._phase2(q[-1])
                if len(q) >= 2:
                    ctx = q.popleft()
                    self._phase3(ctx)
                    self._phase4(ctx)
                    self._phase5(ctx)
            else:
                ctx = q.popleft()
                self._phase2(ctx)
                self._phase3(ctx)
                self._phase4(ctx)
                self._phase5(ctx)
        while q:
            ctx = q.popleft()
            if ctx["stage"] < 2:
                self._phase2(ctx)
            if ctx["stage"] < 3:
                self._phase3(ctx)
            if ctx["stage"] < 4:
                self._phase4(ctx)
            self._phase5(ctx)
        return self.results

    def process_batch(self, frames: np.ndarray, sf_idx: np.ndarray):
        """Synchronous single-batch path (tests): complex64 frames (B, RX,
        n) or (B, n), straight to the float frontend with no quantization;
        the same phases as the pipelined driver, zero lookahead."""
        x = np.asarray(frames, np.complex64)
        ctx = self._phase1(x[:, None] if x.ndim == 2 else x, sf_idx)
        self._phase2(ctx)
        self._phase3(ctx)
        self._phase4(ctx)
        self._phase5(ctx)

    # ------------------------------------------------------------------
    def _phase1_chunk(self, d64, d_scale, sf_idx: np.ndarray) -> dict:
        """Queue the frontend on one int64-carried chunk on the device."""
        prof.batch_start(self._sf_dispatched, len(sf_idx))
        with prof.span("phase1"):
            with prof.span("p1_frontend"):
                fe = self.frontend.run_i8c64(
                    d64, torch.from_numpy(sf_idx).to(self.device), d_scale,
                    float(np.float32(self.est_cfo)))
            return self._dispatched(fe, sf_idx)

    def _phase1(self, frames: np.ndarray, sf_idx: np.ndarray,
                scale=None) -> dict:
        """Queue the frontend on one batch: int16 pairs + global scale
        (on-device CFO de-rotation) when `scale` is given, else complex64
        frames (B, RX, n) as float pairs."""
        sf_idx = np.asarray(sf_idx).astype(np.int64)
        prof.batch_start(self._sf_dispatched, len(sf_idx))
        with prof.span("phase1"):
            sf_dev = torch.from_numpy(sf_idx).to(self.device)
            with prof.span("p1_frontend"):
                if scale is not None:
                    fe = self.frontend.run_i16(
                        torch.from_numpy(np.ascontiguousarray(frames)).to(
                            self.device), sf_dev,
                        torch.tensor(np.float32(scale), device=self.device),
                        float(np.float32(self.est_cfo)))
                else:
                    fe = self.frontend.run(
                        np.ascontiguousarray(frames, dtype=np.complex64),
                        sf_dev, self.device)
            return self._dispatched(fe, sf_idx)

    def _dispatched(self, fe: dict, sf_idx: np.ndarray) -> dict:
        """A batch's context once its frontend is queued."""
        B = len(sf_idx)
        base = self._sf_dispatched
        self._sf_dispatched += B
        # frame-aligned index: (fbase + i) // 10 counts frame boundaries
        # exactly at the sf_idx 9 -> 0 wraps of this segment
        fbase = self._seg_sf0 + (base - self._seg_base)
        return dict(fe=fe, sf_idx=np.asarray(sf_idx), B=B,
                    base=base, fbase=fbase, stage=1)

    # blind-search device calls run on fixed-size chunks of subframes
    # (bounds the fused Viterbi's working set: every candidate of every
    # size of the chunk decodes in one scan)
    SEARCH_CHUNK = 64

    def _phase2(self, ctx: dict):
        """Queue the MIB decodes and the blind search; the fused candidate
        words (with the frontend scalars folded in) are read in _phase3."""
        prof.batch(ctx["base"])
        with prof.span("phase2"):
            fe = ctx["fe"]
            B = ctx["B"]
            sf_idx = ctx["sf_idx"]
            # un-synced SFN: queue a MIB decode for this batch's subframe-0
            # candidates NOW; the bits are resolved in _consume_scalars once
            # the SNR gate is known
            if not self._mib_synced:
                pend = []
                seen = self._mib_sf0_seen   # projected: resolve-side gate uses
                for i in range(B):          # the SNR-qualified count
                    if sf_idx[i] == 0 and len(pend) < 4:
                        seen += 1
                        # apply the every-8th-frame backoff at DISPATCH time
                        # too: past the first 8 frames, skipped candidates are
                        # wasted device work
                        if seen > 8 and seen % 8 != 0:
                            continue
                        pend.append((i, pbch_rx.dispatch_mib_at(
                            fe["grids"], fe["h"], fe["noise_var"], i,
                            self.cell)))
                ctx["mib_pend"] = pend
            run, st = pdcch_rx.make_unified_search(self.cell)
            # the per-subframe CFI rides as DATA, straight from the PCFICH
            # stage: no host read in this phase
            cfi_dev = fe["cfi"] - 1
            sf_dev = torch.from_numpy(np.asarray(sf_idx, np.int64)).to(
                self.device)
            CH = self.SEARCH_CHUNK
            chunks = []   # (cand_fused dev, head-skip)
            with prof.span("p2_search"):
                a = 0
                while a < B:
                    skip = 0
                    if B > CH and a + CH > B:
                        # overlap the tail chunk backward (as the reference
                        # package does); the re-decoded head rows are dropped
                        skip = CH - (B - a)
                        a = B - CH
                    sl = slice(a, a + CH)
                    out_c = run(fe["grids"][sl], fe["h"][sl],
                                fe["noise_var"][sl], fe["snr_db"][sl],
                                sf_dev[sl], cfi_dev[sl], fe["scalars"][sl])
                    chunks.append((out_c["cand_fused"], skip))
                    a += CH
            ctx["outs"] = {"_st": st, "_chunks": chunks}
            ctx["stage"] = 2

    def _consume_scalars(self, ctx: dict, scal: np.ndarray):
        """Host-side consumption of the frontend scalars (CFI / SNR / CFO /
        RSRP), unpacked from the fused candidate transfer: CFO feedback,
        sync-loss detection, MIB-based SFN acquisition."""
        fe = ctx["fe"]
        B = ctx["B"]
        sf_idx = ctx["sf_idx"]
        cfi = scal[:, 0].astype(np.int32)
        snrs = scal[:, 1]
        cfos = scal[:, 2]
        ctx["cfi"] = cfi
        ctx["snr"] = snrs
        # residual-CFO feedback: an INTEGRATOR on the measured residual
        # (est is what remains AFTER the current correction, so the loop
        # accumulates gain*est; equivalent to the reference's est_cfo
        # channel, `SubframeWorker.cc:203`).  Gain 0.1 per batch: stable
        # for drift rates up to ~0.1 subcarrier/batch
        good = snrs > 6.0
        if good.any():
            est = float(np.mean(cfos[good]))
            self.est_cfo += 0.1 * est
        # sync-loss detection: >=5 consecutive low-SNR subframes re-enter
        # MIB acquisition once signal returns (`LTESniffer_Core.cc:506-525`)
        for s in snrs:
            if s < 0.0:
                self._low_snr_run += 1
                if self._low_snr_run == 5 and self._mib_synced:
                    self._mib_synced = False
                    self._mib_sf0_seen = 0
                    self.sync_losses += 1
            else:
                self._low_snr_run = 0
        # SFN acquisition from the first decodable MIB (subframe 0).
        # Attempt every frame for the first 8 frames, then back off to
        # every 8th frame -- but never give up (the reference retries until
        # MIB decodes, `LTESniffer_Core.cc:382-418`).  The device decodes
        # were dispatched asynchronously back in _phase2; here only the
        # SNR gate + CRC-hypothesis resolution run.
        if not self._mib_synced:
            pend = {i: dev for i, dev in ctx.get("mib_pend", ())}
            for i in range(B):
                if sf_idx[i] == 0 and snrs[i] > 0.0:
                    self._mib_sf0_seen += 1
                    if (self._mib_sf0_seen > 8
                            and self._mib_sf0_seen % 8 != 0):
                        continue
                    with prof.span("p2_mib"):
                        if i in pend:
                            mib = pbch_rx.resolve_mib_bits(
                                prof.host_read("p2_mib", pend[i]).numpy())
                        else:
                            # beyond the dispatched candidates: sync call
                            mib = pbch_rx.decode_mib_at(
                                fe["grids"], fe["h"], fe["noise_var"], i,
                                self.cell)
                    if mib.ok:
                        self.sfn = (mib.sfn
                                    - (ctx["fbase"] + i) // 10) % 1024
                        self._mib_synced = True
                        break

    def _phase3(self, ctx: dict):
        """Read the fused candidate words (candidates + scalars); resolve
        in time order; unpack accepted payloads; run handlers and queue
        the grouped PDSCH decode."""
        prof.batch(ctx["base"])
        with prof.span("phase3"):
            outs = ctx["outs"]
            B = ctx["B"]
            sf_idx = ctx["sf_idx"]
            out = outs
            st = out["_st"]
            with prof.span("p3_join"):
                fused = np.concatenate(
                    [prof.host_read("p3_join", dev).numpy()[skip:]
                     for dev, skip in out["_chunks"]])
            n_loc = len(st["locs"])
            nof_cce = st["nof_cce"]
            S = len(st["size_order"])
            with prof.span("p3_meta"):
                cand_meta, cce, scal, pay = pdcch_rx.unpack_fused(
                    fused, n_loc, S, nof_cce, with_scalars=True,
                    with_payloads=True)
            ctx["_pay"] = pay
            self._consume_scalars(ctx, scal)
            out["_host"] = {
                "cand_meta": cand_meta,
                "cce_power": cce,
                "snr_db": ctx["snr"],
            }
            # ---- pass A: sequential resolve (RNTI-manager state in time
            # order)
            resolved = []
            for i in range(B):
                c = int(ctx["cfi"][i])
                gi = i
                sf = int(sf_idx[i])
                sfn_i = (self.sfn + (ctx["fbase"] + i) // 10) % 1024
                with prof.span("resolve"):
                    accepted = self.search.resolve_subframe(
                        out["_host"], gi, st["locs"],
                        st["nof_cce_of"][min(max(c, 1), 3) - 1], sf,
                        sfn=sfn_i)
                # RAR acceptance gates later subframes' RNTI validation:
                # handle it synchronously (rare; pays one extra fetch)
                if self.cfg.decode_pdsch and any(
                        RARNTI_START <= a.rnti <= RARNTI_FDD_END
                        and a.fmt != "0" for a in accepted):
                    self._materialize_payloads(ctx, [(c, a) for a in accepted])
                    for a in accepted:
                        if (RARNTI_START <= a.rnti <= RARNTI_FDD_END
                                and a.fmt != "0"):
                            self._handle_dl_dci(ctx["fe"], i, c, a, sfn_i, sf)
                            a._done = True
                resolved.append((i, c, gi, sf, sfn_i, accepted))
                self.processed += 1
            # ---- one payload fetch for everything accepted in the batch
            refs = [(c, a) for (_, c, _, _, _, acc) in resolved for a in acc
                    if isinstance(a.payload, dci_search.PayloadRef)]
            self._materialize_payloads(ctx, refs)
            # ---- pass B: handlers in time order + batched PDSCH jobs
            with prof.span("p3_handlers"):
                pending = self._run_handlers(ctx, resolved)
            # queue the grouped PDSCH decode on the device (ONE call across
            # all cfi groups: jobs carry their own cfi); its fused result is
            # read in _phase4, after the next batch's work is queued
            with prof.span("pdsch_dispatch"):
                ctx["pdsch"] = self._dispatch_pending(ctx["fe"], pending)
            self.sf_count += B
            now_tti = trackers.tti_of(self.sfn + self.sf_count // 10,
                                      int(sf_idx[-1]))
            self.mcs.update_database(now_tti)
            self.harq.prune(now_tti)
            ctx["stage"] = 3
        prof.batch_dci(ctx["base"])

    def _run_handlers(self, ctx: dict, resolved) -> list:
        """Pass B of phase 3: the handlers in time order; returns the
        batched PDSCH jobs."""
        out = ctx["outs"]
        pending = []
        fe = ctx["fe"]
        for (i, c, gi, sf, sfn_i, accepted) in resolved:
            self._count_rb_collisions(accepted)
            if self.dci_trace is not None and accepted:
                self.dci_trace.write(accepted)
            if self.cfg.draw_maps and accepted:
                self._draw_rb_map(accepted, sfn_i, sf)
            if self.cfg.decode_pdsch:
                # DL DCIs first so UL DCI0s can match ACK counts against
                # this subframe's DL assignments (`SubframeWorker.cc:319-337`)
                ul_dcis = []
                dl_ack: Dict[int, int] = {}
                for a in accepted:
                    if getattr(a, "_done", False):
                        continue
                    if a.fmt == "0":
                        ul_dcis.append(a)
                    elif RARNTI_START <= a.rnti <= RARNTI_FDD_END:
                        self._handle_dl_dci(fe, i, c, a, sfn_i, sf)
                    else:
                        job = self._prepare_dl_job(i, c, a, sfn_i, sf,
                                                   ack_out=dl_ack)
                        if job is False:
                            pass   # DECODED re-TX: skip (`HARQ.cc:121-127`)
                        elif job is None:
                            # MIMO / degenerate: immediate path
                            self._handle_dl_dci(fe, i, c, a, sfn_i, sf,
                                                ack_out=dl_ack)
                        else:
                            pending.append(job)
                for a in ul_dcis:
                    self._handle_ul_dci(a, sfn_i, sf,
                                        nof_ack=dl_ack.get(a.rnti, 0))
            if self.on_subframe:
                self.on_subframe(dict(out=out, gi=gi, cfi=c, sf=sf,
                                      sfn=sfn_i, accepted=accepted))
        return pending

    def _phase4(self, ctx: dict):
        """Join the primary fused PDSCH read; DISPATCH the iteration
        escalation and the unknown-table 256QAM retry asynchronously —
        their results apply in _phase5 one iteration later, so the
        re-decodes overlap the next batch's host work instead of a
        synchronous dispatch+read that drains the device queue inline."""
        prof.batch(ctx["base"])
        with prof.span("phase4"):
            post = []
            for fe, jobs, pb in ctx.get("pdsch") or []:
                with prof.span("p4_results"):
                    res = pdsch_rx.finish_grants_batch(
                        pb, soft_buffers=self.soft_buffers)
                esc = None
                if self.cfg.turbo_iters_max > self.cfg.turbo_iters:
                    esc_idx = [idx for idx, r in enumerate(res)
                               if r is not None and not r.crc_ok
                               and idx in pb.seg_of]
                    if esc_idx:
                        with prof.span("p4_escalate_dispatch"):
                            esc = pdsch_rx.escalate_dispatch(
                                pb, esc_idx, self.cfg.turbo_iters_max)
                # unknown-table misses: batched retry with the 256QAM table
                # (`DL_Sniffer_PDSCH.cc:1090-1243` dual-table trial)
                retry = None
                retry_jobs, retry_idx = [], []
                for idx, (job, r) in enumerate(zip(jobs, res)):
                    tb = job.tag
                    if r is not None and not r.crc_ok and len(tb.tables) > 1:
                        qm2, tbs2 = _qm_tbs(tb.grant.mcs,
                                            tb.grant.n_prb_alloc, tb.tables[1])
                        if tbs2 > 0:
                            retry_jobs.append(dataclasses.replace(
                                job, qm=qm2, tbs=tbs2, harq_key=None))
                            retry_idx.append(idx)
                if retry_jobs:
                    prof.count("pdsch_grant_retried", len(retry_jobs))
                    with prof.span("p4_retry_dispatch"):
                        rpb = pdsch_rx.dispatch_grants_batch(
                            fe["grids"], fe["h"], fe["noise_var"], self.cell,
                            retry_jobs, n_iter=self.cfg.turbo_iters_max)
                    retry = (retry_idx, rpb)
                post.append((jobs, pb, res, esc, retry))
            ctx["pdsch_post"] = post
            ctx["stage"] = 4

    def _phase5(self, ctx: dict):
        """Apply escalation/retry results; run handlers, pcap, stats."""
        prof.batch(ctx["base"])
        with prof.span("phase5"):
            for jobs, pb, res, esc, retry in ctx.get("pdsch_post") or []:
                if esc is not None:
                    with prof.span("p5_escalate_join"):
                        pdsch_rx.escalate_finish(
                            pb, esc, soft_buffers=self.soft_buffers)
                if retry is not None:
                    retry_idx, rpb = retry
                    with prof.span("p5_retry_join"):
                        res2 = pdsch_rx.finish_grants_batch(
                            rpb, site="retry_join")
                    for idx, r2 in zip(retry_idx, res2):
                        # escalation (64QAM at full iterations) wins ties —
                        # the reference tries 64 first, then 256
                        if r2.crc_ok and not res[idx].crc_ok:
                            res[idx] = r2
                            tb = jobs[idx].tag
                            tb.table = tb.tables[1]
                with prof.span("p5_finish_dl"):
                    for job, r in zip(jobs, res):
                        self._record_dl(job.tag, r)
            self._tick_observers(ctx["B"])
            ctx["stage"] = 5
        prof.batch_out(ctx["base"])

    def _materialize_payloads(self, ctx: dict, refs):
        """Replace PayloadRefs with real bit arrays from the host copy of
        the candidate payload matrix (it rides the overlapped fused
        transfer; the former device-side accepted-only gather was a
        synchronous dispatch+read that drained the whole in-order device
        queue mid-resolve)."""
        todo = [a for _c, a in refs
                if isinstance(a.payload, dci_search.PayloadRef)]
        if not todo:
            return
        pay = ctx["_pay"]
        with prof.span("p3_payload"):
            for a in todo:
                words = pay[a.payload.b, a.payload.loc_idx,
                            a.payload.size_idx]
                a.payload = pdcch_rx.unpack_payload(words, a.payload.nbits)

    # ------------------------------------------------------------------
    def _draw_rb_map(self, accepted, sfn: int, sf: int):
        """ASCII RB-allocation map per subframe (`DCIPrint.cc:40-55`,
        DCIDrawASCII): one colored rnti%10 digit per occupied PRB."""
        from . import observability as obs_mod
        grants = []
        for a in accepted:
            if isinstance(a.payload, dci_search.PayloadRef):
                continue
            try:
                g = self._grant_of(a)
            except (ValueError, KeyError, IndexError):
                continue
            if a.fmt == "0":
                grants.append((a.rnti, (g.prb_start, g.n_prb)))
            else:
                grants.append((a.rnti, g.prb_mask))
        if grants:
            m = obs_mod.rb_map_of(grants, self.cell.n_prb)
            print(f"[{sfn:4d}.{sf}] {obs_mod.render_rb_map(m)}")

    def _derive(self, a: dci_search.AcceptedDci):
        return _derive_dci(self.cell, a.fmt,
                           np.asarray(a.payload, np.uint8).tobytes(), a.rnti)

    def _unpack_dci(self, a: dci_search.AcceptedDci):
        """Unpack a DCI once per accepted candidate and cache the result
        (collision counting + handlers share it)."""
        d = getattr(a, "_dci", None)
        if d is None:
            d = self._derive(a)[0]
            a._dci = d
        return d

    def _grant_of(self, a: dci_search.AcceptedDci):
        """Cached DCI->grant derivation (UL grant for fmt 0, else DL)."""
        g = getattr(a, "_grant", None)
        if g is None:
            g = dataclasses.replace(self._derive(a)[1])
            a._grant = g
        return g

    def _count_rb_collisions(self, accepted) -> None:
        """Per-subframe RB-allocation overlap detection.

        Mirrors the reference's merged RB map (`DCICollection.cc:214-292`):
        each accepted DL grant's slot-0 PRBs and each UL grant's contiguous
        PRBs are painted into per-direction maps; any overlap marks the
        subframe as colliding (`DCISearch.cc:512-519` increments the
        per-subframe counters once per direction).  Grants that cannot be
        derived (e.g. invalid RIV) are counted in `nof_malformed_grants`
        so undercounting stays observable."""
        if not accepted:
            return
        n = self.cell.n_prb
        dl_map = np.zeros(n, bool)
        ul_map = np.zeros(n, bool)
        dl_col = ul_col = False
        for a in accepted:
            if isinstance(a.payload, dci_search.PayloadRef):
                continue   # not materialized (decode_pdsch off): skip
            try:
                g = self._grant_of(a)
            except (ValueError, KeyError, IndexError):
                self.search.stats.nof_malformed_grants += 1
                continue
            if a.fmt == "0":
                span = slice(g.prb_start, g.prb_start + g.n_prb)
                if ul_map[span].any():
                    ul_col = True
                ul_map[span] = True
            else:
                if (dl_map & g.prb_mask).any():
                    dl_col = True
                dl_map |= g.prb_mask
        if dl_col:
            self.search.stats.nof_subframe_collisions_dl += 1
        if ul_col:
            self.search.stats.nof_subframe_collisions_ul += 1

    def _handle_ul_dci(self, a: dci_search.AcceptedDci, sfn: int, sf: int,
                       nof_ack: int = 0):
        g = self._grant_of(a)
        prb_start = g.prb_start
        if g.hopping and g.hop_bits >= 0:
            from ltesniffer_tpu_torch.phy import ra
            sib2 = self.ulsche.sib2 or {}
            prb_start = ra.ul_hopping_prbs(
                g.prb_start, g.n_prb, self.cell.n_prb, g.hop_bits,
                sib2.get("n_sb", 1), sib2.get("pusch_hopping_offset", 0))
        self.ulsche.push_dci0(trackers.tti_of(sfn, sf), trackers.UlGrantPending(
            rnti=a.rnti, tti_apply=0, mcs=g.mcs, prb_start=prb_start,
            n_prb=g.n_prb, ndi=g.ndi, hopping=g.hopping, dmrs_cs=g.dmrs_cs,
            cqi_request=g.cqi_request, nof_ack=nof_ack))
        st = self.mcs.stat_ul(a.rnti)
        st.new_tx += 1
        st.last_seen_tti = trackers.tti_of(sfn, sf)

    def _new_dl_tb(self, a: dci_search.AcceptedDci, grant: dci_mod.DlGrant,
                   sfn: int, sf: int, is_special: bool, q: int = 0) -> _DlTb:
        """A DL TB of a DCI, with the MCS tables to try in order (the
        dual-table trial, `DL_Sniffer_PDSCH.cc:1090-1243`): 64QAM for a
        special RNTI, the learnt table of a known RNTI, 64QAM then 256QAM
        for an unknown one."""
        known = (trackers.McsTable.QAM64 if is_special
                 else self.mcs.dl_table_of(a.rnti))
        plan = ((trackers.McsTable.QAM64, trackers.McsTable.QAM256)
                if known == trackers.McsTable.UNKNOWN else (known,))
        return _DlTb(a=a, grant=grant, sfn=sfn, sf=sf, is_special=is_special,
                     tables=plan, table=plan[0], q=q)

    def _classify_dl(self, tb: _DlTb, ndi: int, tbs: int, keyed: bool,
                     skip_decoded: bool = True):
        """HARQ classification of a TB at its first table's TBS, once and
        not per table trial (as the reference, `DL_Sniffer_PDSCH.cc:955-991`).
        Sets `tb.is_retx`; returns (the TBS to decode, with `keyed` the
        soft-buffer key, cleared at a new TX), or None for a decoded re-TX
        with `skip_decoded` (counted, `HARQ.cc:121-127`)."""
        if tb.is_special:
            return tbs, None
        dec = self.harq.classify(tb.a.rnti, tb.grant.harq_pid, tb.q, ndi,
                                 tbs, trackers.tti_of(tb.sfn, tb.sf))
        if dec.decoded and skip_decoded:
            self.harq_skipped += 1
            return None
        tb.is_retx = dec.is_retx
        key = None
        if keyed:
            key = self.harq.buffer_key(tb.a.rnti, tb.grant.harq_pid, tb.q)
            if not dec.is_retx:
                self.soft_buffers.clear_harq(key)
        return dec.tbs, key

    def _prepare_dl_job(self, i: int, cfi: int,
                        a: dci_search.AcceptedDci, sfn: int, sf: int,
                        ack_out: Optional[Dict[int, int]] = None):
        """Build a batchable GrantJob for a single-TB DL DCI (None if the
        grant needs the immediate path: MIMO or no usable TBS; False for a
        decoded re-TX, which is skipped)."""
        grant = self._grant_of(a)
        special = _is_special(a.rnti)
        if ack_out is not None and not special:
            ack_out[a.rnti] = max(ack_out.get(a.rnti, 0), grant.nof_tb)
        if grant.nof_tb == 2:
            return None
        tb = self._new_dl_tb(a, grant, sfn, sf, special)
        qm, tbs = _qm_tbs(grant.mcs, grant.n_prb_alloc, tb.table)
        # a soft buffer only on a known table: a trial decode must not
        # pollute it
        harq = self._classify_dl(tb, grant.ndi, tbs, keyed=len(tb.tables) == 1)
        if harq is None:
            return False
        tbs, harq_key = harq
        if tbs <= 0:
            return None
        return pdsch_rx.GrantJob(
            b=i, sf_idx=sf, cfi=cfi, rnti=a.rnti, prb_mask=grant.prb_mask,
            qm=qm, tbs=tbs, rv=grant.rv,
            prb_mask_slot1=grant.prb_mask_slot1, harq_key=harq_key,
            is_retx=tb.is_retx, pa=self._pa_of(a.rnti), tag=tb)

    def _pa_of(self, rnti: int) -> float:
        """Linear PDSCH power scale 10^(p_a/20) from the UE's dedicated
        config (`MCSTracking.cc:1446-1529`); 1.0 when unconfigured."""
        cfg = self.mcs.ue_config.get(rnti)
        if cfg is None or not cfg.has_config or cfg.p_a == 0.0:
            return 1.0
        return float(10.0 ** (cfg.p_a / 20.0))

    def _dispatch_pending(self, fe, pending):
        """Launch the grouped device decode for all collected jobs (one
        call across cfi groups — each job carries its cfi); returns
        [(fe, jobs, PendingPdschBatch)] handles for `_finish_pending`."""
        if not pending:
            return []
        pb = pdsch_rx.dispatch_grants_batch(
            fe["grids"], fe["h"], fe["noise_var"], self.cell, pending,
            soft_buffers=self.soft_buffers, n_iter=self.cfg.turbo_iters)
        prof.count("pdsch_grant", len(pending))
        prof.count("pdsch_cb", sum(len(g[3]) for g in pb.group_rows))
        return [(fe, pending, pb)]

    def _record_dl(self, tb: _DlTb, res: Optional[pdsch_rx.PdschResult],
                   mac: bool = True, sib: bool = True):
        """Record a TB's decode (None: no table gave a TBS): its HARQ
        outcome, the RNTI's table learnt on a CRC pass, with `mac` the MAC
        handlers (SIB with `sib`, RAR, UE config, API), the pcap record,
        the RNTI's DL stats and the AcceptedPdsch."""
        a = tb.a
        crc_ok = res is not None and res.crc_ok
        if not tb.is_special:
            self.harq.report_crc(a.rnti, tb.grant.harq_pid, tb.q, crc_ok)
        payload = res.payload if crc_ok else None
        if crc_ok:
            if mac and sib and a.rnti == SIRNTI:
                self._handle_sib(payload)
            if (not tb.is_special and self.mcs.dl_table_of(a.rnti)
                    == trackers.McsTable.UNKNOWN):
                self.mcs.learn_dl_table(a.rnti, tb.table)
            self._emit_pdsch(a, payload, tb.sfn, tb.sf, crc_ok=True,
                             retx=1 if tb.is_retx else 0)
            if mac:
                if RARNTI_START <= a.rnti <= RARNTI_END:
                    # a non-FDD-range RA-RNTI on the batched route: its
                    # RAR lands one batch late (impossible on FDD air,
                    # where RA-RNTI <= 10 stays synchronous)
                    self._handle_rar(payload, tb.sfn, tb.sf)
                elif not tb.is_special:
                    self._learn_ue_config(a.rnti, payload)
                if self.api is not None:
                    self._api_dl(a.rnti, payload, tb.sfn, tb.sf)
        st = self.mcs.stat_dl(a.rnti)
        st.last_seen_tti = trackers.tti_of(tb.sfn, tb.sf)
        if tb.is_retx:
            st.retx += 1
        else:
            st.new_tx += 1
        if crc_ok:
            st.success += 1
        else:
            st.fail += 1
        self.results.append(AcceptedPdsch(
            dci=a, crc_ok=crc_ok, tbs=res.tbs if res is not None else 0,
            payload=payload, is_retx=tb.is_retx, table=tb.table))

    def _handle_dl_dci(self, fe, i: int, cfi: int,
                       a: dci_search.AcceptedDci, sfn: int, sf: int,
                       ack_out: Optional[Dict[int, int]] = None):
        grant = self._grant_of(a)
        special = _is_special(a.rnti)
        if ack_out is not None and not special:
            ack_out[a.rnti] = max(ack_out.get(a.rnti, 0), grant.nof_tb)
        if grant.nof_tb == 2:
            # TB enabled iff not (mcs == 0 and rv == 1), 36.213 7.1.7.2
            en0 = not (grant.mcs == 0 and grant.rv == 1)
            en1 = not (grant.mcs2 == 0 and grant.rv2 == 1)
            if en0 and en1:
                # format 2 pinfo 3+ with 2 codewords is reserved on a
                # 2-PORT cell (36.212 Table 5.3.3.1.5-4) -> inconsistent
                # MIMO config (4-port cells use the 6-bit Table
                # 5.3.3.1.5-5, handled in the MIMO path)
                if (a.fmt == "2" and self.cell.nof_ports == 2
                        and grant.precoding > 2):
                    self.mcs.note_wrong_mimo(a.rnti)
                    return
                if self.cell.nof_rx_ant >= 2:
                    return self._handle_dl_dci_mimo(fe, i, cfi, a, grant,
                                                    sfn, sf)
                # 2 spatial codewords but a 1-antenna receiver: the grant
                # cannot be decoded — count it like the reference's
                # MIMO-config error (W_MIMO column, `MCSTracking.cc:98-110`)
                self.mcs.note_wrong_mimo(a.rnti)
                return
            # single enabled TB -> fall through as transmit diversity with
            # that TB's fields
            if en1 and not en0:
                grant.mcs, grant.rv, grant.ndi = (grant.mcs2, grant.rv2,
                                                  grant.ndi2)
            grant.nof_tb = 1
        tb = self._new_dl_tb(a, grant, sfn, sf, special)
        # keyed, so an unknown-table RNTI's buffer is cleared at a new TX
        # too (not on the batched route; kept for parity)
        harq = self._classify_dl(
            tb, grant.ndi, _qm_tbs(grant.mcs, grant.n_prb_alloc, tb.table)[1],
            keyed=True)
        if harq is None:
            return
        tbs0, harq_key = harq
        # soft combining only when the MCS table is unambiguous
        use_buffers = harq_key is not None and len(tb.tables) == 1
        res = None
        for table in tb.tables:
            qm, tbs = _qm_tbs(grant.mcs, grant.n_prb_alloc, table)
            if tbs <= 0 and tb.is_retx and grant.n_prb_alloc:
                tbs = tbs0      # MCS reserved on this table: HARQ's TBS
            if tbs <= 0:
                continue
            res = pdsch_rx.decode_grant(
                fe["grids"], fe["h"], fe["noise_var"], i, self.cell, sf,
                cfi, rnti=a.rnti, prb_mask=grant.prb_mask, qm=qm, tbs=tbs,
                rv=grant.rv, prb_mask_slot1=grant.prb_mask_slot1,
                soft_buffers=self.soft_buffers if use_buffers else None,
                harq_key=harq_key if use_buffers else None,
                pa=self._pa_of(a.rnti))
            tb.table = table
            if res.crc_ok:
                break
        # recorded as failed, TBS 0, where no table gave a TBS; no SIB
        # handling on this route (both kept for parity)
        self._record_dl(tb, res, sib=False)

    def _handle_dl_dci_mimo(self, fe, i: int, cfi: int,
                            a: dci_search.AcceptedDci,
                            grant: dci_mod.DlGrant, sfn: int, sf: int):
        """Formats 2/2A with two enabled TBs: spatial multiplexing decode
        (TM4 via the DCI's precoding info, TM3 for format 2A).

        Unknown-table RNTIs run the same dual-table (64 -> 256QAM) trial
        as the single-TB path, and a success LEARNS the table — the
        reference's retry wraps ALL its decodes incl. 2-TB
        (`DL_Sniffer_PDSCH.cc:1090-1243`)."""
        from ltesniffer_tpu_torch.kernels import mimo as mimo_mod
        if a.fmt == "2":
            if self.cell.nof_ports == 4:
                n_layers, pmi = mimo_mod.decode_pinfo_4tx(grant.precoding,
                                                          True)
                if n_layers > 2:
                    # rank-3/4 exceeds the 2-RX receiver: unsupported
                    # MIMO config (reference W_MIMO, `MCSTracking.cc:98`)
                    self.mcs.note_wrong_mimo(a.rnti)
                    return
            else:
                n_layers, pmi = mimo_mod.decode_pinfo_2tx(grant.precoding,
                                                          True)
            tm = 4
        else:
            # format 2A: 4-port cells carry a 2-bit precoding field
            # (36.212 Table 5.3.3.1.5A-2: 0 -> 2 layers, 1/2 -> rank 3/4)
            if self.cell.nof_ports == 4 and grant.precoding > 0:
                self.mcs.note_wrong_mimo(a.rnti)
                return
            tm, pmi = 3, 0
        # every RNTI is a UE's on this route, SI-, P- and RA-RNTIs too:
        # HARQ, table trial and learning (kept for parity)
        cws = [self._new_dl_tb(a, grant, sfn, sf, False, q) for q in (0, 1)]
        cw_mcs = (grant.mcs, grant.mcs2)
        # a re-TX of a decoded TB is decoded again (kept for parity)
        harq = [self._classify_dl(
            cw, ndi, _qm_tbs(mcs, grant.n_prb_alloc, cw.table)[1],
            keyed=True, skip_decoded=False)
            for cw, mcs, ndi in zip(cws, cw_mcs, (grant.ndi, grant.ndi2))]
        # soft combining only when the table is unambiguous (a trial
        # decode must not pollute the HARQ buffers)
        use_buffers = len(cws[0].tables) == 1
        res = None
        for table in cws[0].tables:
            qms, tbss = [], []
            for cw, mcs, (tbs0, _key) in zip(cws, cw_mcs, harq):
                qm, tbs = _qm_tbs(mcs, grant.n_prb_alloc, table)
                if cw.is_retx and tbs <= 0:
                    tbs = tbs0    # mcs 29-31 re-TX: stored TBS
                qms.append(qm)
                tbss.append(tbs)
            if min(tbss) <= 0:
                continue
            # synchronous: one host read of the LLRs and one of the bits
            # per code-block size, between the batched jobs of phase 3
            with prof.span("p3_mimo"):
                res = pdsch_rx.decode_grant_mimo(
                    fe["grids"], fe["h"], fe["noise_var"], i, self.cell, sf,
                    cfi, rnti=a.rnti, prb_mask=grant.prb_mask,
                    qms=tuple(qms), tbss=tuple(tbss), tm=tm,
                    pmi=pmi if pmi is not None else 0,
                    rvs=(grant.rv, grant.rv2),
                    soft_buffers=self.soft_buffers if use_buffers else None,
                    harq_keys=(tuple(key for _tbs, key in harq)
                               if use_buffers else (None, None)))
            for cw in cws:
                cw.table = table
            if any(r.crc_ok for r in res):
                break
        if res is None:
            return      # nothing recorded (kept for parity)
        for cw, r in zip(cws, res):
            # no SIB, RAR, UE-config or API handling (kept for parity)
            self._record_dl(cw, r, mac=False)

    def _handle_sib(self, payload: bytes):
        """SI-RNTI PDSCH -> SIB1 (PLMN/cell identity + SI scheduling) and
        SIB2 UL config (`decode_SIB` -> `set_SIB2`,
        `SubframeWorker.cc:240-252`, `DL_Sniffer_PDSCH.cc:459-570`)."""
        from ltesniffer_tpu_torch.mac_rrc import rrc as rrc_mod
        if self.ulsche.sib2 is not None and getattr(self, "sib1_info",
                                                    None) is not None:
            return
        out = rrc_mod.decode_bcch(payload)
        if not out:
            return
        if out[0] == "sib1":
            self.sib1_info = out[1]
        elif out[0] == "sib2" and self.ulsche.sib2 is None:
            cfg = out[1]
            self.ulsche.set_sib2(dataclasses.asdict(cfg))
            if hasattr(self, "cyclic_shift_cfg"):
                self.cyclic_shift_cfg = cfg.cyclic_shift

    def _learn_ue_config(self, rnti: int, payload: bytes):
        """UE-specific config from RRC ConnectionSetup (DL CCCH) or a
        Reconfiguration-carried radioResourceConfigDedicated (DL DCCH) —
        learned UNCONDITIONALLY, api mode or not (the reference's
        MCSTracking consumes every such message,
        `DL_Sniffer_PDSCH.cc:1041-1070` -> `MCSTracking.cc:1446-1529`)."""
        if _is_special(rnti) or rnti in self.mcs.ue_config:
            return
        from ltesniffer_tpu_torch.mac_rrc import rrc as rrc_mod
        try:
            subs = mac_mod.parse_mac_pdu(payload)
        except Exception:
            return
        for s in subs:
            setup = None
            if s.lcid == mac_mod.LCID_CCCH:
                out = rrc_mod.decode_dl_ccch(s.payload)
                if out and out[0] == "connection_setup":
                    setup = out[1]
            elif s.lcid in (1, 2):
                for cand in mac_mod.rlc_pdcp_rrc_sdu(s.payload):
                    out = rrc_mod.decode_dl_dcch(cand)
                    if (out and out[0] == "reconfiguration"
                            and out[1] is not None
                            and out[1].setup is not None):
                        setup = out[1].setup
                        break
            if setup is not None:
                self.mcs.set_ue_config(rnti, trackers.UeConfig(
                    p_a=setup.p_a_db, uci_offset_ack=setup.ack_offset,
                    uci_offset_ri=setup.ri_offset,
                    uci_offset_cqi=setup.cqi_offset, tm=setup.tm))

    def _api_dl(self, rnti: int, payload: bytes, sfn: int, sf: int):
        """Security-API extraction from DL MAC PDUs
        (`run_api_dl_mode`, `DL_Sniffer_PDSCH.cc:804-879`)."""
        if rnti == PRNTI:
            self.api.on_paging(payload, sfn, sf)
            return
        if _is_special(rnti):
            return
        try:
            subs = mac_mod.parse_mac_pdu(payload)
        except Exception:
            return
        for s in subs:
            if s.lcid == mac_mod.LCID_CON_RES and len(s.payload) >= 6:
                self.api.on_con_res(rnti, s.payload[:6], sfn, sf)
            elif s.lcid == mac_mod.LCID_CCCH:
                self.api.on_dl_ccch(rnti, s.payload, sfn, sf)
            elif s.lcid in (1, 2):   # SRB1/SRB2 DL DCCH
                before = self._api_events(rnti)
                for cand in mac_mod.rlc_pdcp_rrc_sdu(s.payload):
                    self.api.on_dl_dcch(rnti, cand, sfn, sf)
                    if self._api_events(rnti) > before:
                        break

    def _api_events(self, rnti: int) -> int:
        r = self.api.records.get(rnti)
        return len(r.events) if r is not None else 0

    def _handle_rar(self, payload: bytes, sfn: int, sf: int):
        """RAR: activate T-CRNTIs (RM_ACT_RAR) + queue UL grants
        (`DL_Sniffer_PDSCH.cc:782-800`)."""
        _backoff, rars = mac_mod.parse_rar_pdu(payload)
        for r in rars:
            if r.t_crnti:
                self.rm.activate_and_refresh(
                    r.t_crnti, rnti_manager.FORMAT_TO_INDEX["0"],
                    rnti_manager.ActivationReason.RAR)
                f = mac_mod.rar_grant_fields(r.grant)
                from ltesniffer_tpu_torch.phy import ra
                s, l = ra.riv_to_start_len(f["rba"], self.cell.n_prb)
                self.ulsche.push_rar(
                    trackers.tti_of(sfn, sf),
                    trackers.UlGrantPending(
                        rnti=r.t_crnti, tti_apply=0, mcs=f["trunc_mcs"],
                        prb_start=s, n_prb=l, ndi=0, hopping=f["hopping"],
                        cqi_request=f["cqi_request"], rapid=r.rapid))

    def _emit_pdsch(self, a: dci_search.AcceptedDci, payload: bytes,
                    sfn: int, sf: int, crc_ok: bool, retx: int):
        if self.pcap:
            self.pcap.write_pdu(payload, rnti=a.rnti,
                                direction=pcap_mod.DIRECTION_DOWNLINK,
                                sfn=sfn, sf_idx=sf, crc_ok=crc_ok, retx=retx)

    # ------------------------------------------------------------------
    def close(self):
        if self.pcap:
            self.pcap.close()
        if self.api is not None:
            self.api.close()
        if self.dci_trace is not None:
            self.dci_trace.close()
            self.dci_trace = None
        if self.cfg.mcs_csv_path:
            from . import observability as obs_mod
            obs_mod.write_mcs_csv(self.cfg.mcs_csv_path, self.mcs)

    def summary(self) -> dict:
        ok = sum(1 for r in self.results if r.crc_ok)
        return {
            "subframes": self.processed,
            "dcis": len(self.results),
            "pdsch_ok": ok,
            "harq_skipped": self.harq_skipped,
            "sf_skipped": self.sf_skipped,
            "active_rntis": len(self.rm.active_set()),
            "sync_losses": self.sync_losses,
            "resyncs": self.tracker.resyncs if self.tracker else 0,
            "search_stats": dataclasses.asdict(self.search.stats),
        }


# ---------------------------------------------------------------------------
# UL mode: dual-stream (DL + UL carrier) sniffing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AcceptedPusch:
    rnti: int
    sfn: int
    sf_idx: int
    crc_ok: bool
    tbs: int
    payload: Optional[bytes]
    snr_db: float
    ta_us: float
    table: trackers.McsTable
    from_rar: bool


class LTESnifferCoreUL(LTESnifferCore):
    """DL+UL mode: the DL stream drives the blind search; DCI0/RAR grants
    apply to the UL stream 4/6 subframes later (`SubframeWorker::run_ul_mode`
    + `PUSCH_Decoder::decode`, SURVEY.md §3.3).  Counterpart of
    `ltesniffer_tpu/sniffer/core.py:LTESnifferCoreUL`, with its phase order.

    The UL decode is batched like the DL path: all grants pending over a
    subframe batch — including 16/64/256QAM trial variants for
    unknown-table RNTIs — dispatch as grouped device calls with one fused
    device -> host read (`pusch_rx.dispatch_grants_ul_batch`);
    unknown-table trials are rate-limited per RNTI
    (`MCSTracking.UL_TRIAL_LIMIT`).  PRACH detection runs on the host on
    every UL subframe the SIB2 PRACH configuration allows (`work_prach`,
    `UL_Sniffer_PUSCH.cc:672-713`)."""

    _CASCADE = [("16qam", trackers.McsTable.UL_16QAM),
                ("64qam", trackers.McsTable.UL_64QAM),
                ("256qam", trackers.McsTable.UL_256QAM)]
    _TNAME = {trackers.McsTable.UL_16QAM: "16qam",
              trackers.McsTable.UL_64QAM: "64qam",
              trackers.McsTable.UL_256QAM: "256qam"}

    def __init__(self, cfg: SnifferConfig, cyclic_shift_cfg: int = 0):
        super().__init__(cfg)
        from . import pusch_rx
        self.ul_frontend = pusch_rx.make_ul_frontend(self.cell)
        self.cyclic_shift_cfg = cyclic_shift_cfg
        self.ul_results: List[AcceptedPusch] = []
        self.prach_detections: List[dict] = []
        self.ul_hist = trackers.UlGrantHistory()
        self._ul_pending = None

    def run_dual_source(self, dl_source, ul_source,
                        max_subframes: Optional[int] = None,
                        chunk_subframes: int = 256, ul_skew: int = 0):
        """Live-capable dual-carrier ingest: two `SampleSource`s on one
        sample clock (the reference's dual-frequency rf open,
        `LTESniffer_Core.cc:176-191,225`).  PSS cell search + tracking run
        on the DL stream; the UL stream is SLAVED to the DL timing (both
        streams are sliced at identical positions, so drift corrections
        and sync-loss re-acquires apply to both — per-stream handling as
        one shared clock, which is what the dual-channel radio gives).
        Each segment goes through `run_dual_packed`.

        ul_skew: known inter-stream sample offset (UL content sitting
        `ul_skew` samples LATER in its stream than the corresponding DL
        time — analog-path delay / TA pre-buffer margin, the reference's
        ta_buffer `LTESniffer_Core.cc:100-104`); compensated at ingest."""
        n = self.cell.sf_len
        need = 12 * n
        dl_acc: List[np.ndarray] = []
        ul_acc: List[np.ndarray] = []
        got = 0
        while got < need:
            blk = dl_source.read(need - got)
            ublk = ul_source.read(need - got)
            if blk is None or ublk is None:
                break
            m = min(len(blk), len(ublk))   # lockstep: keep pairs aligned
            dl_acc.append(np.asarray(blk[:m], np.complex64))
            ul_acc.append(np.asarray(ublk[:m], np.complex64))
            got += m
        dl_carry = (np.concatenate(dl_acc) if dl_acc
                    else np.zeros(0, np.complex64))
        ul_carry = (np.concatenate(ul_acc) if ul_acc
                    else np.zeros(0, np.complex64))
        if ul_skew > 0:        # UL content arrives later in its stream
            ul_carry = ul_carry[ul_skew:]
        elif ul_skew < 0:
            ul_carry = np.concatenate(
                [np.zeros(-ul_skew, np.complex64), ul_carry])
        det = sync.find_cell(dl_carry[:12 * n], self.cell.n_fft)
        if det is None:
            raise RuntimeError("cell search failed: no PSS/SSS found")
        if det.n_id_cell != self.cell.n_id_cell:
            raise RuntimeError(
                f"cell ID mismatch: found {det.n_id_cell}, "
                f"configured {self.cell.n_id_cell}")
        self.tracker = sync.SubframeTracker(
            self.cell, det.subframe_offset, 5 if det.is_subframe5 else 0,
            cfo=det.cfo)
        dl_seg: List[np.ndarray] = []
        ul_seg: List[np.ndarray] = []
        seg_sf0 = self.tracker.sf_idx
        done = 0

        def flush():
            nonlocal dl_seg, ul_seg
            if dl_seg:
                T = len(dl_seg)
                dl_p = cplx.to_i8_packed(
                    np.stack(dl_seg).reshape(T, 1, n))
                ul_p = cplx.to_i8_packed(
                    np.stack(ul_seg).reshape(T, 1, n))
                self.run_dual_packed(dl_p, ul_p, sf_idx0=seg_sf0)
                dl_seg = []
                ul_seg = []

        eos = done_limit = False
        while not eos and not done_limit and not self.stop_requested:
            pad = len(dl_carry) - len(ul_carry)
            if pad > 0:        # a short UL read: keep positions aligned
                ul_carry = np.concatenate(
                    [ul_carry, np.zeros(pad, np.complex64)])
            yielded = 0
            for sf_idx, frame, ul_frame in self.tracker.frames(
                    dl_carry, aux=ul_carry):
                yielded += 1
                if self.stop_requested:
                    break
                if self.tracker.sync_lost:
                    flush()
                    seg_sf0 = sf_idx
                    self._mib_synced = False
                    self._mib_sf0_seen = 0
                    self.sync_losses += 1
                    self.tracker.sync_lost = False
                done += 1
                dl_seg.append(frame)
                ul_seg.append(ul_frame)
                if len(dl_seg) >= chunk_subframes:
                    flush()
                    seg_sf0 = self.tracker.sf_idx
                if max_subframes is not None and done >= max_subframes:
                    done_limit = True
                    break
            tail_start = len(dl_carry) + self.tracker.offset
            dl_tail = (dl_carry[tail_start:]
                       if 0 <= tail_start <= len(dl_carry)
                       else np.zeros(0, np.complex64))
            ul_tail = (ul_carry[tail_start:]
                       if 0 <= tail_start <= len(ul_carry)
                       else np.zeros(0, np.complex64))
            if yielded == 0 and len(dl_tail) > 4 * n:
                dl_tail = dl_tail[-2 * n:]
                ul_tail = ul_tail[-2 * n:]
            nxt = dl_source.read(chunk_subframes * n)
            unxt = ul_source.read(chunk_subframes * n)
            if nxt is None or unxt is None:
                eos = True
                dl_carry = np.zeros(0, np.complex64)
                ul_carry = np.zeros(0, np.complex64)
            else:
                m = min(len(nxt), len(unxt))
                dl_carry = np.concatenate(
                    [dl_tail, np.asarray(nxt[:m], np.complex64)])
                ul_carry = np.concatenate(
                    [ul_tail, np.asarray(unxt[:m], np.complex64)])
                self.tracker.offset = 0
        flush()
        return self.ul_results

    def run_dual_samples(self, dl_samples: np.ndarray, ul_samples: np.ndarray,
                         sf_idx0: int = 0,
                         max_subframes: Optional[int] = None):
        """Two single-antenna complex64 streams on one sample clock,
        quantized to packed int8 (`cplx.to_i8_packed`), then the pipelined
        loop of `run_dual_packed`."""
        n = self.cell.sf_len
        total = min(len(dl_samples), len(ul_samples)) // n
        if max_subframes is not None:
            total = min(total, max_subframes)
        dl = cplx.to_i8_packed(dl_samples[:total * n].reshape(total, 1, n))
        ul = cplx.to_i8_packed(ul_samples[:total * n].reshape(total, 1, n))
        return self.run_dual_packed(dl, ul, sf_idx0)

    def run_dual_packed(self, dl_packed, ul_packed, sf_idx0: int = 0,
                        max_subframes: Optional[int] = None):
        """Dual-carrier ingest from pre-quantized packed-int8 IQ: (words,
        scales) per stream, copied to the device a batch at a time ahead
        of the compute frontier (see `run_packed`)."""
        total = min(dl_packed[0].shape[0], ul_packed[0].shape[0])
        if max_subframes is not None:
            total = min(total, max_subframes)
        sf_idx = (sf_idx0 + np.arange(total)) % 10
        dl64 = cplx.view_i64(dl_packed[0])
        ul64 = cplx.view_i64(ul_packed[0])
        dl_chunks: dict = {}
        ul_chunks: dict = {}
        self._seg_base = self._sf_dispatched
        self._seg_sf0 = sf_idx0
        # deep pipeline, the JAX package's order exactly: at iteration k
        # the loop finalizes batch k-3, joins batch k-2's PDSCH reads and
        # queues its escalation, queues batch k's device work (DL frontend
        # + search + UL demod), then resolves batch k-1 and queues its UL
        # grant decode.  Invariants: DL phase5(k-3) runs before
        # dual_phase3(k-1) (HARQ/MCS state gates job prep), and UL
        # finish(k-2) runs before UL build(k-1) (table learning gates the
        # cascade); the UL golden pcap's record order depends on both.
        from collections import deque
        q: deque = deque()
        for kk, a in enumerate(range(0, total, self.cfg.batch_size)):
            if self.stop_requested:
                break
            for kp in range(kk, kk + 1 + self.PREFETCH_BATCHES):
                self._put_chunk(dl_chunks, dl64, dl_packed[1], sf_idx,
                                kp, total)
                self._put_chunk(ul_chunks, ul64, ul_packed[1], sf_idx,
                                kp, total)
            if len(q) >= 3:
                self._phase5(q.popleft()[0])
            if len(q) >= 2:
                self._phase4(q[-2][0])
            q.append(self._dispatch_dual(dl_chunks.pop(kk),
                                         ul_chunks.pop(kk), a))
            if len(q) >= 2:
                self._dual_phase3(q[-2], ul_packed)
        while q:
            cur = q.popleft()
            if cur[0]["stage"] < 3:
                self._dual_phase3(cur, ul_packed)
            if cur[0]["stage"] < 4:
                self._phase4(cur[0])
            self._phase5(cur[0])
        self._finish_ul_pending()
        return self.ul_results

    def _finish_ul_pending(self):
        from . import pusch_rx
        prev = self._ul_pending
        if prev is not None:
            self._ul_pending = None
            jobs, pb = prev
            esc = (self.cfg.turbo_iters_max
                   if self.cfg.turbo_iters_max > self.cfg.turbo_iters
                   else 0)
            self._finish_ul(jobs, pusch_rx.finish_grants_ul_batch(
                pb, n_iter_esc=esc))

    def _dispatch_dual(self, dl_chunk, ul_chunk, a: int):
        """Device half of one dual batch: DL frontend + blind search first
        (the candidate read must not wait behind the UL demod), then the
        UL SC-FDMA demod — all queued, nothing read."""
        ctx = self._phase1_chunk(*dl_chunk)
        self._phase2(ctx)
        # UL grids stay ON THE DEVICE: the batched grant decode gathers
        # from them there and only the fused per-grant results come back
        u64, usc, _ = ul_chunk
        with prof.span("pu_frontend"):
            ul_grids = self.ul_frontend.run_i8c64(u64, usc)
        return (ctx, ul_grids, a, ctx["sf_idx"])

    def _dual_phase3(self, cur, ul_packed):
        """Resolve one dual batch's DL side (collecting the UL grants its
        subframes schedule), finish the PREVIOUS UL batch, and queue this
        batch's grouped UL grant decode."""
        from . import pusch_rx
        ctx, ul_grids, a, sf_idx = cur
        if self.cfg.draw_maps:
            from . import observability as obs_mod
            pw = prof.host_read("ul_power_map", pusch_rx.make_power_map(
                self.cell)(ul_grids)).numpy()
            self.last_ul_power = pw
            for i in range(pw.shape[0]):
                print(f"[ul pwr] {obs_mod.render_power_map(pw[i])}")
        # process the DL batch with a hook that collects pending UL grants
        idx_holder = {"i": 0}
        collected: List[tuple] = []

        def hook(sf_ctx):
            i = idx_holder["i"]
            tti = trackers.tti_of(sf_ctx["sfn"], sf_ctx["sf"])
            for g in self.ulsche.pop(tti):
                collected.append((i, sf_ctx["sfn"], sf_ctx["sf"], g))
            self._work_prach(ul_packed, a + i, sf_ctx["sfn"], sf_ctx["sf"])
            idx_holder["i"] += 1

        old_hook = self.on_subframe
        self.on_subframe = hook
        try:
            self._phase3(ctx)
        finally:
            self.on_subframe = old_hook
        # finish(k-1) before build(k): table learning / trial budgets that
        # batch k-1's results update gate batch k's cascade decisions
        with prof.span("pu_finish_prev"):
            self._finish_ul_pending()
        jobs = self._build_ul_jobs(collected)
        if jobs:
            # primary pass at few turbo iterations (srsRAN-style early
            # stop, amortized); CRC failures escalate in finish
            with prof.span("pu_dispatch"):
                pb = pusch_rx.dispatch_grants_ul_batch(
                    ul_grids, self.cell, jobs,
                    n_iter=self.cfg.turbo_iters)
            self._ul_pending = (jobs, pb)

    # -- PRACH occasion map, 36.211 Table 5.7.1-2 (format 0, FDD) ---------
    _PRACH_SF = {0: (1,), 1: (4,), 2: (7,), 3: (1,), 4: (4,), 5: (7,),
                 6: (1, 6), 7: (2, 7), 8: (3, 8), 9: (1, 4, 7),
                 10: (2, 5, 8), 11: (3, 6, 9), 12: (0, 2, 4, 6, 8),
                 13: (1, 3, 5, 7, 9), 14: tuple(range(10)), 15: (9,)}
    _PRACH_EVEN_SFN = {0, 1, 2, 15}

    def _work_prach(self, ul_packed, i: int, sfn: int, sf: int):
        """PRACH detection on allowed UL subframes (`work_prach`,
        `UL_Sniffer_PUSCH.cc:672-713`; config from SIB2 `set_rach_config`,
        `:657`).  Reads the packed UL IQ on the host: no device sync."""
        sib2 = self.ulsche.sib2
        if not sib2:
            return
        cfg_idx = int(sib2.get("prach_config_index", 3))
        if cfg_idx in self._PRACH_EVEN_SFN and sfn % 2:
            return
        if sf not in self._PRACH_SF.get(cfg_idx, ()):
            return
        from ltesniffer_tpu_torch.phy import prach_roots
        from . import prach_rx
        frame = cplx.unpack_i8(ul_packed[0][i], float(ul_packed[1][i]))[0]
        cp = int(round(self.cell.srate * prach_rx.T_CP))
        # SIB2 rootSequenceIndex is LOGICAL (36.211 Table 5.7.2-4); the
        # cell's 64 preambles span consecutive logical roots at the
        # zeroCorrelationZone's N_cs
        roots, n_cs, mapped = prach_roots.cell_roots(
            int(sib2.get("prach_root_seq_index", 0)),
            int(sib2.get("zero_correlation_zone", 1)))
        dets = prach_rx.detect(
            frame[cp:], self.cell, roots=roots, n_cs=n_cs,
            prach_freq_offset=int(sib2.get("prach_freq_offset", 4)),
            threshold=8.0)
        shifts_per_root = (839 // n_cs) if n_cs > 0 else 64
        for d in dets:
            ri = roots.index(d.root)
            self.prach_detections.append(dict(
                sfn=sfn, sf_idx=sf, root=d.root,
                preamble=ri * shifts_per_root + d.preamble,
                peak=d.peak, ta_samples=d.ta_samples,
                logical_mapped=mapped))

    def _build_ul_jobs(self, collected) -> List:
        from . import pusch_rx
        from ltesniffer_tpu_torch.phy import uci as uci_mod
        jobs = []
        for gi, (i, sfn, sf, g) in enumerate(collected):
            known = self.mcs.ul_table_of(g.rnti)
            if known == trackers.McsTable.UNKNOWN:
                cascade = list(self._CASCADE)
                if not self.mcs.ul_trial_budget_ok(g.rnti):
                    # trial budget exhausted: default table only until a
                    # success learns the real one
                    cascade = cascade[:1]
            else:
                cascade = [(self._TNAME[known], known)]
            # UCI config: ACK count matched from the DCI0 subframe's DL
            # DCIs, beta offsets from the UE-config DB, RI presence from
            # the UE's transmission mode (`UL_Sniffer_PUSCH.cc:429-450`:
            # TM3/4 report rank; aperiodic CSI requests add it too)
            ue_cfg = self.mcs.ue_config.get(g.rnti, trackers.UeConfig())
            ri_len = 1 if (ue_cfg.tm in (3, 4) or g.cqi_request) else 0
            # Q' sizes from the TB's INITIAL grant (36.212 5.2.2.6): an
            # adaptive retransmission keeps the first allocation's dims
            init_prb, init_mcs = self.ul_hist.initial_dims(
                g.rnti, g.ndi, g.n_prb, g.mcs)
            tried = set()
            for order, (tname, tenum) in enumerate(cascade):
                qm, i_tbs = tables.ul_mcs_to_qm_itbs(g.mcs, tname)
                if i_tbs < 0:
                    continue
                tbs = tables.tbs_lookup(i_tbs, g.n_prb)
                if (qm, tbs) in tried:   # identical decode -> skip variant
                    continue
                tried.add((qm, tbs))
                _, init_itbs = tables.ul_mcs_to_qm_itbs(init_mcs, tname)
                init_tbs = (tables.tbs_lookup(init_itbs, init_prb)
                            if init_itbs >= 0 else tbs)
                n_ri, n_ack = uci_mod.uci_symbol_counts(
                    g.nof_ack, ri_len, ue_cfg.uci_offset_ack,
                    ue_cfg.uci_offset_ri, init_prb, init_tbs,
                    n_prb_current=g.n_prb)
                n_cqi = 0
                if g.cqi_request:
                    # aperiodic CQI rides this PUSCH: subband-HL payload
                    # (the reference enables it on every cqi_request,
                    # `UL_Sniffer_PUSCH.cc:437-444`); cqi_mode 0 from the
                    # UE config selects wideband-only sizing
                    o_cqi = uci_mod.aperiodic_cqi_bits(
                        self.cell.n_prb,
                        wideband_only=ue_cfg.cqi_mode == 0)
                    n_cqi = uci_mod.cqi_q_prime(
                        o_cqi, ue_cfg.uci_offset_cqi, init_prb, init_tbs,
                        n_ri_syms=n_ri, n_prb_current=g.n_prb)
                jobs.append(pusch_rx.UlGrantJob(
                    b=i, sf_idx=sf, rnti=g.rnti, prb_start=g.prb_start,
                    n_prb=g.n_prb, qm=qm, tbs=tbs,
                    cyclic_shift_cfg=self.cyclic_shift_cfg,
                    dmrs_field=g.dmrs_cs, n_ri_syms=n_ri, n_ack_syms=n_ack,
                    n_cqi_syms=n_cqi,
                    tag=dict(gi=gi, order=order, tenum=tenum, sfn=sfn,
                             sf=sf, g=g, known=known)))
        return jobs

    def _finish_ul(self, jobs, res):
        """Pick each grant's winning table variant (first CRC pass in
        cascade order, else the first trial), then stats/pcap/api — the
        per-grant tail of the reference's `decode` (`:452-583`)."""
        by_grant: Dict[int, List[tuple]] = {}
        for job, r in zip(jobs, res):
            by_grant.setdefault(job.tag["gi"], []).append((job, r))
        for gi in sorted(by_grant):
            variants = sorted(by_grant[gi], key=lambda t: t[0].tag["order"])
            job, r = next(((j, x) for j, x in variants if x.crc_ok),
                          variants[0])
            t = job.tag
            g = t["g"]
            sfn, sf = t["sfn"], t["sf"]
            if r.crc_ok and t["known"] == trackers.McsTable.UNKNOWN:
                self.mcs.learn_ul_table(g.rnti, t["tenum"])
            elif not r.crc_ok and t["known"] == trackers.McsTable.UNKNOWN:
                self.mcs.note_ul_trial_fail(g.rnti)
            st = self.mcs.stat_ul(g.rnti)
            st.last_seen_tti = trackers.tti_of(sfn, sf)
            if r.crc_ok:
                st.success += 1
            elif r.snr_db >= 1.0:  # UL stats gate (`UL_Sniffer_PUSCH.cc:572`)
                st.fail += 1
            payload = None
            if r.crc_ok:
                payload = np.packbits(r.tb_bits).tobytes()
                if self.pcap:
                    self.pcap.write_pdu(payload, rnti=g.rnti,
                                        direction=pcap_mod.DIRECTION_UPLINK,
                                        sfn=sfn, sf_idx=sf, crc_ok=True)
                if self.api is not None:
                    self._api_ul(g.rnti, payload, sfn, sf)
            self.ul_results.append(AcceptedPusch(
                rnti=g.rnti, sfn=sfn, sf_idx=sf, crc_ok=r.crc_ok,
                tbs=r.tbs, payload=payload, snr_db=r.snr_db, ta_us=r.ta_us,
                table=t["tenum"], from_rar=g.from_rar))

    def _api_ul(self, rnti: int, payload: bytes, sfn: int, sf: int):
        try:
            subs = mac_mod.parse_mac_pdu(payload, uplink=True)
        except Exception:
            return
        for s in subs:
            if s.lcid == mac_mod.LCID_CCCH:
                self.api.on_ul_ccch(rnti, s.payload, sfn, sf)
            elif s.lcid in (1, 2):   # SRB1/SRB2 DCCH: RLC AM + PDCP framing
                before = self._api_events(rnti)
                for cand in mac_mod.rlc_pdcp_rrc_sdu(s.payload):
                    self.api.on_ul_dcch(rnti, cand, sfn, sf)
                    if self._api_events(rnti) > before:
                        break
