#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --scale-out     # phase 8 alone, any card count

Drives `ltesniffer_tpu_torch` — the PyTorch port of the JAX package
`ltesniffer_tpu` — through its main path on the card and fails (non-zero
exit) if any phase fails:

1. card and build: the card's name and power limit; build the eight
   hand-written CUDA sources with nvcc and the native resolver with g++,
   all nine side by side: the fused whole-decode turbo kernel
   (kernels/csrc/turbo_decode.cu, the main path's decoder), the per-pass
   BCJR kernel (kernels/csrc/bcjr.cu, the earlier design), the
   tail-biting Viterbi of the blind search and the MIB
   (kernels/csrc/viterbi_tb.cu: the plain entry and the search entry
   with the de-rate-match folded in), the two-codeword grant's eq/demap
   (kernels/csrc/mimo_eq_demap.cu), the search tail's packing kernel and
   the earlier route's de-rate-match and CRC / packing kernels
   (kernels/csrc/pdcch_tail.cu), the batched PDSCH path's
   transport-block finish (kernels/csrc/tb_finish.cu), single-layer
   eq/demap (kernels/csrc/pdsch_eq_demap.cu) and code blocks'
   de-rate-match (kernels/csrc/cb_derm.cu), and the host resolver
   (csrc/resolver.cpp); their build times and ptxas registers/spills.
2. kernels vs plain version: at the K values of the loaded cell's and the
   golden scenario's grants and K = 40 and 6144, n_iter 2 and 12, at the
   uplink's K values (the UL cell's and UL golden's K = 832 and the UCI
   grant's), n_iter 2 and 12, and at the MIMO cell's K values, n_iter 8
   (two code blocks per call, as one two-codeword grant gives), with and
   without a HARQ prior, the bits
   decided on the card by the fused kernel and by the lane decoder over
   the pass kernel equal those of the plain version (the lane decoder
   over the plain twin, on the host), and the fused kernel's LLRs are
   compared too; one pass of the pass kernel and of the twin on the same
   card tensors agrees within 1e-4 * max(1, |x|).  Times, in turns in one
   call, of a whole decode at the loaded cell's main shape (fused, lanes,
   lanes, fused; then the plain version), of one decode at the UL cell's
   shape (K = 832, the code blocks of one batch of 256 subframes, n_iter
   2), of one MIMO-shaped decode at n_iter 8, and of one pass, beside
   their bounds.
2b. the Viterbi kernel against its plain version (the step loop) on the
   same card tensors, bits equal word for word: seeded random LLRs at the
   six payload sizes of one loaded-cell search call (64 subframes x 157
   locations each) in one call, the MIB (D = 40 x 12), all-zero LLRs,
   N = 1 and N not a multiple of the warps per block, groups whose N is
   not a multiple of 32 in one call (a warp holds codewords of one size
   only), the largest D the kernel's shared-memory layout takes (and one
   past it, which must be refused and launch nothing), the noiseless
   round trip of random messages through the port's encoder, and the
   loaded cell's real search over 64 subframes (`make_unified_search`:
   cand_fused through the search entry equals cand_fused through the
   plain step loop on pdcch_derm's LLRs).  Times of one search call's six groups and of the MIB's call:
   kernel, plain, bound (and the bound at the add/compare issue rate),
   with the launch's shared memory per block and warps per SM; the
   search call's time beside the earlier one-warp-per-codeword design's
   and required below it; ptxas registers and spills of both entries
   (none allowed).  From phase 3 on, every path (each of 3-8, the CLI's
   and the runner's processes included) must launch the Viterbi kernel
   (either entry) and run the plain step loop on the card no time.
2c. the two-codeword eq/demap kernel against its plain version (the
   torch chain) on the same card tensors, within rtol 1e-4 plus atol 5e-4
   of the peak (testing/mimo_grants.py): every variant (TM3 / TM4, 2 and
   4 ports, several PMIs, unequal qm, n_re at a 256 boundary and past
   one, 1 and 2 RX) on seeded grids of the MIMO cell's width, and every
   grant of the MIMO cell's first batch through the core (its real grids
   and grants); the largest error; at the cell's most common grant the
   kernel's time (CUDA events and the profiler's device time) beside its
   byte bound and the plain chain's time; one grant's eq/demap step to
   the LLRs on the host, the kernel's against the parent's route (the
   plain chain, the RE index uploaded per grant): CUDA kernels and copies
   under torch.profiler (the kernel's must be 1) and host time per grant.
   Every path from phase 3 on must run the plain chain on the card no
   time; the launches of each path are reported.
2d. the search tail (kernels/pdcch_tail.py) on the loaded cell's first
   64-subframe chunk (its real LLRs through the frontend and the search
   head on the card), on seeded random LLRs at 100 PRB and at a 25-PRB
   4-port cell (7 payload sizes, 31 locations, 17 CCEs: odd counts) and
   on exact-sum (half-integer) LLRs.  The two-launch route (the Viterbi's
   search entry, pdcch_pack) against the earlier three-launch route
   (pdcch_derm, the Viterbi's plain entry, pdcch_crc_pack) on the card:
   every size's bits, the RNTIs, meta and payload words and cand_fused
   word for word, one launch of each kernel; pdcch_pack against its plain
   version on the same words word for word; cand_fused against the plain
   tail on the host (0 words may differ) and on the card (counted; exact
   sums: none).  The yardsticks against their plain versions as before:
   pdcch_derm within DERM_TOL of the LLRs' peak of the plain version on
   the card (cuBLAS orders the einsum's sums by shape; the floats that
   differ are counted, exact sums must be equal) and counted against the
   plain version on the host (MKL's order, the kernel's), no -0;
   pdcch_crc_pack on the same bits word for word.  Times, in turns, by
   CUDA events and by the profiler's device time, beside their bounds:
   the search call (the search entry against the earlier route's
   pdcch_derm plus the plain entry), the pack (pdcch_pack against
   pdcch_crc_pack), the plain versions; one tail call through the two
   kernels, the three-launch route and the plain chain: CUDA kernels,
   copies (the two-launch route's must be 2 and 0) and host time.  From
   phase 3 on every path (the CLI's and the runner's processes included)
   must launch the search entry and pdcch_pack once per search tail,
   pdcch_derm and pdcch_crc_pack no time, and run no plain tail on the
   card; phase 4 prints the constant cache after each of its three
   passes and fails if the third uploads anything; the profiled passes
   fail unless the tail makes 2 launches and 0 copies a call.
2e. the transport-block finish (kernels/tb_finish.py) against its plain
   version on the host, byte for byte (status words and payload bytes):
   one batch of the E-TM 3.1 cell's shape (128 blocks, 320 code blocks of
   K up to 5120) and of the loaded cell's (384 one-code-block blocks),
   with planted faults, and the odd segmentations (fillers, mixed K, 13
   and 16 code blocks, a skipped block); at the E-TM 3.1 shape the
   kernel's time (CUDA events, the profiler's device time) beside its
   byte bound, a batch's upload + launch + read on the host, the plain
   version's time, and the kernel's registers and spills (none allowed).
   From phase 3 on each path's tb_finish launches are reported; the
   loaded cell's must equal its batched dispatches (`pdsch_tb_device`).
2f. the batched single-layer eq/demap (kernels/pdsch_eq.py) against its
   plain version on the same card tensors and on the host, within
   testing/eq_grants.py's tolerance (expected: equal floats), every
   variant in one launch each: PRB-list and table grants of qm 2/4/6/8,
   1/2/4 ports, 1 and 2 RX, centre PRBs at subframes 0 and 5, two slot
   masks, p_a != 1, one batch of the loaded cell (1 and 2 RX) and of the
   E-TM 3.1 cell; the largest absolute and relative error and the floats
   that differ; at the loaded batch the kernel's time (CUDA events, the
   profiler's device time) beside its byte bound, the plain chain's on
   the card (the parent's route), one dispatch's descriptor build +
   upload + launch on the host, registers and spills (none allowed).
   From phase 3 on every path must run the plain eq/demap chain on the
   card no time; each path's launches are reported; the loaded cell's
   must equal its batched dispatches and single-grant decodes.
2g. the batched PDSCH de-rate-match (kernels/csrc/cb_derm.cu) and the
   turbo kernel's packing entry against their plain versions: the
   testing/derm_batches batches (E-TM 3.1, loaded, and one with fillers,
   laps 1-3, rv 0-3, an in-batch retransmission chain and priors stored
   as a LazyRow and as a host array): cb_derm equal to the host's plain
   version float for float and to the card's within DERM_ATOL (the card's
   plain version sums laps in another order), one launch a round; one
   dispatch's code blocks on the card equal to the host's (fused rows,
   combined LLRs), one packing launch a K; the packing entry equal to the
   decoder and `_crc_pack` at the cells' K and the extremes, n_iter 2 and
   12.  Times at one E-TM 3.1 batch of 32 subframes: cb_derm and the
   packing entry (CUDA events, device time) beside their bounds and the
   plain route on the card, one dispatch's code blocks on the host;
   registers and spills (none allowed).  Every later path must run the
   plain de-rate-match on the card no time, and a path that finishes
   blocks on the card must launch both; the profiled DL passes (4b, 5b)
   must run none of `DL_PLAIN_CHAINS`.
3. golden: the golden scenario (tests/golden/dl_mode.pcap), built by the
   port's own generator, run on the card; the pcap's sha256 must equal.
4. loaded cell at full width (20 MHz, 512 subframes, batch 256, with its
   format-2A load) through `LTESnifferCore.run_packed` on the card, held
   against the JAX package's CPU run
   (ltesniffer_tpu_torch/testing/dl_loaded_expected.json): equal
   accepted-DCI list, equal wrong-MIMO count, PDSCH CRC-ok sets differing
   in <= 0.5 % of grants; the resolver must be the native one (its
   `resolve` span is printed); in this run the fused kernel must have
   launched and the pass kernel not.  A second, warm pass gives the
   steady rate (the first pays one-time costs).
5. the 2x2 MIMO cell at full width (20 MHz, 2 ports, 2 RX, 64 subframes,
   TM3 / TM4 two-codeword grants and format-1A grants) on the card, held
   against ltesniffer_tpu_torch/testing/mimo_expected.json the same way;
   every CRC-ok payload must be one the generator sent; the fused kernel
   must have launched and the pass kernel not; the eq/demap kernel must
   have launched once per two-codeword decode (the `p3_mimo` spans) and
   the plain chain not at all; sf/s (first and warm pass) and the host
   reads of the two-codeword path; then warm passes in turns on the
   parent's route (the plain chain, the index uploaded per grant) and on
   the kernel: sf/s and `p3_mimo`.  5b: a profiled MIMO pass.  The
   profiled passes (4b, 5b, 6b) also count the CUDA launches and copies
   of each of the port's launch chains (`CHAINS`: the SISO eq/demap and
   its batched forms, the two-codeword eq/demap, the UL eq/demap, the
   search tail) over the pass; the batched SISO chains
   (`_eq_demap_batch_fn`, `_eq_demap_prb_fn`) must launch nothing.
6. the uplink: the UL golden scenario (tests/golden/ul_mode.pcap), built
   by the port's generator, through `LTESnifferCoreUL.run_dual_samples`
   on the card (sha256 equal); the bench's UL cell at full width (20 MHz,
   1024 subframes, 8 PUSCH grants per subframe, batch 256) through
   `run_dual_packed`, held against the JAX package's CPU run
   (ltesniffer_tpu_torch/testing/ul_expected.json): equal accepted-DCI0
   list and result list, PUSCH CRC-ok flags differing in <= 0.5 % of
   results, every CRC-ok payload one the generator sent, fused launches
   and no pass launch in this run; sf/s (first and warm pass), the host
   spans and reads; the UCI grant (HARQ-ACK + RI + aperiodic CQI on one
   PUSCH) decodes to the transmitted TB.  6b: a profiled UL pass.
7. the live entry point (testing/stream_cell.py; records made by the JAX
   package on the CPU over the same streams):
   7a. the DL stream: the loaded cell behind a 1000-sample noise lead,
       mixed by a 300 Hz CFO, with 2.5 subframes cut at subframe 200, in
       blocks of 3 subframes + 777 samples through
       `LTESnifferCore.run_source` with the CLI's defaults.  The loaded
       cell as it is cannot be acquired (its PDSCH fills the PSS symbol;
       both packages' cell search fails the same way, which is checked);
       the stream run takes the same cell with subframes 0 and 5 free of
       grants.  Held against dl_stream_expected.json: equal accepted-DCI
       list with its SFN labels, CRC-ok flags within 0.5 %, equal
       subframes / resyncs (>= 1) / sync losses and segments, fused
       launches.  First and warm sf/s beside `run_packed`'s warm sf/s on
       the aligned loaded cell at the same batch; the host times of
       `find_cell`, of one tracker pass over the stream, of one
       `_reacquire` and of `run_source`'s framing with the segments
       dropped.
   7b. live mode on the same stream: kept + skipped = 7a's framed count;
       the share of a 1000 sf/s air the port keeps.
   7c. the UL cell's two carriers behind noise leads, the UL 37 samples
       late, through `LTESnifferCoreUL.run_dual_source(ul_skew=37)`, held
       against ul_stream_expected.json as phase 6 holds its run.
   7d. the golden scenario through `run_samples` with ingest i16 and f32
       (depth 3) and i8 at pipeline depths 1 and 2: each pcap's sha256
       equals the JAX package's (ingest_expected.json).
   7e. `python -m ltesniffer_tpu_torch.cli ... --sync` in a subprocess on
       a file of the golden stream behind a 777-sample lead: exit 0, pcap
       sha256 and stats counts equal the JAX CLI's (cli_expected.json).
8. scaling out (the loaded cell's complex stream):
   8a. the split over devices: one batch of 256 subframes at CFI 2
       through `parallel.sharding` (frontend + fixed-CFI search) as 4
       shards on cuda:0 and, with more cards, one shard per card, against
       `pdcch_rx.make_pipeline` on cuda:0 on the same host arrays: shard
       by shard, every output (RNTIs and bits of every payload size, CCE
       powers, SNRs) equal; against the whole batch in one call, CCE
       powers within rtol 1e-4, atol 1e-5 and the native resolver's
       accepted DCIs, payloads included, equal (the noise-only candidates
       whose RNTIs or bits differ are counted); both wall times.
   8b. time blocks: the 512 subframes in 2 blocks with 200 subframes of
       tracker replay (`parallel.multihost.split_blocks` / `run_block`,
       batch 8, port cores on the card), merged, held against
       ltesniffer_tpu_torch/testing/multihost_expected.json (the JAX
       package's merge on the CPU): equal merged accepted-DCI list, CRC-ok
       flags within 0.5 %, as many pcap records differing from the
       single-host run on the card as the JAX package's merge differs from
       its own; fused launches and no pass launch; sf/s per block and for
       the whole run.
   8c. the runner: `python -m ltesniffer_tpu_torch.parallel.run_multihost
       -n 2 --overlap 200` in a subprocess on a file of the stream (one
       OS process per block, child k on cuda:{k % cards}): exit 0, merged
       pcap records equal 8b's; the wall time with start-up.
9. the `kernels` JSON line (`viterbi_tb`'s times are the MIB call's,
   the shape its main-path launches run, with the search call's shape
   under `search_shape`; `viterbi_tb`'s, `viterbi_search`'s,
   `mimo_eq_demap`'s, `pdcch_pack`'s, `pdcch_derm`'s and
   `pdcch_crc_pack`'s entries carry the launches of every path,
   `mimo_eq_demap`'s the launch chains of the profiled passes,
   `viterbi_search`'s phase 2d's cases, the tail call's steps and the
   constant cache of phase 4's passes; `tb_finish`'s phase 2e;
   `pdsch_eq_demap`'s phase 2f and every path's launches; `cb_derm`'s
   phase 2g and every path's launches, `turbo_decode`'s `pack` the packing
   entry's), then the result line.

Imports torch, numpy, the standard library and the port only — no JAX.
Writes only under a temporary directory and ltesniffer_tpu_torch/_build/.
"""
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PCAP = os.path.join(REPO, "tests", "golden", "dl_mode.pcap")
GOLDEN_UL_PCAP = os.path.join(REPO, "tests", "golden", "ul_mode.pcap")
EXPECTED = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                        "dl_loaded_expected.json")
EXPECTED_MIMO = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                             "mimo_expected.json")
EXPECTED_UL = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                           "ul_expected.json")
EXPECTED_DL_STREAM = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                                  "dl_stream_expected.json")
EXPECTED_UL_STREAM = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                                  "ul_stream_expected.json")
EXPECTED_INGEST = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                               "ingest_expected.json")
EXPECTED_CLI = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                            "cli_expected.json")
EXPECTED_MULTIHOST = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                                  "multihost_expected.json")
SHARD_BATCH = 256                # phase 8a: one batch of the loaded cell
SHARD_CFI = 2                    # the loaded cell's CFI
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-5   # tests/test_sharding.py:52-53
MIMO_BATCH = 32                  # as the expected record was made
MIMO_N_ITER = 8                  # decode_grant_mimo's turbo iterations
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
# 67 TFLOP/s counts an FMA as two operations: adds and compares alone
# issue at most 128 a cycle on each of the 132 SMs at 1.98 GHz
F32_ADD_OPS_PER_S = 128 * 132 * 1.98e9
# the Viterbi kernel's earlier design (one warp per codeword) at one
# search call's shape: NVIDIA H100 80GB HBM3, 700 W (PERF.md, section 6)
VITERBI_WARP_DESIGN_MS = 0.6531
BCJR_TOL = 1e-4                  # |kernel - twin| <= 1e-4 * max(1, |twin|)
CRC_DIFF_MAX = 0.005             # share of results whose CRC-ok may differ
BCJR_REPLACES = "ltesniffer_tpu/kernels/turbo_pallas.py:125"
# the fused kernel replaces the same TPU kernel together with its caller
# ltesniffer_tpu/kernels/turbo.py:255 (_make_decoder_pallas)
TURBO_REPLACES = "ltesniffer_tpu/kernels/turbo_pallas.py:125"
# XLA, not Pallas: _acs_scan (:56) and _traceback (:82), reached through
# viterbi_decode_tb (:98) and viterbi_decode_tb_multi (:119)
VITERBI_REPLACES = "ltesniffer_tpu/kernels/viterbi.py:56"
# XLA, not Pallas: the jitted two-codeword eq/demap program
MIMO_EQ_REPLACES = "ltesniffer_tpu/sniffer/pdsch_rx.py:130"
# XLA, not Pallas: the de-rate-match (:81-87) and the CRC / packing
# (:89-149) of _candidate_decode_tail (:71), inside run_from_grids' jit
DERM_REPLACES = "ltesniffer_tpu/sniffer/pdcch_rx.py:81"
PACK_REPLACES = "ltesniffer_tpu/sniffer/pdcch_rx.py:89"
# the search entry replaces the de-rate-match with the Viterbi
SEARCH_REPLACES = "ltesniffer_tpu/sniffer/pdcch_rx.py:81"
# no TPU kernel: the JAX package finishes the blocks on the host
# (finish_grants_batch :860, _assemble_tb :920, escalate_finish :1022)
TB_FINISH_REPLACES = "ltesniffer_tpu/sniffer/pdsch_rx.py:860 (host code)"
PDSCH_EQ_REPLACES = ("ltesniffer_tpu/sniffer/pdsch_rx.py:294 _eq_demap_batch_fn"
                     ", :336 _reorg_fn, :357 _eq_demap_prb_fn (XLA)")
# XLA, not Pallas: the de-rate-match of _derm_turbo_static_fn; the packing
# entry takes _crc_pack (:489) into the turbo kernel
CB_DERM_REPLACES = "ltesniffer_tpu/sniffer/pdsch_rx.py:468 (XLA)"
# the earlier route's times at one search call of the loaded cell: the
# Viterbi's plain entry, pdcch_derm (CUDA events) and pdcch_crc_pack
# (device time a launch): NVIDIA H100 80GB HBM3, 700 W (PERF.md, section 6)
EARLIER_VITERBI_MS, EARLIER_DERM_MS, EARLIER_PACK_DEVICE_MS = \
    0.1844, 0.0676, 0.016
# pdcch_derm against cuBLAS's einsum: a sum of at most 7 repetitions in
# another order moves by at most 2 * 6 * 2^-24 * 7 * peak = 5.0e-6 * peak
DERM_TOL = 1e-5


def log(msg: str):
    print(msg, flush=True)


class Phase:
    """Prints a phase's name and wall time; re-raises its failure."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, typ, val, tb):
        dt = time.perf_counter() - self.t0
        log(f"== {self.name}: {'ok' if typ is None else 'FAILED'} "
            f"({dt:.2f} s)")
        return False


def no_card() -> bool:
    """True, with a message, where torch sees no CUDA device."""
    import torch
    if torch.cuda.is_available():
        return False
    print("chip_smoke: no CUDA device; this script runs on the card only",
          file=sys.stderr)
    return True


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenarios (the port's own generator)
# ---------------------------------------------------------------------------
def ul_golden_scenario():
    """tests/test_golden_replay.py:_build_dual, through the port:
    (cell, DL stream, UL stream)."""
    import numpy as np
    from ltesniffer_tpu_torch.phy import tables
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.testing import scenario
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    sb = scenario.DualScenarioBuilder(cell, cfi=2, seed=20260821)
    rng = np.random.default_rng(99)
    _, itbs = tables.ul_mcs_to_qm_itbs(6)
    tbs = tables.tbs_lookup(itbs, 8)
    for j in range(30):
        txs = [scenario.UlTx(rnti=0x600 + (j % 4), prb_start=4, n_prb=8,
                             mcs=6, tb_bits=rng.integers(0, 2, tbs)
                             .astype(np.uint8))]
        sb.add_subframe(j % 10, txs, strict=False)
    dl, ul = sb.streams()
    return cell, dl, ul


def code_block_sizes(truth) -> dict:
    """{K: code blocks} the decoder sees over a scenario's transport
    blocks: each TB's own size, and the 64QAM-table size the sniffer tries
    first for a UE whose table it has not learned yet."""
    from ltesniffer_tpu_torch.phy import tables, turbo as turbo_host
    out = {}
    for t in truth:
        tbss = {t["tbs"]}
        if t.get("mcs") is not None and t["tbs"] > 0:
            _, itbs = tables.dl_mcs_to_qm_itbs(t["mcs"], False)
            if itbs >= 0:
                tbss.add(tables.tbs_lookup(itbs, 8))
        for tbs in tbss:
            for K in turbo_host.segment_sizes(tbs).K:
                out[K] = out.get(K, 0) + 1
    return out


def grant_blocks(K: int, truth) -> int:
    """Code blocks of size K that one two-codeword grant of the scenario
    decodes in one call (both codewords), the most common such count."""
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    per = {}
    for t in truth:
        key = (t["sf"], t["rnti"])
        per[key] = per.get(key, 0) + \
            turbo_host.segment_sizes(t["tbs"]).K.count(K)
    counts = [n for n in per.values() if n]
    return max(set(counts), key=counts.count) if counts else 1


# ---------------------------------------------------------------------------
# phase 2: the BCJR kernel against its plain twin
# ---------------------------------------------------------------------------
def turbo_llrs(K: int, B: int, rng):
    """B random turbo-coded blocks of size K: (sent bits (B, K), a noisy
    observation (B, 3, K+4), and a weaker second observation of the same
    code words, the HARQ prior a retransmission combines with)."""
    import numpy as np
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.stack([turbo_host.turbo_encode(b) for b in bits])
    x = 1.0 - 2.0 * d.astype(np.float32)
    noise = rng.normal(size=(2,) + x.shape).astype(np.float32)
    return (bits, (1.6 * x + noise[0]).astype(np.float32),
            (0.8 * x + noise[1]).astype(np.float32))


def time_cuda(fn, n: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bcjr_bound_ms(W: int, L: int):
    """Least time for one pass on the card: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    from ltesniffer_tpu_torch.kernels import bcjr
    t_bytes = bcjr.bytes_moved(W, L) / HBM_BYTES_PER_S * 1e3
    # per lane and step: forward 4 gammas + 16 add + 8 max + 8 sub, and
    # backward 1 add + 4 gammas + 32 add + 24 max + 2 sub + 8 sub
    ops = (36 + 71) * W * L
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_decoders(ks: dict, device, rng, iters=(2, 12),
                   blocks=None) -> dict:
    """Fused kernel and lane decoder over the pass kernel, both on the card,
    vs the plain version on the host: decided bits (per K, n_iter, prior),
    the fused kernel's LLRs; one pass of the pass kernel at the main-path
    shape of each K.  `blocks` fixes the code blocks per call (else the
    main path's count, 8 to 256).  Returns each kernel's max |error|."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode
    err = {"bcjr": 0.0, "turbo_decode": 0.0}
    for K in sorted(ks):
        B = blocks or max(8, min(ks[K], 256))
        sent, llr, prior = turbo_llrs(K, B, rng)
        for n_iter in iters:
            for with_prior in (False, True):
                d = llr + prior if with_prior else llr
                b_host, l_host = turbo.make_decoder(K, n_iter)(
                    torch.from_numpy(d))
                b_host = b_host.numpy()
                d_card = torch.from_numpy(d).to(device)
                b_fused, l_fused = turbo.make_decoder(K, n_iter)(d_card)
                b_lanes, _ = turbo.make_decoder_lanes(K, n_iter)(d_card)
                for name, b in (("fused kernel", b_fused),
                                ("lane decoder + pass kernel", b_lanes)):
                    b = b.cpu().numpy()
                    if not np.array_equal(b, b_host):
                        n = int((b != b_host).sum())
                        raise AssertionError(
                            f"K={K} n_iter={n_iter} prior={with_prior}: "
                            f"{n} bits of the {name} differ from the plain "
                            "version")
                e = float((l_fused.cpu() - l_host).abs().max())
                err["turbo_decode"] = max(err["turbo_decode"], e)
                ber = float((b_host != sent).mean())
                log(f"  K={K:5d} B={B:4d} n_iter={n_iter:2d} "
                    f"prior={int(with_prior)}: fused and lanes bits equal "
                    f"plain; fused max |LLR err| {e:.3e}; BER vs sent "
                    f"{ber:.2e}")
        # one pass on the card: kernel vs twin on the same card tensors
        W = turbo_decode.window_len(K)
        L = turbo._lane_consts(K, B)["L"]
        g = torch.Generator(device="cpu").manual_seed(K)
        ins = [torch.randn((W, L), generator=g) * 4.0 for _ in range(3)]
        ins += [torch.randn((8, L), generator=g) * 4.0 for _ in range(2)]
        ins = [x.to(device).contiguous() for x in ins]
        got = bcjr.bcjr_cuda(*ins)
        want = bcjr.bcjr_plain(*ins)
        for name, a, b in zip(("ext", "a_end", "b_start"), got, want):
            e = (a - b).abs()
            lim = BCJR_TOL * torch.clamp(b.abs(), min=1.0)
            if bool((e > lim).any()):
                raise AssertionError(f"K={K} pass {name}: max |err| "
                                     f"{float(e.max()):.3e} over tol")
            err["bcjr"] = max(err["bcjr"], float(e.max()))
    return err


def fused_bound_ms(K: int, B: int, n_iter: int):
    """Least time for one decode on the card: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    from ltesniffer_tpu_torch.kernels import turbo_decode
    t_bytes = turbo_decode.bytes_moved(K, B) / HBM_BYTES_PER_S * 1e3
    t_ops = turbo_decode.ops(K, B, n_iter) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_decoders(K: int, B: int, device, rng, iters=(2, 12)) -> dict:
    """Whole-decode times at (K, B) for each n_iter: the fused kernel and
    the earlier design (lane decoder over the pass kernel) in turns (fused,
    lanes, lanes, fused), the plain version on the card, the bound."""
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo
    _, llr, _ = turbo_llrs(K, B, rng)
    d = torch.from_numpy(llr).to(device)
    out = {}
    for n_iter in iters:
        fused = turbo.make_decoder(K, n_iter)
        lanes = turbo.make_decoder_lanes(K, n_iter)
        plain = turbo.make_decoder_lanes(K, n_iter, bcjr.bcjr_plain)
        t_f1 = time_cuda(lambda: fused(d), n=20)
        t_l1 = time_cuda(lambda: lanes(d), n=5)
        t_l2 = time_cuda(lambda: lanes(d), n=5)
        t_f2 = time_cuda(lambda: fused(d), n=20)
        t_p = time_cuda(lambda: plain(d), n=2)
        bound, by = fused_bound_ms(K, B, n_iter)
        out[n_iter] = dict(ms=min(t_f1, t_f2), ms_turns=[t_f1, t_f2],
                           lanes_ms=min(t_l1, t_l2),
                           lanes_turns=[t_l1, t_l2], plain_ms=t_p,
                           bound_ms=bound, bound_by=by)
    return out


def time_bcjr(K: int, B: int, device) -> dict:
    """Kernel, twin and bound times of one pass at the shape the main
    path gives K with B code blocks in one call."""
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode
    W = turbo_decode.window_len(K)
    L = turbo._lane_consts(K, B)["L"]
    g = torch.Generator(device="cpu").manual_seed(1)
    ins = [(torch.randn((W, L), generator=g) * 4.0).to(device)
           for _ in range(3)]
    ins += [(torch.randn((8, L), generator=g) * 4.0).to(device)
            for _ in range(2)]
    ms = time_cuda(lambda: bcjr.bcjr_cuda(*ins), n=50)
    plain_ms = time_cuda(lambda: bcjr.bcjr_plain(*ins), n=5)
    bound_ms, bound_by = bcjr_bound_ms(W, L)
    return dict(K=K, W=W, L=L, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 2b: the Viterbi kernel against its plain version
# ---------------------------------------------------------------------------
def search_chunk() -> int:
    """Subframes per blind-search call, as the core chunks them."""
    from ltesniffer_tpu_torch.sniffer import core
    return core.LTESnifferCore.SEARCH_CHUNK


def search_shapes(cell) -> list:
    """(N, D) of the groups one blind-search call of search_chunk()
    subframes hands the Viterbi: every location at every payload size."""
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    st = pdcch_rx.make_unified_search(cell)[1]
    return [(search_chunk() * len(st["locs"]), D)
            for D in st["size_order"]]


def viterbi_equal(name: str, groups, host_rows: int = 0) -> int:
    """One call of the kernel and of the plain version on the same card
    tensors: bits equal word for word, one launch counted.  With
    `host_rows`, the kernel's first rows of each group are also held
    against the plain version on the host (logged, not required).
    Returns the largest |kernel bit - plain bit|."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import viterbi
    n0 = viterbi.LAUNCHES["viterbi"]
    got = viterbi.viterbi_decode_tb_multi(groups)
    torch.cuda.synchronize()
    if viterbi.LAUNCHES["viterbi"] != n0 + 1:
        raise AssertionError(f"{name}: the call launched the Viterbi kernel "
                             f"{viterbi.LAUNCHES['viterbi'] - n0} times")
    want = viterbi.viterbi_decode_tb_multi_plain(groups)
    n_cw, err = 0, 0
    for x, a, b in zip(groups, got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        err = max(err, int(np.abs(a.astype(np.int16) - b).max()))
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{name}: D={x.shape[2]}: {int((a != b).any(-1).sum())} of "
                f"{len(a)} codewords of the kernel differ from the plain "
                "version on the card")
        n_cw += len(a)
    note = ""
    if host_rows:
        h = viterbi.viterbi_decode_tb_multi_plain(
            [x[:host_rows].cpu() for x in groups])
        n_h = sum(int((g[:host_rows].cpu().numpy() != w.numpy()).any(-1)
                      .sum()) for g, w in zip(got, h))
        note = (f"; against the plain version on the host, {n_h} of "
                f"{host_rows * len(groups)} codewords differ")
    log(f"  {name}: {len(groups)} group(s), D {[x.shape[2] for x in groups]}"
        f", {n_cw} codewords: kernel bits equal the plain version's on the "
        f"card{note}")
    return err


def check_viterbi(device, loaded_stream, rng) -> dict:
    """Phase 2b: the cases of the kernel against the plain version, the
    real search's cand_fused through both routes, and the times at one
    search call's shape."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi
    from ltesniffer_tpu_torch.sniffer import frontend, pdcch_rx
    from ltesniffer_tpu_torch.testing import loaded_cell
    cell = loaded_cell.CELL
    shapes = search_shapes(cell)

    def llrs(shp, scale=2.0):
        return [torch.from_numpy((scale * rng.standard_normal((n, 3, d)))
                                 .astype(np.float32)).to(device)
                for n, d in shp]
    main = llrs(shapes)
    err = viterbi_equal("search call, seeded random LLRs", main,
                        host_rows=157)
    err = max(err, viterbi_equal("MIB, D=40 x 12", llrs([(12, 40)]),
                                 host_rows=12))
    err = max(err, viterbi_equal(
        "all-zero LLRs (every state ties)",
        [torch.zeros((5, 3, d), device=device) for _, d in shapes]))
    err = max(err, viterbi_equal(
        "N=1 and N not a multiple of the warps per block",
        llrs([(1, 31), (7, 44), (1, 67), (5, 40)])))
    err = max(err, viterbi_equal(
        "groups whose N is not a multiple of 32 (no warp straddles sizes)",
        llrs([(33, 31), (1, 67), (63, 44)])))
    d_max = viterbi.max_d(32)
    err = max(err, viterbi_equal(f"the largest D the layout takes, "
                                 f"{d_max}", llrs([(40, d_max)])))
    n0 = viterbi.LAUNCHES["viterbi"]
    try:
        viterbi.viterbi_decode_tb_multi(llrs([(4, d_max + 1)]))
    except RuntimeError as e:
        if "cudaError 1 " not in str(e):
            raise
    else:
        raise AssertionError(f"D={d_max + 1} past the layout's limit "
                             "launched")
    if viterbi.LAUNCHES["viterbi"] != n0:
        raise AssertionError("a refused call counted a launch")
    log(f"  D={d_max + 1}, one past the limit: refused (cudaError 1), "
        "nothing launched")
    msgs = torch.from_numpy(rng.integers(0, 2, (4096, 67)).astype(np.uint8))
    coded = viterbi.conv_encode_tb(msgs.to(device))
    rt = [1.0 - 2.0 * coded.to(torch.float32)]
    err = max(err, viterbi_equal(
        "noiseless round trip through the port's encoder", rt))
    if not np.array_equal(viterbi.viterbi_decode_tb(rt[0]).cpu().numpy(),
                          msgs.numpy()):
        raise AssertionError("the round trip did not return the messages")
    # one chunk of the loaded cell's real search, through both routes
    n, chunk = cell.sf_len, search_chunk()
    x = loaded_stream[:chunk * n].reshape(chunk, 1, n)
    sf = torch.arange(chunk, device=device) % 10
    fe = frontend.make_frontend(cell).run(x, sf, device)
    run, _ = pdcch_rx.make_unified_search(cell)

    def search():
        out = run(fe["grids"], fe["h"], fe["noise_var"], fe["snr_db"], sf,
                  fe["cfi"] - 1, fe["scalars"])["cand_fused"]
        return out.cpu().numpy()
    got = search()
    # the plain step loop on pdcch_derm's LLRs, in the tail's place
    saved = viterbi.viterbi_decode_tb_multi, pdcch_tail.decode_tail_cuda
    viterbi.viterbi_decode_tb_multi = viterbi.viterbi_decode_tb_multi_plain
    pdcch_tail.decode_tail_cuda = \
        lambda *a, **k: pdcch_tail.decode_tail_three(*a[:6])
    p0 = viterbi.PLAIN_CUDA["viterbi"]
    try:
        want = search()
    finally:
        viterbi.viterbi_decode_tb_multi, pdcch_tail.decode_tail_cuda = saved
    if viterbi.PLAIN_CUDA["viterbi"] != p0 + 1:
        raise AssertionError("the real search's yardstick did not run the "
                             "plain step loop")
    if not np.array_equal(got, want):
        raise AssertionError(f"real search: {int((got != want).sum())} "
                             "cand_fused words differ between the kernel "
                             "and the plain step loop")
    log(f"  the loaded cell's search over {chunk} subframes: "
        f"cand_fused {got.shape} through the kernel's search entry equals "
        "it through the plain step loop on pdcch_derm's LLRs, word for "
        "word")
    # times at the main shape (one search call's six groups) and at the
    # MIB's, in turns
    out = time_viterbi(main, shapes)
    out.update(shapes=shapes, err=err, d_max=d_max,
               mib=time_viterbi(llrs([(12, 40)]), [(12, 40)]))
    return out


def time_viterbi(groups, shapes) -> dict:
    """Kernel (twice, in turns around the plain version), plain step loop
    and bounds of one call, with its launch's occupancy."""
    from ltesniffer_tpu_torch.kernels import viterbi
    t_k1 = time_cuda(lambda: viterbi.viterbi_decode_tb_multi(groups), n=20)
    t_p = time_cuda(lambda: viterbi.viterbi_decode_tb_multi_plain(groups),
                    n=3)
    t_k2 = time_cuda(lambda: viterbi.viterbi_decode_tb_multi(groups), n=20)
    t_bytes = viterbi.bytes_moved(shapes) / HBM_BYTES_PER_S * 1e3
    t_ops = viterbi.ops(shapes) / F32_OPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    return dict(ms=min(t_k1, t_k2), ms_turns=[t_k1, t_k2], plain_ms=t_p,
                bound_ms=bound, bound_by=by,
                add_bound_ms=viterbi.ops(shapes) / F32_ADD_OPS_PER_S * 1e3,
                ops=viterbi.ops(shapes), bytes=viterbi.bytes_moved(shapes),
                **viterbi.occupancy(shapes))


def report_viterbi(tv: dict, card: str):
    """Logs phase 2b's times, bounds, occupancy and ptxas report, and
    fails on spills or on a search call not below the earlier design's
    time.  Adds `registers` and `spill_bytes` to tv."""
    from ltesniffer_tpu_torch.kernels import nvcc_build
    rep = {fn: (r, st_, ld_) for fn, r, st_, ld_ in
           nvcc_build.ptxas_report("viterbi_tb")}
    (regs, st, ld), = [v for fn, v in rep.items() if "viterbi_tb_kernel" in fn]
    (s_regs, s_st, s_ld), = [v for fn, v in rep.items()
                             if "viterbi_search_kernel" in fn]
    tv.update(registers=regs, spill_bytes=st + ld,
              search_registers=s_regs, search_spill_bytes=s_st + s_ld)
    for what, t, shp in (("one search call", tv, tv["shapes"]),
                         ("the MIB", tv["mib"], [(12, 40)])):
        g = ", ".join(f"{n}x{d}" for n, d in shp)
        log(f"  {what} ({g}; {t['ops']:.4g} float32 operations, "
            f"{t['bytes']:.4g} bytes) on {card}: kernel {t['ms']:.4f} ms "
            f"(turns {t['ms_turns'][0]:.4f}, {t['ms_turns'][1]:.4f}); plain "
            f"step loop {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms"
            f" ({t['bound_by']}: max(ops / 67 TFLOP/s, bytes / 3.35 TB/s)),"
            f" {100 * t['bound_ms'] / t['ms']:.1f} % of it; adds and "
            f"compares at 33.5 T/s {t['add_bound_ms']:.4f} ms, "
            f"{100 * t['add_bound_ms'] / t['ms']:.1f} % of it; "
            f"{t['smem_per_block']} bytes of shared memory a block of 32 "
            f"codewords, {t['warps_per_sm']} warps an SM")
    log(f"  one search call: {tv['ms']:.4f} ms against "
        f"{VITERBI_WARP_DESIGN_MS} ms for the earlier design (one warp per "
        f"codeword, H100 80GB HBM3 at 700 W), "
        f"{VITERBI_WARP_DESIGN_MS / tv['ms']:.2f}x; ptxas {regs} registers, "
        f"{st} / {ld} bytes spill stores / loads; no PyTorch call computes "
        "a Viterbi decode, so there is no library time")
    log(f"  the search entry: ptxas {s_regs} registers, {s_st} / {s_ld} "
        "bytes spill stores / loads")
    if st or ld or s_st or s_ld:
        raise AssertionError("the Viterbi kernel spills registers")
    if tv["ms"] >= VITERBI_WARP_DESIGN_MS:
        raise AssertionError(
            f"the Viterbi kernel takes {tv['ms']:.4f} ms a search call, not "
            f"below the earlier design's {VITERBI_WARP_DESIGN_MS} ms")


# ---------------------------------------------------------------------------
# phase 2c: the two-codeword eq/demap kernel against its plain version
# ---------------------------------------------------------------------------
def grant_kind(a) -> tuple:
    """(tm, ports, pmi, qm0, qm1, n_pad, rx) of eq_demap_mimo's args."""
    grid, h, _, idx, _, _, tm, pmi, qm0, qm1 = a
    return (tm, int(h.shape[1]), pmi, qm0, qm1, int(idx.shape[0]),
            int(grid.shape[0]))


def profile_step(step) -> dict:
    """One call of `step` (warmed first) under torch.profiler: the launch
    and memory-copy calls its host made to the CUDA runtime inside the
    step's range (`launches`, `copies`), and the device's records: CUDA
    kernels, host-to-device and device-to-host copies, the kernels'
    device time.  The checks read the host's calls: the device's records
    of one short profile have lost one kernel, or gained one from outside
    the step, on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        torch.cuda.synchronize()
        with record_function("profile_step"):
            step()
            torch.cuda.synchronize()
    out = dict(launches=0, copies=0, kernels=0, h2d=0, d2h=0, other=0,
               device_ms=0.0)
    evs = list(p.events())
    rng = [(e.time_range.start, e.time_range.end) for e in evs
           if e.name == "profile_step" and e.device_type == DeviceType.CPU]
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            if not any(a <= e.time_range.start <= b for a, b in rng):
                continue
            if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
                out["launches"] += 1
            elif e.name.startswith("cudaMemcpy"):
                out["copies"] += 1
            continue
        if "HtoD" in e.name:
            out["h2d"] += 1
        elif "DtoH" in e.name:
            out["d2h"] += 1
        elif "Memcpy" in e.name or "Memset" in e.name:
            out["other"] += 1
        else:
            out["kernels"] += 1
            out["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def host_step_ms(step, n: int = 50) -> float:
    """Host clock per call of `step`, each call ending in
    torch.cuda.synchronize()."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


class parent_route:
    """With `on`, the two-codeword path runs as before the eq/demap kernel:
    the plain chain on the card, the grant's RE index uploaded per grant
    (sniffer/pdsch_rx.py's cache emptied before each use)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from ltesniffer_tpu_torch.kernels import mimo_eq
        from ltesniffer_tpu_torch.sniffer import pdsch_rx
        self.saved = (mimo_eq.eq_demap_mimo, pdsch_rx._mimo_re_index)
        if self.on:
            index = pdsch_rx._mimo_re_index

            def uncached(*a):
                pdsch_rx._mimo_index.cache_clear()
                return index(*a)
            mimo_eq.eq_demap_mimo = mimo_eq.eq_demap_mimo_plain
            pdsch_rx._mimo_re_index = uncached
        return self

    def __exit__(self, *exc):
        from ltesniffer_tpu_torch.kernels import mimo_eq
        from ltesniffer_tpu_torch.sniffer import pdsch_rx
        mimo_eq.eq_demap_mimo, pdsch_rx._mimo_re_index = self.saved
        return False


def check_mimo_eq(device, m_words, m_scales, tmp: str, card: str) -> dict:
    """Phase 2c: the kernel against the plain version on every variant of
    testing/mimo_grants.py at the MIMO cell's width and on every grant of
    the cell's first batch (its real grids, through the core); its time
    beside its bound at the cell's most common grant; one grant's eq/demap
    step, the kernel's against the parent's route (the plain chain with the
    RE index uploaded per grant): CUDA kernels and copies under
    torch.profiler, and host time per grant."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import mimo_eq
    from ltesniffer_tpu_torch.testing import mimo_cell, mimo_grants
    err = 0.0
    for v in mimo_grants.VARIANTS:
        tm, _, pmi, qm0, qm1, _, _ = v
        inp = mimo_grants.random_grant(v, seed=13, n_sc=mimo_cell.CELL.n_sc)
        ts = mimo_grants.tensors(inp, device)
        n0 = mimo_eq.LAUNCHES["mimo_eq_demap"]
        got = mimo_eq.eq_demap_mimo(*ts, *inp[4], tm, pmi, qm0, qm1)
        torch.cuda.synchronize()
        if mimo_eq.LAUNCHES["mimo_eq_demap"] != n0 + 1:
            raise AssertionError(f"{mimo_grants.variant_id(v)}: the call "
                                 "did not launch the kernel once")
        want = mimo_eq.eq_demap_mimo_plain(*ts, *inp[4], tm, pmi, qm0, qm1)
        e, ok = mimo_grants.max_err(got, want)
        n_diff = int((got != want).sum())
        log(f"  {mimo_grants.variant_id(v)}: largest |kernel - plain| {e:.3g}"
            f" ({n_diff} of {got.numel()} floats not equal)")
        if not ok:
            raise AssertionError(f"{mimo_grants.variant_id(v)}: kernel "
                                 "outside the tolerance of the plain version")
        err = max(err, e)
    # the MIMO cell's first batch through the core: every grant's call held
    real = mimo_eq.eq_demap_mimo
    seen = dict(n=0, err=0.0, diff=0, floats=0, bad=[], kinds={})

    def held(*a):
        got = real(*a)
        want = mimo_eq.eq_demap_mimo_plain(*a)
        e, ok = mimo_grants.max_err(got, want)
        k = grant_kind(a)
        if not ok:
            seen["bad"].append((k, e))
        seen["n"] += 1
        seen["err"] = max(seen["err"], e)
        seen["diff"] += int((got != want).sum())
        seen["floats"] += got.numel()
        if k not in seen["kinds"]:
            seen["kinds"][k] = [0, tuple(x.clone() if isinstance(
                x, torch.Tensor) else x for x in a)]
        seen["kinds"][k][0] += 1
        return got
    mimo_eq.eq_demap_mimo = held
    try:
        run_loaded(device, m_words[:MIMO_BATCH], m_scales[:MIMO_BATCH], tmp,
                   batch_size=MIMO_BATCH, cell=mimo_cell.CELL)
    finally:
        mimo_eq.eq_demap_mimo = real
    kinds = sorted(seen["kinds"].items(), key=lambda kv: -kv[1][0])
    log(f"  the MIMO cell's first {MIMO_BATCH} subframes: {seen['n']} grants "
        f"held, largest |kernel - plain| {seen['err']:.3g} ({seen['diff']} of "
        f"{seen['floats']} floats not equal); kinds (tm, ports, pmi, qm0, "
        f"qm1, n_pad, rx): {[(k, n) for k, (n, _) in kinds]}")
    if seen["bad"] or seen["n"] == 0:
        raise AssertionError(f"real grants: {len(seen['bad'])} outside the "
                             f"tolerance {seen['bad'][:5]}, {seen['n']} held")
    err = max(err, seen["err"])
    # times at the cell's most common grant
    kind, (_, a) = kinds[0]
    tm, ports, pmi, qm0, qm1, n_pad, rx = kind
    t_k1 = time_cuda(lambda: mimo_eq.eq_demap_mimo(*a), n=200)
    t_p = time_cuda(lambda: mimo_eq.eq_demap_mimo_plain(*a), n=20)
    t_k2 = time_cuda(lambda: mimo_eq.eq_demap_mimo(*a), n=200)
    n_re = int(torch.unique(a[3]).numel())
    nbytes = mimo_eq.bytes_moved(n_re, n_pad, rx, ports, qm0, qm1)
    nops = mimo_eq.ops(n_pad, rx, ports, tm, qm0, qm1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    # one grant's eq/demap step as decode_grant_mimo runs it, to the LLRs
    # on the host: the kernel (the RE index cached on the card) against
    # the parent's route (the plain chain, the index uploaded per grant)
    idx_host = a[3].cpu().numpy()

    def kernel_step():
        return mimo_eq.eq_demap_mimo(*a).cpu()

    def parent_step():
        idx = torch.from_numpy(idx_host).to(a[3].device)
        return mimo_eq.eq_demap_mimo_plain(*a[:3], idx, *a[4:]).cpu()
    pk, pp = profile_step(kernel_step), profile_step(parent_step)
    hk1, hp1 = host_step_ms(kernel_step), host_step_ms(parent_step)
    hp2, hk2 = host_step_ms(parent_step), host_step_ms(kernel_step)
    log(f"  the cell's most common grant {kind} (n_re {n_re}; {nbytes} bytes,"
        f" {nops} float32 operations) on {card}: kernel {min(t_k1, t_k2):.4f} "
        f"ms (turns {t_k1:.4f}, {t_k2:.4f}; CUDA events over back-to-back "
        f"calls of the wrapper, whose host work sets the pace); its device "
        f"time {pk['device_ms']:.4f} ms (profiler); plain chain {t_p:.4f} ms;"
        f" bound {bound:.6f} ms ({by}: max(bytes / 3.35 TB/s, ops / 67 "
        f"TFLOP/s)); no PyTorch call computes this function, so there is no"
        f" library time")
    log(f"  one grant's eq/demap step to the LLRs on the host, kernel against"
        f" the parent's route: kernel launches {pk['launches']} / "
        f"{pp['launches']} by the host; the device's records: CUDA kernels "
        f"{pk['kernels']} / {pp['kernels']}"
        f", host-to-device copies {pk['h2d']} / {pp['h2d']}, device-to-host "
        f"{pk['d2h']} / {pp['d2h']}, other copies and sets {pk['other']} / "
        f"{pp['other']}; device time {pk['device_ms']:.4f} / "
        f"{pp['device_ms']:.4f} ms; host clock per grant (synchronized) "
        f"{hk1:.4f}, {hk2:.4f} / {hp1:.4f}, {hp2:.4f} ms (turns)")
    if pk["launches"] + pp["launches"] == 0:
        log("  launches per step: not measured (the profiler saw none)")
    elif pk["launches"] != 1:
        raise AssertionError(f"the kernel's step launched {pk['launches']} "
                             "CUDA kernels, not 1")
    return dict(err=err, ms=min(t_k1, t_k2), ms_turns=[t_k1, t_k2],
                plain_ms=t_p, bound_ms=bound, bound_by=by, bytes=nbytes,
                ops=nops, device_ms=pk["device_ms"],
                shape=dict(zip(("tm", "ports", "pmi", "qm0", "qm1", "n_pad",
                                "rx"), kind), n_re=n_re),
                real_grants=seen["n"], variants=len(mimo_grants.VARIANTS),
                step={"kernel": pk, "parent": pp,
                      "host_ms": {"kernel": [hk1, hk2],
                                  "parent": [hp1, hp2]}})


# ---------------------------------------------------------------------------
# phase 2d: the search tail's two kernels against their plain versions
# ---------------------------------------------------------------------------
def tail_args(cell, device, B: int, rng, half_integer: bool = False):
    """Seeded random inputs of one tail call of `cell`'s unified search:
    (llr, cce_power, scalars, size_consts, n_loc, B) on the card."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    st = pdcch_rx._static_maps(cell, 3)
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    if half_integer:           # every de-rate-match sum exact in any order
        llr = rng.integers(-12, 13, (B, n_bits)) / 2.0
    else:
        llr = 3.0 * rng.standard_normal((B, n_bits))
        llr[:, ::7] *= 0.0     # +-0, as beyond a subframe's region
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(device) for x in (
        llr, np.abs(rng.standard_normal((B, st["nof_cce"]))),
        rng.standard_normal((B, 4)))]
    return (t[0], t[1], t[2], pdcch_rx._size_consts_of(st),
            len(st["locs"]), B)


def loaded_tail_args(device, loaded_stream) -> tuple:
    """The tail's inputs of the loaded cell's search over its first chunk
    (the frontend and the search head on the card)."""
    import torch
    from ltesniffer_tpu_torch.sniffer import frontend, pdcch_rx
    from ltesniffer_tpu_torch.testing import loaded_cell
    cell = loaded_cell.CELL
    n, chunk = cell.sf_len, search_chunk()
    x = loaded_stream[:chunk * n].reshape(chunk, 1, n)
    sf = torch.arange(chunk, device=device) % 10
    fe = frontend.make_frontend(cell).run(x, sf, device)
    run, _ = pdcch_rx.make_unified_search(cell)
    seen = {}
    real = pdcch_rx._candidate_decode_tail

    def spy(*a, **k):
        seen["args"] = (*a[:5], k.get("scalars"))
        return real(*a, **k)
    pdcch_rx._candidate_decode_tail = spy
    try:
        run(fe["grids"], fe["h"], fe["noise_var"], fe["snr_db"], sf,
            fe["cfi"] - 1, fe["scalars"])
    finally:
        pdcch_rx._candidate_decode_tail = real
    llr, cce, sc, n_loc, B, scal = seen["args"]
    return llr.contiguous(), cce.contiguous(), scal.contiguous(), sc, \
        n_loc, B


def derm_held(name: str, a) -> dict:
    """pdcch_derm against its plain version on one input: one launch;
    against the plain version on the card within DERM_TOL of the LLRs'
    peak (cuBLAS orders the einsum's sums by shape; exact-sum inputs must
    be equal), the differing floats counted; against the plain version on
    the host (MKL's order, the kernel's) counted; no -0."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import pdcch_tail
    llr, _, _, sc, n_loc, B = a
    n0 = pdcch_tail.LAUNCHES["pdcch_derm"]
    got = pdcch_tail.derm_cuda(llr, sc, n_loc, B)
    torch.cuda.synchronize()
    if pdcch_tail.LAUNCHES["pdcch_derm"] != n0 + 1:
        raise AssertionError(f"{name}: pdcch_derm did not launch once")
    want = pdcch_tail.derm_plain(llr, sc, n_loc, B)
    host = pdcch_tail.derm_plain(llr.cpu(), sc, n_loc, B)
    peak = float(llr.abs().max())
    r = dict(floats=0, diff=0, host_diff=0, err=0.0, neg_zero=0)
    for g, w, h in zip(got, want, host):
        g, w, h = g.cpu().numpy(), w.cpu().numpy(), h.numpy()
        r["floats"] += g.size
        r["diff"] += int((g.view(np.int32) != w.view(np.int32)).sum())
        r["host_diff"] += int((g.view(np.int32) != h.view(np.int32)).sum())
        r["err"] = max(r["err"], float(np.abs(g - w).max()))
        r["neg_zero"] += int(np.signbit(g[g == 0]).sum())
    log(f"  pdcch_derm, {name} (B {B}, n_loc {n_loc}, D {list(sc)}): "
        f"{r['diff']} of {r['floats']} floats differ from the plain version"
        f" on the card (largest |diff| {r['err']:.3g}, tolerance "
        f"{DERM_TOL} x peak {peak:.3g}), {r['host_diff']} from the plain "
        f"version on the host; {r['neg_zero']} -0")
    if r["err"] > DERM_TOL * peak or r["neg_zero"]:
        raise AssertionError(f"{name}: pdcch_derm outside the tolerance of "
                             "the plain version, or a -0 output")
    return r


def pack_held(name: str, a) -> list:
    """pdcch_crc_pack against its plain version on the same card bits
    (the Viterbi's on the kernel's de-rate-match), with and without the
    scalars: every output word for word.  Returns the bits."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi
    llr, cce, scal, sc, n_loc, B = a
    bits = viterbi.viterbi_decode_tb_multi(
        pdcch_tail.derm_cuda(llr, sc, n_loc, B))
    n_words = 0
    for s_ in (None, scal):
        n0 = pdcch_tail.LAUNCHES["pdcch_crc_pack"]
        got = pdcch_tail.crc_pack_cuda(bits, cce, n_loc, B, s_)
        torch.cuda.synchronize()
        if pdcch_tail.LAUNCHES["pdcch_crc_pack"] != n0 + 1:
            raise AssertionError(f"{name}: pdcch_crc_pack did not launch "
                                 "once")
        want = pdcch_tail.crc_pack_plain(bits, cce, tuple(sc), n_loc, B, s_)
        pairs = [("cand_fused", got["cand_fused"], want["cand_fused"]),
                 ("cand_meta", got["cand_meta"], want["cand_meta"]),
                 ("cand_pay", got["cand_pay"],
                  pdcch_tail.u32_to_i32(want["cand_pay"]))]
        pairs += [(f"rnti_{D}", got["rnti"][..., k], want[f"rnti_{D}"])
                  for k, D in enumerate(sc)]
        for key, g, w in pairs:
            g, w = g.cpu().numpy(), w.cpu().numpy()
            if g.shape != w.shape or not np.array_equal(
                    g.astype(np.int64), w.astype(np.int64)):
                raise AssertionError(f"{name}: pdcch_crc_pack's {key} "
                                     "differs from the plain version")
            n_words += g.size
    log(f"  pdcch_crc_pack, {name}: cand_fused (with and without the "
        f"scalars), RNTIs, meta and payload words equal the plain version's"
        f" on the card, {n_words} words")
    return bits


def route_held(name: str, a) -> dict:
    """The two-launch route (the Viterbi's search entry, pdcch_pack) on one
    input: one launch of each; against the three-launch route on the card
    every output (every size's bits, RNTIs, meta and payload words,
    cand_fused; with and without the scalars) word for word, and the
    search entry's words against compact_plain of that route's bits;
    pdcch_pack against pack_plain on the same words; cand_fused against
    the plain tail on the host (must be equal) and on the card
    (counted)."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi
    llr, cce, scal, sc, n_loc, B = a
    n0 = (viterbi.LAUNCHES["viterbi_search"],
          pdcch_tail.LAUNCHES["pdcch_pack"])
    got = pdcch_tail.decode_tail(llr, cce, sc, n_loc, B, scal)
    torch.cuda.synchronize()
    if (viterbi.LAUNCHES["viterbi_search"],
            pdcch_tail.LAUNCHES["pdcch_pack"]) != (n0[0] + 1, n0[1] + 1):
        raise AssertionError(f"{name}: the tail did not launch the search "
                             "entry and pdcch_pack once each")
    n_words = 0
    for s_ in (scal, None):
        g = got if s_ is scal else pdcch_tail.decode_tail(
            llr, cce, sc, n_loc, B, s_)
        three = pdcch_tail.decode_tail_three(llr, cce, sc, n_loc, B, s_)
        if list(g) != list(three):
            raise AssertionError(f"{name}: the routes return {list(g)} and "
                                 f"{list(three)}")
        for k in three:
            x, y = g[k].cpu().numpy(), three[k].cpu().numpy()
            if x.shape != y.shape or not np.array_equal(x, y):
                raise AssertionError(
                    f"{name}: {k}: {int((x != y).sum())} words of the "
                    "two-launch route differ from the three-launch route's")
            n_words += x.size
    comp, _ = viterbi.viterbi_search_cuda(llr, sc, n_loc, B)
    bits = [three[f"bits_{D}"].reshape(B * n_loc, D) for D in sc]
    if not torch.equal(comp, pdcch_tail.compact_plain(bits)):
        raise AssertionError(f"{name}: the search entry's words differ "
                             "from compact_plain of the same bits")
    for s_ in (None, scal):
        p = pdcch_tail.pack_cuda(comp, cce, n_loc, B, s_, outputs=True)
        w = pdcch_tail.pack_plain(comp, cce, n_loc, B, s_)
        if any(not torch.equal(p[k], w[k]) for k in w):
            raise AssertionError(f"{name}: pdcch_pack differs from its "
                                 "plain version")
    fused = got["cand_fused"].cpu().numpy()
    card = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B, scal)
    host = pdcch_tail.decode_tail_plain(llr.cpu(), cce.cpu(), sc, n_loc, B,
                                        scal.cpu())
    r = dict(words=n_words, fused_words=int(fused.size),
             fused_diff=int((fused != card["cand_fused"].cpu().numpy())
                            .sum()),
             fused_host_diff=int((fused != host["cand_fused"].numpy())
                                 .sum()))
    log(f"  the two-launch route, {name}: every size's bits, the RNTIs, "
        f"meta and payload words and cand_fused (with and without the "
        f"scalars; {n_words} words) equal the three-launch route's; the "
        f"search entry's words equal compact_plain's, pdcch_pack's equal "
        f"pack_plain's; cand_fused: {r['fused_host_diff']} of "
        f"{r['fused_words']} words differ from the plain tail on the host, "
        f"{r['fused_diff']} from the plain tail on the card")
    if r["fused_host_diff"]:
        raise AssertionError(f"{name}: cand_fused differs from the plain "
                             "tail on the host")
    return r


def device_ms(step, names: tuple, n: int = 20) -> tuple:
    """(device ms a call, kernel records a call) of the kernels whose names
    hold one of `names` (each launched once a call), over n calls of
    `step` under torch.profiler (warmed first): the sum over `names` of
    each kernel's mean time a record, since a short profile may lose a
    record (PERF.md, section 6); (None, 0) where the profiler saw
    none of one of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    t = {x: [] for x in names}
    for e in p.events():
        for x in names:
            if e.device_type == DeviceType.CUDA and x in e.name:
                t[x].append((e.time_range.end - e.time_range.start) / 1e3)
    if not all(t.values()):
        return None, 0
    return (sum(sum(v) / len(v) for v in t.values()),
            sum(len(v) for v in t.values()) / n)


def check_pdcch_tail(device, loaded_stream, rng, card: str) -> dict:
    """Phase 2d: the two-launch route against the three-launch route and
    the plain tail, and the yardsticks against their plain versions, on
    the loaded cell's first chunk (its real LLRs), on seeded random LLRs
    at 100 PRB and at a 25-PRB 4-port cell (7 sizes, 31 locations, 17
    CCEs: odd counts), and on exact-sum LLRs; the kernels' times beside
    their bounds; one tail call's CUDA kernels, copies and host time
    through each route."""
    from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.testing import loaded_cell
    chunk = search_chunk()
    cases = {"the loaded cell's first chunk": loaded_tail_args(
        device, loaded_stream)}
    cases["random LLRs, 100 PRB"] = tail_args(loaded_cell.CELL, device,
                                              chunk, rng)
    small = CellConfig(n_id_cell=7, n_prb=25, nof_ports=4)
    cases["random LLRs, 25 PRB, 4 ports"] = tail_args(small, device, 5, rng)
    cases["exact-sum LLRs, 100 PRB"] = tail_args(loaded_cell.CELL, device,
                                                 chunk, rng, True)
    route_r = {k: route_held(k, a) for k, a in cases.items()}
    if route_r["exact-sum LLRs, 100 PRB"]["fused_diff"]:
        raise AssertionError("the tail through the kernels differs from the "
                             "plain tail on exact sums")
    derm_r = {k: derm_held(k, a) for k, a in cases.items()}
    if derm_r["exact-sum LLRs, 100 PRB"]["diff"]:
        raise AssertionError("pdcch_derm differs from the plain version on "
                             "exact sums")
    for k, a in cases.items():
        pack_held(k, a)
    # times at the loaded chunk's shape, in turns
    a = cases["the loaded cell's first chunk"]
    llr, cce, scal, sc, n_loc, B = a
    ds, locs = tuple(sc), sc.locs
    comp, _ = viterbi.viterbi_search_cuda(llr, sc, n_loc, B)
    groups = pdcch_tail.derm_cuda(llr, sc, n_loc, B)
    bits = viterbi.viterbi_decode_tb_multi(groups)

    def search():
        return viterbi.viterbi_search_cuda(llr, sc, n_loc, B)

    def earlier():
        return viterbi.viterbi_tb_cuda(pdcch_tail.derm_cuda(llr, sc, n_loc,
                                                            B))

    def derm():
        return pdcch_tail.derm_cuda(llr, sc, n_loc, B)

    def plain_entry():
        return viterbi.viterbi_tb_cuda(groups)

    def pack():
        return pdcch_tail.pack_cuda(comp, cce, n_loc, B, scal)

    def crc_pack():
        return pdcch_tail.crc_pack_cuda(bits, cce, n_loc, B, scal,
                                        outputs=False)
    t = {k: [] for k in ("search", "earlier", "derm", "plain_entry", "pack",
                         "crc_pack")}
    fns = dict(search=search, earlier=earlier, derm=derm,
               plain_entry=plain_entry, pack=pack, crc_pack=crc_pack)
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            t[k].append(time_cuda(fns[k], n=50))
    t["search_plain"] = time_cuda(
        lambda: pdcch_tail.search_plain(llr, sc, n_loc, B), n=3)
    t["pack_plain"] = time_cuda(
        lambda: pdcch_tail.pack_plain(comp, cce, n_loc, B, scal), n=10)
    t["derm_plain"] = time_cuda(
        lambda: pdcch_tail.derm_plain(llr, sc, n_loc, B), n=10)
    t["crc_pack_plain"] = time_cuda(
        lambda: pdcch_tail.crc_pack_plain(bits, cce, ds, n_loc, B, scal),
        n=10)
    dev = dict(search=device_ms(search, ("viterbi_search_kernel",)),
               earlier=device_ms(earlier, ("viterbi_tb_kernel",
                                           "pdcch_derm_kernel")),
               derm=device_ms(derm, ("pdcch_derm_kernel",)),
               plain_entry=device_ms(plain_entry, ("viterbi_tb_kernel",)),
               pack=device_ms(pack, ("pdcch_pack_kernel",)),
               crc_pack=device_ms(crc_pack, ("pdcch_crc_pack_kernel",)))

    def kernel_tail():
        return pdcch_tail.decode_tail(llr, cce, sc, n_loc, B, scal,
                                      full=False)

    def three_tail():
        return pdcch_tail.decode_tail_three(llr, cce, sc, n_loc, B, scal)

    def plain_tail():
        return pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B, scal)
    t["tail"] = [time_cuda(kernel_tail, n=20)]
    t["tail_three"] = [time_cuda(three_tail, n=20)]
    t["tail_plain"] = time_cuda(plain_tail, n=5)
    t["tail_three"].append(time_cuda(three_tail, n=20))
    t["tail"].append(time_cuda(kernel_tail, n=20))
    n_bits = int(llr.shape[1])
    nof_cce = int(cce.shape[1])

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")
    work = {
        "viterbi_search": (pdcch_tail.search_bytes(B, n_bits, ds, n_loc),
                           pdcch_tail.search_ops(B, ds, locs), "search",
                           t["search_plain"]),
        "pdcch_pack": (pdcch_tail.words_bytes(B, len(ds), n_loc, nof_cce,
                                              True),
                       pdcch_tail.words_ops(B, len(ds), n_loc), "pack",
                       t["pack_plain"]),
        "pdcch_derm": (pdcch_tail.derm_bytes(B, n_bits, ds, n_loc),
                       pdcch_tail.derm_ops(B, ds, locs), "derm",
                       t["derm_plain"]),
        "pdcch_crc_pack": (pdcch_tail.pack_bytes(B, ds, n_loc, nof_cce,
                                                 True),
                           pdcch_tail.pack_ops(B, ds, n_loc), "crc_pack",
                           t["crc_pack_plain"])}
    out = {}
    for key, (nb, no, tk, plain) in work.items():
        turns = t[tk]
        bd, by = bound(nb, no)
        d_ms, d_n = dev[tk]
        out[key] = dict(ms=min(turns), ms_turns=turns, plain_ms=plain,
                        bound_ms=bd, bound_by=by, bytes=nb, ops=no,
                        device_ms=d_ms, kernels_per_call=d_n)
        log(f"  {key} at the loaded chunk's shape (B {B}, n_loc {n_loc}, D "
            f"{list(ds)}; {nb} bytes, {no} operations) on {card}: kernel "
            f"{min(turns):.4f} ms (turns {turns[0]:.4f}, {turns[1]:.4f}; "
            f"CUDA events over back-to-back calls of the wrapper), device "
            + ("not measured" if d_ms is None else f"{d_ms:.4f} ms a call "
               f"({d_n:g} kernels a call; profiler)") +
            f"; plain version {plain:.4f} ms; bound {bd:.6f} ms ({by}: "
            f"max(bytes / 3.35 TB/s, operations / 67 T/s)), "
            f"{100 * bd / min(turns):.1f} % of it; no PyTorch call computes "
            "this function, so there is no library time")
    e_ms = [x + y for x, y in zip(t["derm"], t["plain_entry"])]
    log(f"  the search call: the search entry {min(t['search']):.4f} ms "
        f"(turns {t['search'][0]:.4f}, {t['search'][1]:.4f}) against the "
        f"earlier route's pdcch_derm then the plain entry "
        f"{min(t['earlier']):.4f} ms (turns {t['earlier'][0]:.4f}, "
        f"{t['earlier'][1]:.4f}; apart {min(t['derm']):.4f} + "
        f"{min(t['plain_entry']):.4f} = {min(e_ms):.4f} ms) in this run "
        f"(earlier records on an H100 80GB HBM3 at 700 W: "
        f"{EARLIER_DERM_MS} + {EARLIER_VITERBI_MS} ms); device time "
        f"{dev['search'][0]} against {dev['earlier'][0]} ms a call")
    log(f"  the pack: pdcch_pack {min(t['pack']):.4f} ms by CUDA events, "
        f"{dev['pack'][0]} ms device time, against pdcch_crc_pack "
        f"{min(t['crc_pack']):.4f} ms, {dev['crc_pack'][0]} ms device time "
        f"in this run (earlier record: {EARLIER_PACK_DEVICE_MS} ms device "
        "time)")
    pk, p3, pp = (profile_step(kernel_tail), profile_step(three_tail),
                  profile_step(plain_tail))
    hk1, h31, hp1 = (host_step_ms(kernel_tail, 20), host_step_ms(three_tail,
                     20), host_step_ms(plain_tail, 5))
    hp2, h32, hk2 = (host_step_ms(plain_tail, 5), host_step_ms(three_tail,
                     20), host_step_ms(kernel_tail, 20))
    log(f"  one tail call (loaded chunk) on {card}: CUDA events "
        f"{min(t['tail']):.4f} ms through the two kernels (turns "
        f"{t['tail'][0]:.4f}, {t['tail'][1]:.4f}), "
        f"{min(t['tail_three']):.4f} ms through the three-launch route, "
        f"{t['tail_plain']:.4f} ms through the plain chain")
    for what, p_, h in (("two-launch route", pk, (hk1, hk2)),
                        ("three-launch route", p3, (h31, h32)),
                        ("plain chain", pp, (hp1, hp2))):
        log(f"  one tail call through the {what}: kernel launches "
            f"{p_['launches']} and memory copies {p_['copies']} by the host;"
            f" the device's records: CUDA kernels {p_['kernels']}, "
            f"host-to-device copies {p_['h2d']}, "
            f"device-to-host {p_['d2h']}, other copies and sets "
            f"{p_['other']}; device time {p_['device_ms']:.4f} ms; host "
            f"clock per call (synchronized) {h[0]:.4f}, {h[1]:.4f} ms")
    if pk["launches"] + pp["launches"] == 0:
        log("  launches per tail call: not measured (the profiler saw "
            "none)")
    elif pk["launches"] != 2 or pk["copies"] != 0:
        raise AssertionError(f"the tail through the kernels made "
                             f"{pk['launches']} launches and {pk['copies']} "
                             "memory copies, not 2 and 0")
    derm_err = max(r["err"] for r in derm_r.values())
    out["pdcch_derm"].update(max_abs_err=derm_err, cases=derm_r)
    for k in ("pdcch_crc_pack", "pdcch_pack", "viterbi_search"):
        out[k].update(max_abs_err=0)
    out["viterbi_search"].update(cases=route_r)
    out["tail"] = dict(ms_turns=t["tail"], three_ms_turns=t["tail_three"],
                       plain_ms=t["tail_plain"],
                       step={"kernels": pk, "three": p3, "plain": pp},
                       host_ms={"kernels": [hk1, hk2], "three": [h31, h32],
                                "plain": [hp1, hp2]},
                       earlier_ms_turns=t["earlier"],
                       shape=dict(B=B, n_loc=n_loc, D=list(ds),
                                  n_bits=n_bits))
    return out


TAIL_CALLS = {"n": 0}     # search tails run (count_tail_calls)


def count_tail_calls():
    """From here on, every call of the search tail
    (`pdcch_rx._candidate_decode_tail`) adds one to TAIL_CALLS["n"]."""
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    real = pdcch_rx._candidate_decode_tail

    def counted(*a, **k):
        TAIL_CALLS["n"] += 1
        return real(*a, **k)
    pdcch_rx._candidate_decode_tail = counted


def host_reads(*sites) -> int:
    """Reads at the tracer's `host_read.<site>` counters since its reset."""
    from ltesniffer_tpu_torch.sniffer import prof
    c = prof.counters()
    return sum(c.get(f"host_read.{s}", {"events": 0})["events"]
               for s in sites)


def reset_counts():
    from ltesniffer_tpu_torch.kernels import bcjr, cb_derm, mimo_eq
    from ltesniffer_tpu_torch.kernels import pdcch_tail, pdsch_eq, tb_finish
    from ltesniffer_tpu_torch.kernels import turbo_decode, viterbi
    for m in (bcjr, cb_derm, mimo_eq, pdcch_tail, pdsch_eq, tb_finish,
              turbo_decode, viterbi):
        m.reset_launches()
    TAIL_CALLS["n"] = 0


EQ_LAUNCHES = {}     # path -> mimo_eq_demap launches (viterbi_count)
TAIL_KERNELS = ("viterbi_search", "pdcch_pack", "pdcch_derm",
                "pdcch_crc_pack")
TAIL_LAUNCHES = {}   # path -> {"calls": search tails, kernel: launches}
VIT_LAUNCHES = {}    # path -> the Viterbi's plain entry's launches
TBF_LAUNCHES = {}    # path -> tb_finish launches (viterbi_count)
PEQ_LAUNCHES = {}    # path -> pdsch_eq_demap launches (viterbi_count)
DERM_LAUNCHES = {}   # path -> [cb_derm, packing entry] launches (the same)


def tail_counts() -> dict:
    """The tail kernels' launches since the last reset_counts()."""
    from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi
    return dict(viterbi_search=viterbi.LAUNCHES["viterbi_search"],
                **{k: pdcch_tail.LAUNCHES[k] for k in TAIL_KERNELS[1:]})


def tail_check(path: str, calls, counts: dict, plain: int):
    """Fails unless the path's search tails each launched the Viterbi's
    search entry and pdcch_pack once and neither pdcch_derm nor
    pdcch_crc_pack (calls None: not counted, in a child process), and ran
    no plain tail on the card.  Records the counts in TAIL_LAUNCHES."""
    TAIL_LAUNCHES[path] = dict(calls=calls, **counts)
    log(f"  {path}: search tails {'n/a' if calls is None else calls}, "
        + ", ".join(f"{k} launches {counts[k]}" for k in TAIL_KERNELS) +
        f", plain tails on the card {plain}")
    if plain != 0:
        raise AssertionError(f"{path} ran the plain search tail on the card "
                             f"{plain} times")
    n = counts["viterbi_search"]
    if n <= 0 or counts["pdcch_pack"] != n or \
            (calls is not None and n != calls) or counts["pdcch_derm"] or \
            counts["pdcch_crc_pack"]:
        raise AssertionError(f"{path}: {counts} launches for {calls} search "
                             "tails, not one search entry and one "
                             "pdcch_pack each")


def viterbi_count(path: str) -> int:
    """The Viterbi kernel's launches (both entries) since the last
    reset_counts(); fails if the path launched none or ran the plain step
    loop on the card.  Also records the path's eq/demap kernel launches in
    EQ_LAUNCHES and fails if it ran the plain eq/demap chain on the card,
    and checks its search tails (`tail_check`), and records its tb_finish
    and batched SISO eq/demap launches in TBF_LAUNCHES and PEQ_LAUNCHES,
    failing if it ran the plain SISO eq/demap chain on the card, and its
    cb_derm and packing-entry launches in DERM_LAUNCHES, failing if it ran
    the plain de-rate-match on the card or finished blocks on the card
    (tb_finish) without either kernel."""
    from ltesniffer_tpu_torch.kernels import cb_derm, mimo_eq, pdcch_tail
    from ltesniffer_tpu_torch.kernels import pdsch_eq, tb_finish
    from ltesniffer_tpu_torch.kernels import turbo_decode, viterbi
    n_tb, n_s = viterbi.LAUNCHES["viterbi"], viterbi.LAUNCHES["viterbi_search"]
    n = n_tb + n_s
    p = viterbi.PLAIN_CUDA["viterbi"]
    EQ_LAUNCHES[path] = mimo_eq.LAUNCHES["mimo_eq_demap"]
    VIT_LAUNCHES[path] = n_tb
    TBF_LAUNCHES[path] = tb_finish.LAUNCHES["tb_finish"]
    PEQ_LAUNCHES[path] = pdsch_eq.LAUNCHES["pdsch_eq_demap"]
    p_peq = pdsch_eq.PLAIN_CUDA["pdsch_eq_demap"]
    DERM_LAUNCHES[path] = [cb_derm.LAUNCHES["cb_derm"],
                           turbo_decode.LAUNCHES["turbo_decode_pack"]]
    p_derm = cb_derm.PLAIN_CUDA["cb_derm"]
    tail_check(path, TAIL_CALLS["n"], tail_counts(),
               sum(pdcch_tail.PLAIN_CUDA.values()))
    p_eq = mimo_eq.PLAIN_CUDA["mimo_eq_demap"]
    log(f"  {path}: viterbi_tb launches {n_tb} (plain entry) + {n_s} "
        f"(search entry), plain Viterbi step loops on the card {p}; "
        f"mimo_eq_demap launches {EQ_LAUNCHES[path]}, plain eq/demap chains"
        f" on the card {p_eq}; tb_finish launches {TBF_LAUNCHES[path]}; "
        f"pdsch_eq_demap launches {PEQ_LAUNCHES[path]}, plain SISO "
        f"eq/demap chains on the card {p_peq}; cb_derm launches "
        f"{DERM_LAUNCHES[path][0]}, packing-entry launches "
        f"{DERM_LAUNCHES[path][1]}, plain de-rate-matches on the card "
        f"{p_derm}")
    if p_derm != 0:
        raise AssertionError(f"{path} ran the plain de-rate-match on the "
                             f"card {p_derm} times")
    if TBF_LAUNCHES[path] and not all(DERM_LAUNCHES[path]):
        raise AssertionError(f"{path} finished blocks on the card without "
                             f"cb_derm and the packing entry: "
                             f"{DERM_LAUNCHES[path]}")
    if p_peq != 0:
        raise AssertionError(f"{path} ran the plain SISO eq/demap chain on "
                             f"the card {p_peq} times")
    if p_eq != 0:
        raise AssertionError(f"{path} ran the plain eq/demap chain on the "
                             f"card {p_eq} times")
    if n <= 0:
        raise AssertionError(f"{path} launched no Viterbi kernel")
    if p != 0:
        raise AssertionError(f"{path} ran the plain Viterbi step loop on "
                             f"the card {p} times")
    return n


# ---------------------------------------------------------------------------
# phase 2e: the transport-block finish against its plain version
# ---------------------------------------------------------------------------
def tb_held(name: str, device, fused, table) -> int:
    """The kernel's output against the plain version's on the host, byte
    for byte; returns the blocks whose TB check holds."""
    import torch
    from ltesniffer_tpu_torch.kernels import tb_finish
    from ltesniffer_tpu_torch.testing import tb_rows
    _h, desc = tb_finish.upload(table, "cpu")
    want = tb_rows.defined(tb_finish.finish(fused, table, desc), table)
    n0 = tb_finish.LAUNCHES["tb_finish"]
    host, desc = tb_finish.upload(table, device)
    got = tb_rows.defined(tb_finish.finish(fused.to(device), table, desc),
                          table)
    torch.cuda.synchronize()
    if tb_finish.LAUNCHES["tb_finish"] != n0 + 1 or not host.is_pinned():
        raise AssertionError(f"{name}: not one launch from a pinned table")
    n_ok = sum(st & 1 for st in want[0])
    log(f"  {name}: {table.n_tb} blocks, {len(table.cb)} code blocks, "
        f"{n_ok} pass the TB check; kernel == plain version: {got == want}")
    if got != want:
        bad = [t for t in range(table.n_tb) if got[0][t] != want[0][t]]
        raise AssertionError(f"{name}: the kernel differs from the plain "
                             f"version (status words of blocks {bad[:8]})")
    return n_ok


def check_tb_finish(device, rng, card: str) -> dict:
    """Phase 2e: tb_finish against its plain version at the E-TM 3.1 and
    loaded shapes and the odd segmentations; its time, bound, registers."""
    from ltesniffer_tpu_torch.kernels import nvcc_build, tb_finish
    from ltesniffer_tpu_torch.testing import tb_rows
    cases = {}
    for name in ("etm31", "loaded"):
        _specs, fused, table = tb_rows.shape(name, rng)
        cases[name] = tb_held(name, device, fused, table)
    specs = [(tbs, *tb_rows.blocks(tbs, rng, fault))
             for tbs, fault in ((8, None), (528, "cb"), (6128, None),
                                (12224, "tb"), (75376, None), (97896, None),
                                (97896, "cb"), (16, None))]
    fused, table = tb_rows.lay_out(specs, rng)
    table.tb[-1][0] = 0                  # a skipped block
    cases["odd"] = tb_held("odd segmentations", device, fused, table)
    _specs, fused, table = tb_rows.shape("etm31", rng)
    fd = fused.to(device)
    host, desc = tb_finish.upload(table, device)
    ms = time_cuda(lambda: tb_finish.finish_cuda(fd, table, desc), 50)
    dev_ms, per_call = device_ms(
        lambda: tb_finish.finish_cuda(fd, table, desc), ("tb_finish_kernel",))

    def batch():
        h, d = tb_finish.upload(table, device)
        return tb_finish.finish_cuda(fd, table, d).cpu()
    batch()
    t0 = time.perf_counter()
    for _ in range(50):
        batch()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    _h, desc_c = tb_finish.upload(table, "cpu")
    tb_finish.finish(fused, table, desc_c)
    t0 = time.perf_counter()
    for _ in range(5):
        tb_finish.finish(fused, table, desc_c)
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    n_bytes = tb_finish.bytes_moved(table)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    sass = nvcc_build.sass_counts("tb_finish")
    regs = nvcc_build.ptxas_report("tb_finish")
    for fn, r, st, ld in regs:
        log(f"  ptxas tb_finish: {r} registers, {st} / {ld} bytes spill "
            f"stores / loads, {sass.get(fn, 'n/a')} SASS instructions")
    if any(st or ld for _fn, _r, st, ld in regs):
        raise AssertionError(f"tb_finish spills: {regs}")
    log(f"  tb_finish at the E-TM 3.1 shape ({table.n_tb} blocks, "
        f"{len(table.cb)} code blocks) on {card}: kernel {ms:.4f} ms (CUDA "
        f"events), {dev_ms if dev_ms is None else round(dev_ms, 4)} ms "
        f"device time ({per_call} records a call); bound {bound_ms:.6f} ms "
        f"(bytes: {n_bytes} at 3.35 TB/s); upload + launch + read of a "
        f"batch {host_ms:.4f} ms on the host; plain version on the host "
        f"{plain_ms:.3f} ms")
    return dict(cases=cases, ms=ms, device_ms=dev_ms, host_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                bytes=n_bytes, registers=[r for _f, r, _s, _l in regs],
                spill_bytes=sum(st + ld for _f, _r, st, ld in regs),
                shape={"blocks": table.n_tb, "code_blocks": len(table.cb)})


# ---------------------------------------------------------------------------
# phase 2f: the batched single-layer eq/demap against its plain version
# ---------------------------------------------------------------------------
def check_pdsch_eq(device, card: str) -> dict:
    """Phase 2f: pdsch_eq_demap against its plain version on the card and
    on the host at every eq_grants variant; at the loaded batch its time,
    byte bound, the parent's route (the plain chain on the card), one
    dispatch's host cost, registers and spills."""
    import torch
    from ltesniffer_tpu_torch.kernels import nvcc_build, pdsch_eq
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import eq_grants
    cases, worst = {}, [0.0, 0.0, 0]
    for v in eq_grants.VARIANTS:
        cell, grids, h, nv, jobs, re_of = eq_grants.batch(*v, seed=11)
        table, re_tab = eq_grants.table(cell, h, jobs, device)
        ts = [x.to(device) for x in (grids, h, nv)]
        n0 = pdsch_eq.LAUNCHES["pdsch_eq_demap"]
        got, host = pdsch_eq.eq_demap(*ts, table, re_tab, cell)
        torch.cuda.synchronize()
        if pdsch_eq.LAUNCHES["pdsch_eq_demap"] != n0 + 1 or \
                not host.is_pinned():
            raise AssertionError(f"{v}: not one launch from a pinned table")
        _h, desc = pdsch_eq.upload(table, device)
        on_card = pdsch_eq.eq_demap_plain(*ts, desc, re_tab, cell,
                                          table.n_grants, table.wm)
        on_host = pdsch_eq.eq_demap(grids, h, nv, table, None if re_tab is
                                    None else re_tab.cpu(), cell)[0]
        res = {}
        for where, want in (("card", on_card), ("host", on_host)):
            err, rel, n_diff, ok = eq_grants.max_err(got, want)
            res[where] = dict(max_abs=err, max_rel=rel, floats_differ=n_diff)
            log(f"  {eq_grants.variant_id(v)} ({table.n_grants} grants, "
                f"{table.n_blocks} blocks): kernel vs plain on the {where}: "
                f"max abs {err:.3g}, max rel {rel:.3g}, {n_diff} of "
                f"{got.numel()} floats differ")
            if not ok:
                raise AssertionError(f"{v}: the kernel differs from the plain "
                                     f"version on the {where} beyond the "
                                     f"tolerance ({err}, {rel})")
            worst = [max(worst[0], err), max(worst[1], rel),
                     max(worst[2], n_diff)]
        cases[eq_grants.variant_id(v)] = res
    cell, grids, h, nv, jobs, re_of = eq_grants.batch("loaded", 1, 2,
                                                      seed=12)
    table, re_tab = eq_grants.table(cell, h, jobs, device)
    ts = [x.to(device) for x in (grids, h, nv)]
    _h, desc = pdsch_eq.upload(table, device)
    ms = time_cuda(lambda: pdsch_eq.eq_demap_cuda(*ts, desc, table, re_tab,
                                                  cell), 50)
    dev_ms, per_call = device_ms(
        lambda: pdsch_eq.eq_demap_cuda(*ts, desc, table, re_tab, cell),
        ("pdsch_eq_demap_kernel",))
    plain_ms = time_cuda(lambda: pdsch_eq.eq_demap_plain(
        *ts, desc, re_tab, cell, table.n_grants, table.wm), 5)
    # one dispatch's eq/demap as the host pays it: descriptors built from
    # the jobs, one pinned upload, one launch
    live = list(range(len(jobs)))

    def dispatch():
        srcs = [pdsch_rx._src_of(cell, j) for j in jobs]
        tab, rt = pdsch_rx._eq_table(cell, 2, jobs, live, srcs, device)
        return pdsch_rx._eq_rows(*ts, tab, rt, cell)[0]
    dispatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dispatch()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    n_bytes = pdsch_eq.bytes_moved(table, 1)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    sass = nvcc_build.sass_counts("pdsch_eq_demap")
    regs = nvcc_build.ptxas_report("pdsch_eq_demap")
    for fn, r, st, ld in regs:
        log(f"  ptxas pdsch_eq_demap: {r} registers, {st} / {ld} bytes spill "
            f"stores / loads, {sass.get(fn, 'n/a')} SASS instructions ({fn})")
    if any(st or ld for _fn, _r, st, ld in regs):
        raise AssertionError(f"pdsch_eq_demap spills: {regs}")
    log(f"  pdsch_eq_demap at the loaded batch ({table.n_grants} grants, "
        f"{table.n_blocks} blocks) on {card}: kernel {ms:.4f} ms (CUDA "
        f"events), {dev_ms if dev_ms is None else round(dev_ms, 4)} ms "
        f"device time ({per_call} records a call); bound {bound_ms:.6f} ms "
        f"(bytes: {n_bytes} at 3.35 TB/s); the plain chain on the card "
        f"(the parent's route) {plain_ms:.4f} ms; descriptors + upload + "
        f"launch of a dispatch {host_ms:.4f} ms on the host")
    return dict(cases=cases, max_abs_err=worst[0], max_rel_err=worst[1],
                floats_differ=worst[2], ms=ms, device_ms=dev_ms,
                host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", bytes=n_bytes,
                registers=[r for _f, r, _s, _l in regs],
                spill_bytes=sum(st + ld for _f, _r, st, ld in regs),
                shape={"grants": table.n_grants, "blocks": table.n_blocks})


# ---------------------------------------------------------------------------
# phase 2g: the batched de-rate-match and the turbo kernel's packing entry
# ---------------------------------------------------------------------------
# the plain de-rate-match on the card sums laps in torch's CUDA reduction
# order: a float may move by (laps - 1) ulps of the sum of the laps'
# magnitudes (tests/test_torch_cuda.py DERM_ATOL); the host's plain
# version sums as the kernel does, so the kernel must equal it exactly
DERM_ATOL = 6e-4


def check_cb_derm(device, card: str) -> dict:
    """Phase 2g: cb_derm and the turbo kernel's packing entry against
    their plain versions at the derm_batches batches (E-TM 3.1, loaded,
    odd: fillers, laps 1-3, rv 0-3, a chain of depth 2, priors by address
    and in the upload): cb_derm equal to the host's plain version float for
    float and to the card's within DERM_ATOL; one dispatch's code blocks on
    the card against the same on the host, fused rows bit for bit.  At one
    batch of 32 subframes of the E-TM 3.1 cell: cb_derm's and the packing
    entry's times (CUDA events, device time), byte bounds, the plain
    route's time on the card (the chain, the decoder's LLR entry and
    `_crc_pack`), one dispatch's code blocks on the host, registers and
    spills."""
    import torch
    from ltesniffer_tpu_torch.kernels import cb_derm, nvcc_build
    from ltesniffer_tpu_torch.kernels import turbo as kturbo, turbo_decode
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import derm_batches
    import numpy as np

    def on(dev, jobs, seed):
        rng = np.random.default_rng(seed)
        rows, live, n_re = derm_batches.batch(jobs, rng, device=dev)
        bufs = derm_batches.stored(jobs, rng, device=dev)
        return rows, live, n_re, bufs

    cases = {}
    for name in ("etm31", "loaded", "odd"):
        jobs = derm_batches.BATCHES[name]()
        got = {}
        for dev in (device, "cpu"):
            rows, live, n_re, bufs = on(dev, jobs, 41)
            n0 = (cb_derm.LAUNCHES["cb_derm"],
                  turbo_decode.LAUNCHES["turbo_decode_pack"])
            pb = pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re,
                                                dict(bufs), 2)
            tab = pb.derm[0]
            if dev == device:
                torch.cuda.synchronize()
                n1 = (cb_derm.LAUNCHES["cb_derm"] - n0[0],
                      turbo_decode.LAUNCHES["turbo_decode_pack"] - n0[1])
                if n1 != (len(tab.rounds()), len(pb.group_rows)):
                    raise AssertionError(f"{name}: {n1} launches, not one "
                                         "cb_derm a round and one packing "
                                         "entry a K")
            n_out = max(c[8] + 3 * (c[3] + 4) for c in tab.cb)
            out = torch.full((n_out,), float("nan"), device=dev)
            keep = []
            _h, desc = cb_derm.upload(tab, dev, out, keep)
            cb_derm.derm(rows, tab, desc, out)
            plain = None
            if dev == device:
                plain = torch.full((n_out,), float("nan"), device=dev)
                _h2, desc2 = cb_derm.upload(tab, dev, plain, keep)
                cb_derm.derm_plain(rows, desc2, tab, plain)
                plain = plain.cpu()
            got[dev] = (out.cpu(), plain, pb.fused_dev.cpu(),
                        {k: v.get().cpu() for k, v in pb.d_of.items()})
        (out_c, plain_c, fused_c, d_c), (out_h, _p, fused_h, d_h) = \
            got[device], got["cpu"]
        exact = torch.equal(out_c, out_h)
        diff = (out_c - plain_c).abs()
        rows_equal = torch.equal(fused_c, fused_h)
        d_equal = all(torch.equal(d_c[k], d_h[k]) for k in d_h)
        cases[name] = dict(code_blocks=tab.n_cb, rounds=len(tab.rounds()),
                           equal_host=exact,
                           floats_differ_card=int((diff > 0).sum()),
                           max_abs_card=float(diff.max()),
                           rows_equal=rows_equal, llrs_equal=d_equal)
        log(f"  {name}: {tab.n_cb} code blocks, {len(tab.rounds())} rounds, "
            f"{len(pb.group_rows)} K; cb_derm == plain on the host: {exact};"
            f" vs the card's plain version {cases[name]['floats_differ_card']}"
            f" floats differ (max {cases[name]['max_abs_card']:.3g}); the "
            f"dispatch's fused rows equal the host's: {rows_equal}, combined "
            f"LLRs: {d_equal}")
        if not (exact and rows_equal and d_equal) or \
                cases[name]["max_abs_card"] > DERM_ATOL:
            raise AssertionError(f"{name}: the kernels differ from the plain "
                                 f"route: {cases[name]}")
    # the packing entry against the decoder's LLR entry and _crc_pack at
    # the cells' K and the extremes, n_iter 2 and 12
    rng = np.random.default_rng(24)
    for K in (40, 352, 576, 3904, 4224, 4992, 5120, 6144):
        for n_iter in (2, 12):
            B = 3 if K >= 3904 else 17
            d = torch.from_numpy((3.0 * rng.standard_normal(
                (B, 3, K + 4))).astype(np.float32))
            rows = pdsch_rx._turbo_only_fn(K, n_iter)(d.to(device))
            bits, _ = kturbo.make_decoder(K, n_iter)(d.to(device))
            want_c = pdsch_rx._crc_pack(bits, K).cpu()
            want_h = pdsch_rx._turbo_only_fn(K, n_iter)(d)
            if not (torch.equal(rows.cpu(), want_c)
                    and torch.equal(rows.cpu(), want_h)):
                raise AssertionError(f"the packing entry differs from the "
                                     f"plain route at K={K}, n_iter {n_iter}")
    log("  packing entry == decoder + _crc_pack on the card and on the host "
        "at K 40, 352, 576, 3904, 4224, 4992, 5120, 6144, n_iter 2 and 12")
    # times at one batch of 32 subframes of the E-TM 3.1 cell
    jobs = derm_batches.etm31_jobs(32)
    rows, live, n_re, _b = on(device, jobs, 7)
    pb = pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re, {}, 2)
    tab = pb.derm[0]
    out = torch.empty(max(c[8] + 3 * (c[3] + 4) for c in tab.cb),
                      device=device)
    keep = []
    _h, desc = cb_derm.upload(tab, device, out, keep)
    derm_ms = time_cuda(lambda: cb_derm.derm_cuda(rows, desc, tab, out), 50)
    derm_dev, per_call = device_ms(
        lambda: cb_derm.derm_cuda(rows, desc, tab, out), ("cb_derm_kernel",))
    derm_plain_ms = time_cuda(
        lambda: cb_derm.derm_plain(rows, desc, tab, out), 5)
    derm_bytes = cb_derm.bytes_moved(tab)
    slabs = [(K, pb.d_of[items[0][:2]].arr) for K, _w, _n, items
             in pb.group_rows]

    def pack():
        for K, slab in slabs:
            pdsch_rx._turbo_only_fn(K, 2)(slab, pb.fused_dev, 0)

    def plain_pack():
        for K, slab in slabs:
            pdsch_rx._crc_pack(kturbo.make_decoder(K, 2)(slab)[0], K)
    pack_ms = time_cuda(pack, 20)
    pack_dev, _pc = device_ms(pack, ("turbo_decode_kernel",))
    plain_pack_ms = time_cuda(plain_pack, 20)
    pack_bound = max(
        sum(turbo_decode.bytes_moved_pack(K, s.shape[0]) for K, s in slabs)
        / HBM_BYTES_PER_S,
        sum(turbo_decode.ops(K, s.shape[0], 2) for K, s in slabs)
        / F32_OPS_PER_S) * 1e3

    def dispatch():
        return pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re, {}, 2)
    dispatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dispatch()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    regs = [r for r in nvcc_build.ptxas_report("cb_derm")]
    regs_pack = [r for r in nvcc_build.ptxas_report("turbo_decode")
                 if "Lb1E" in r[0]]
    sass = {**nvcc_build.sass_counts("cb_derm"),
            **nvcc_build.sass_counts("turbo_decode")}
    for fn, r, st, ld in regs + regs_pack:
        log(f"  ptxas {fn}: {r} registers, {st} / {ld} bytes spill stores / "
            f"loads, {sass.get(fn, 'n/a')} SASS instructions")
    if any(st or ld for _fn, _r, st, ld in regs + regs_pack):
        raise AssertionError(f"cb_derm or the packing entry spills: "
                             f"{regs + regs_pack}")
    derm_bound = derm_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  cb_derm at the E-TM 3.1 batch ({tab.n_cb} code blocks) on "
        f"{card}: {derm_ms:.4f} ms (CUDA events), "
        f"{derm_dev if derm_dev is None else round(derm_dev, 4)} ms device "
        f"time ({per_call} records a call); bound {derm_bound:.5f} ms "
        f"(bytes: {derm_bytes} at 3.35 TB/s); the plain chain on the card "
        f"{derm_plain_ms:.4f} ms")
    log(f"  packing entry at the same batch ({len(slabs)} launches, K "
        f"{[K for K, _ in slabs]}, n_iter 2): {pack_ms:.4f} ms (CUDA events),"
        f" {pack_dev if pack_dev is None else round(pack_dev, 4)} ms device "
        f"time; bound {pack_bound:.5f} ms (operations); the decoder's LLR "
        f"entry + _crc_pack on the card {plain_pack_ms:.4f} ms; one "
        f"dispatch's code blocks (descriptors, upload, launches, tb_finish) "
        f"{host_ms:.4f} ms on the host")
    return dict(cases=cases, ms=derm_ms, device_ms=derm_dev,
                plain_ms=derm_plain_ms, bound_ms=derm_bound, bound_by="bytes",
                bytes=derm_bytes, host_ms=host_ms,
                registers=[r for _f, r, _s, _l in regs],
                spill_bytes=sum(st + ld for _f, _r, st, ld in regs),
                shape={"code_blocks": tab.n_cb, "rounds": len(tab.rounds())},
                pack=dict(ms=pack_ms, device_ms=pack_dev,
                          plain_ms=plain_pack_ms, bound_ms=pack_bound,
                          bound_by="operations", launches=len(slabs),
                          registers=[r for _f, r, _s, _l in regs_pack],
                          spill_bytes=sum(st + ld for _f, _r, st, ld
                                          in regs_pack)))


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------
def run_golden(device, tmp: str):
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import stream_cell
    cell, stream, _ = stream_cell.golden_scenario()
    out = os.path.join(tmp, "dl_golden.pcap")
    cfg = core.SnifferConfig(cell=cell, batch_size=8, pcap_path=out,
                             api_mode=0, device=device)
    c = core.LTESnifferCore(cfg)
    c.run_samples(stream)
    c.close()
    got = hashlib.sha256(open(out, "rb").read()).hexdigest()
    want = hashlib.sha256(open(GOLDEN_PCAP, "rb").read()).hexdigest()
    log(f"  golden pcap sha256 {got} ({'equal' if got == want else 'DIFFERS'}"
        f"); summary pdsch_ok={c.summary()['pdsch_ok']}")
    if got != want:
        raise AssertionError(f"golden pcap sha256 {got} != {want}")


def run_loaded(device, words, scales, tmp: str, batch_size: int = 256,
               cell=None):
    """The main path: run_packed over a cell's stream (the loaded cell
    unless `cell` is given), logging accepted DCIs.  Returns (core,
    accepted log, seconds)."""
    import torch
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell
    cfg = core.SnifferConfig(cell=cell or loaded_cell.CELL,
                             batch_size=batch_size,
                             pcap_path=os.path.join(tmp, "loaded.pcap"),
                             device=device)
    c = core.LTESnifferCore(cfg)
    acc = []

    def hook(ctx):
        for a in ctx["accepted"]:
            acc.append([ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt])
    c.on_subframe = hook
    t0 = time.perf_counter()
    c.run_packed(words, scales)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c.close()
    return c, acc, dt


# the port's XLA-program counterparts that run as chains of torch launches
# (<package>.<module>.<function> of the port, how it is called): each call
# of one runs under a profiler range "chain:<module>.<function>", so that a
# profiled pass counts its launches.  The batched SISO eq/demap's chains
# (`pdsch_eq`) are its plain version: on the card they must not run.
CHAINS = (("sniffer.pdsch_rx", "_eq_demap_fn", "call"),
          ("kernels.pdsch_eq", "_eq_demap_batch_fn", "factory"),
          ("kernels.pdsch_eq", "_eq_demap_prb_fn", "pair"),
          ("sniffer.pdsch_rx", "_eq_demap_mimo_fn", "factory"),
          ("sniffer.pusch_rx", "_eq_batch_ul_fn", "factory"),
          ("sniffer.pdcch_rx", "_candidate_decode_tail", "call"),
          ("sniffer.pdsch_rx", "_derm_turbo_static_fn", "factory"),
          ("sniffer.pusch_rx", "_derm_turbo_static_fn", "factory"),
          ("kernels.cb_derm", "derm_plain", "call"),
          ("sniffer.pdsch_rx", "_crc_pack", "call"))
PLAIN_CHAINS = ("pdsch_eq._eq_demap_batch_fn", "pdsch_eq._eq_demap_prb_fn")
# the batched DL dispatch's plain de-rate-match, turbo and packing chains
# (the uplink's dispatch still runs `_derm_turbo_static_fn`): a DL pass on
# the card runs none of them
DL_PLAIN_CHAINS = ("pdsch_rx._derm_turbo_static_fn", "cb_derm.derm_plain",
                   "pdsch_rx._crc_pack")


class chain_ranges:
    """Within the block, every call of a CHAINS function (or of the
    function its factory returns) runs under the profiler range
    "chain:<module>.<function>"."""

    def __enter__(self):
        import importlib
        import torch
        self.saved = []
        for mod_name, fn_name, kind in CHAINS:
            mod = importlib.import_module(f"ltesniffer_tpu_torch.{mod_name}")
            orig = getattr(mod, fn_name)
            tag = f"chain:{mod_name.rsplit('.', 1)[1]}.{fn_name}"

            def ranged(run, tag=tag):
                def inner(*a, **k):
                    with torch.profiler.record_function(tag):
                        return run(*a, **k)
                return inner
            if kind == "call":
                new = ranged(orig)
            elif kind == "factory":
                def new(*a, _orig=orig, _r=ranged, **k):
                    return _r(_orig(*a, **k))
            else:
                def new(*a, _orig=orig, _r=ranged, **k):
                    run, *rest = _orig(*a, **k)
                    return (_r(run), *rest)
            setattr(mod, fn_name, new)
            self.saved.append((mod, fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)
        return False


def chain_launches(p) -> dict:
    """{function: {calls, launches, copies}} of a profile taken under
    chain_ranges: the CUDA runtime's kernel launches and memory copies
    whose host call starts inside one of the function's ranges (the
    sniffer's host runs on one thread)."""
    from torch.autograd import DeviceType
    evs = [e for e in p.events() if e.device_type == DeviceType.CPU]
    ranges = {}
    for e in evs:
        if e.name.startswith("chain:"):
            ranges.setdefault(e.name[6:], []).append(
                (e.time_range.start, e.time_range.end))
    launch = [e.time_range.start for e in evs
              if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    copy = [e.time_range.start for e in evs
            if e.name.startswith("cudaMemcpy")]
    out = {}
    for name, rs in sorted(ranges.items()):
        def inside(ts):
            return sum(1 for t in ts if any(a <= t <= b for a, b in rs))
        out[name] = dict(calls=len(rs), launches=inside(launch),
                         copies=inside(copy))
    if ranges and not launch:
        out = {k: dict(v, launches=None) for k, v in out.items()}
    return out


def const_cache(when: str) -> tuple:
    """(entries of the port's constant cache, constants uploaded so far),
    logged."""
    from ltesniffer_tpu_torch.kernels import cplx
    n = (len(cplx._CONST_CACHE), cplx.UPLOADS["n"])
    log(f"  constant cache after the {when}: {n[0]} entries, {n[1]} host "
        "constants uploaded in this process")
    return n


def profile_pass(run, plain=PLAIN_CHAINS):
    """One more pass of a cell (`run()` returns its wall seconds) under
    torch.profiler: device time by kernel name, the device's busy share of
    the wall time, the host spans of the port's stage profiler, and the
    launches of each CHAINS function over the pass (returned); fails if a
    chain of `plain` ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ltesniffer_tpu_torch.sniffer import prof
    prof.reset()
    with chain_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as p:
        dt = run()
    from torch.autograd import DeviceType
    rows = []
    for e in p.key_averages():
        # kernels only: host ops carry their kernels' time as well, and
        # the chain ranges show on the device timeline as annotations
        if e.device_type != DeviceType.CUDA or e.key.startswith(
                ("chain:", "span:")):
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  device time: not measured (the profiler saw no kernels)")
    else:
        log(f"  profiled pass {dt:.2f} s wall; device busy {busy:.1f} ms "
            f"({100 * busy / (1e3 * dt):.1f} % of wall); "
            f"{sum(r[1] for r in rows)} device events")
        for ms, n, name in rows[:12]:
            log(f"    {ms:9.2f} ms {n:7d}x  {name[:90]}")
        for ms, n, name in rows:
            if any(k in name for k in ("turbo_decode_kernel", "bcjr_kernel",
                                       "viterbi_tb_kernel",
                                       "viterbi_search_kernel",
                                       "mimo_eq_demap_kernel",
                                       "pdsch_eq_demap_kernel",
                                       "cb_derm_kernel",
                                       "pdcch_pack_kernel",
                                       "pdcch_derm_kernel",
                                       "pdcch_crc_pack_kernel")):
                log(f"  port kernel {name[:60]}: {ms:.3f} ms over {n} "
                    f"launches ({100 * ms / busy:.2f} % of device time)")
    for line in prof.pretty().splitlines():
        log(f"  host span {line}")
    chains = chain_launches(p)
    for name, c in chains.items():
        per = ("not measured" if c["launches"] is None else
               f"{c['launches']} kernel launches "
               f"({c['launches'] / max(1, c['calls']):.1f} a call)")
        log(f"  launch chain {name}: {c['calls']} calls, {per}, "
            f"{c['copies']} memory copies "
            f"({c['copies'] / max(1, c['calls']):.1f} a call)")
    for name in plain:
        c = chains.get(name)
        if c and (c["calls"] or c["launches"]):
            raise AssertionError(f"the plain chain {name} ran on the card: "
                                 f"{c}")
    tail = chains.get("pdcch_rx._candidate_decode_tail")
    if not tail or not tail["calls"]:
        raise AssertionError("the profiled pass ran no search tail")
    if tail["copies"] != 0 or (tail["launches"] is not None and
                               tail["launches"] != 2 * tail["calls"]):
        raise AssertionError(f"the search tail made {tail['launches']} "
                             f"launches and {tail['copies']} copies in "
                             f"{tail['calls']} calls, not 2 and 0 a call")
    return chains


def compare_loaded(rec: dict, c, acc):
    """Hold one run against the expected record: equal accepted-DCI list;
    PDSCH CRC-ok sets within CRC_DIFF_MAX of the results.  A result is
    keyed by its DCI and its place among that DCI's results (codeword 0,
    then 1, for a two-codeword grant)."""
    want = [list(x) for x in rec["dcis"]]
    if acc != want:
        missing = [x for x in want if x not in acc][:10]
        extra = [x for x in acc if x not in want][:10]
        raise AssertionError(f"accepted DCIs differ: {len(acc)} vs "
                             f"{len(want)}; missing {missing}, extra {extra}")

    def keyed(pairs):
        seen, out = {}, set()
        for dci, ok in pairs:
            k = seen[dci] = seen.get(dci, -1) + 1
            if ok:
                out.add(dci + (k,))
        return out
    ok_want = keyed((tuple(want[i]), f == "1")
                    for i, f in zip(rec["pdsch_dci"], rec["pdsch_ok"]))
    ok_got = keyed(((r.dci.sfn * 10 + r.dci.sf_idx, int(r.dci.rnti),
                     r.dci.fmt), r.crc_ok) for r in c.results)
    diff = sorted(ok_want ^ ok_got)
    n_res = len(rec["pdsch_dci"])
    for d in diff:
        log(f"  CRC-ok differs: tti={d[0]} rnti={d[1]} fmt={d[2]} "
            f"result {d[3]} ({'expected only' if d in ok_want else 'card only'})")
    share = len(diff) / max(1, n_res)
    log(f"  CRC-ok set: {len(ok_got)} on the card, {len(ok_want)} expected, "
        f"{len(diff)} differ ({100 * share:.3f} % of {n_res} results)")
    if share > CRC_DIFF_MAX:
        raise AssertionError(f"CRC-ok sets differ in {100 * share:.3f} % "
                             f"of results (limit {100 * CRC_DIFF_MAX} %)")


def wrong_mimo(c) -> int:
    return sum(st.wrong_mimo for st in c.mcs.stats_dl.values())


# ---------------------------------------------------------------------------
# phase 6: the uplink
# ---------------------------------------------------------------------------
def run_ul_golden(device, tmp: str):
    from ltesniffer_tpu_torch.sniffer import core
    cell, dl, ul = ul_golden_scenario()
    out = os.path.join(tmp, "ul_golden.pcap")
    cfg = core.SnifferConfig(cell=cell, batch_size=8, pcap_path=out,
                             acquire_sfn=False, device=device)
    c = core.LTESnifferCoreUL(cfg)
    c.run_dual_samples(dl, ul)
    c.close()
    got = hashlib.sha256(open(out, "rb").read()).hexdigest()
    want = hashlib.sha256(open(GOLDEN_UL_PCAP, "rb").read()).hexdigest()
    n_ok = sum(r.crc_ok for r in c.ul_results)
    log(f"  UL golden pcap sha256 {got} ("
        f"{'equal' if got == want else 'DIFFERS'}); {n_ok} of "
        f"{len(c.ul_results)} PUSCH CRC-ok")
    if got != want:
        raise AssertionError(f"UL golden pcap sha256 {got} != {want}")


def run_ul(device, dl_packed, ul_packed, tmp: str):
    """The UL main path: run_dual_packed over the UL cell, logging the
    accepted DCI0s.  Returns (core, DCI0 log, seconds)."""
    import torch
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import ul_cell
    cfg = core.SnifferConfig(cell=ul_cell.CELL, batch_size=ul_cell.BATCH,
                             pcap_path=os.path.join(tmp, "ul.pcap"),
                             acquire_sfn=False, device=device)
    c = core.LTESnifferCoreUL(cfg)
    dci0 = ul_cell.log_dci0(c)
    t0 = time.perf_counter()
    c.run_dual_packed(dl_packed, ul_packed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c.close()
    return c, dci0, dt


def compare_ul(rec: dict, c, dci0, truth):
    """Hold one UL run against the expected record: equal accepted-DCI0
    list and result list (sfn, subframe, RNTI, in order), CRC-ok flags
    within CRC_DIFF_MAX of the results, every CRC-ok payload one the
    generator sent."""
    from ltesniffer_tpu_torch.testing import ul_cell
    if dci0 != rec["dci0"]:
        missing = [x for x in rec["dci0"] if x not in dci0][:10]
        extra = [x for x in dci0 if x not in rec["dci0"]][:10]
        raise AssertionError(f"accepted DCI0s differ: {len(dci0)} vs "
                             f"{len(rec['dci0'])}; missing {missing}, "
                             f"extra {extra}")
    rows = ul_cell.result_rows(c)
    if [r[:3] for r in rows] != [r[:3] for r in rec["results"]]:
        raise AssertionError(f"PUSCH result lists differ: {len(rows)} vs "
                             f"{len(rec['results'])} results")
    diff = [(g, w) for g, w in zip(rows, rec["results"]) if g[3] != w[3]]
    for g, w in diff[:20]:
        log(f"  CRC-ok differs: sfn={g[0]} sf={g[1]} rnti={g[2]} "
            f"({'card only' if g[3] else 'expected only'})")
    share = len(diff) / max(1, len(rows))
    n_ok = sum(r[3] for r in rows)
    log(f"  CRC-ok: {n_ok} on the card, {rec['crc_ok']} expected, "
        f"{len(diff)} differ ({100 * share:.3f} % of {len(rows)} results)")
    if share > CRC_DIFF_MAX:
        raise AssertionError(f"CRC-ok flags differ in {100 * share:.3f} % "
                             f"of results (limit {100 * CRC_DIFF_MAX} %)")
    sent = set(truth)
    bad = [r for r in c.ul_results if r.crc_ok and
           (r.sfn * 10 + r.sf_idx, int(r.rnti), r.payload) not in sent]
    log(f"  CRC-ok payloads not sent by the generator: {len(bad)}")
    if bad:
        raise AssertionError(f"{len(bad)} CRC-ok PUSCH payloads differ from "
                             "the generator's truth")


def run_uci(device):
    """tests/test_ul_mode_e2e.py:test_uci_ack_ri_through_core's scenario on
    the card: the PUSCH's payload must be the transmitted TB."""
    import numpy as np
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import ul_cell
    dl, ul, rnti, tb = ul_cell.uci_scenario()
    c = core.LTESnifferCoreUL(core.SnifferConfig(
        cell=ul_cell.UCI_CELL, batch_size=4, device=device))
    c.run_dual_samples(dl, ul)
    ok = [r for r in c.ul_results if r.crc_ok and r.rnti == rnti]
    got = (np.unpackbits(np.frombuffer(ok[0].payload, np.uint8))[:len(tb)]
           if ok else None)
    good = (len(c.ul_results) == 1 and got is not None
            and np.array_equal(got, tb))
    log(f"  UCI grant (HARQ-ACK + RI + aperiodic CQI): "
        f"{len(c.ul_results)} result(s), payload "
        f"{'equals' if good else 'DIFFERS from'} the transmitted TB")
    if not good:
        raise AssertionError("the UCI grant did not decode to the "
                             "transmitted TB")


# ---------------------------------------------------------------------------
# phase 7: stream, ingest and CLI
# ---------------------------------------------------------------------------
def host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run_dl_stream(device, stream, tmp: str, live: bool = False):
    """The live entry point: `run_source` over the DL stream in blocks of
    3 subframes + 777 samples, with the CLI's defaults (batch 32, chunks
    of 256 subframes, SFN from the MIB, i8 ingest).  Returns (core,
    accepted log, segments handed to run_samples, seconds)."""
    import torch
    from ltesniffer_tpu_torch.io import sdr
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell, stream_cell
    cell = loaded_cell.CELL
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=cell, batch_size=stream_cell.BATCH,
        pcap_path=os.path.join(tmp, "stream.pcap"), live_mode=live,
        live_buffer_sf=20, device=device))
    acc, segs = [], []

    def hook(ctx):
        for a in ctx["accepted"]:
            acc.append([ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt])
    c.on_subframe = hook
    inner = c.run_samples

    def run_samples(x, sf_idx0=0):
        segs.append([len(x) // cell.sf_len, sf_idx0])
        return inner(x, sf_idx0=sf_idx0)
    c.run_samples = run_samples
    t0 = time.perf_counter()
    c.run_source(sdr.ArraySource(stream, cell.srate,
                                 chunk_limit=stream_cell.dl_chunk_limit()),
                 chunk_subframes=stream_cell.CHUNK_SUBFRAMES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c.close()
    return c, acc, segs, dt


def framing_only_s(device, stream) -> float:
    """Host seconds of `run_source`'s own work on the DL stream (reads,
    cell search, tracker with its CFO mixer, tail carry, segment joins)
    with the segments dropped instead of decoded."""
    from ltesniffer_tpu_torch.io import sdr
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell, stream_cell
    cell = loaded_cell.CELL
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=cell, batch_size=stream_cell.BATCH, device=device))
    c.run_samples = lambda x, sf_idx0=0: None
    t0 = time.perf_counter()
    c.run_source(sdr.ArraySource(stream, cell.srate,
                                 chunk_limit=stream_cell.dl_chunk_limit()),
                 chunk_subframes=stream_cell.CHUNK_SUBFRAMES)
    return time.perf_counter() - t0


def stream_counts(c) -> dict:
    s = c.summary()
    return {k: s[k] for k in ("subframes", "resyncs", "sync_losses")}


def run_ul_stream(device, dl, ul, tmp: str):
    """`run_dual_source` over the two carriers, UL content UL_SKEW samples
    late.  Returns (core, DCI0 log, seconds)."""
    import torch
    from ltesniffer_tpu_torch.io import sdr
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import stream_cell, ul_cell
    cell = ul_cell.CELL
    c = core.LTESnifferCoreUL(core.SnifferConfig(
        cell=cell, batch_size=ul_cell.BATCH, acquire_sfn=False,
        pcap_path=os.path.join(tmp, "ul_stream.pcap"), device=device))
    dci0 = ul_cell.log_dci0(c)
    t0 = time.perf_counter()
    c.run_dual_source(sdr.ArraySource(dl, cell.srate),
                      sdr.ArraySource(ul, cell.srate),
                      chunk_subframes=stream_cell.CHUNK_SUBFRAMES,
                      ul_skew=stream_cell.UL_SKEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c.close()
    return c, dci0, dt


def run_ingest(device, tmp: str) -> dict:
    """The golden scenario through `run_samples` under the card's ingest
    options: {option key: pcap sha256}."""
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import stream_cell
    cell, stream, _ = stream_cell.golden_scenario()
    out = {}
    for ingest, depth in stream_cell.CHIP_INGEST:
        path = os.path.join(tmp, f"ingest_{ingest}_{depth}.pcap")
        c = core.LTESnifferCore(core.SnifferConfig(
            cell=cell, batch_size=8, pcap_path=path, api_mode=0,
            ingest=ingest, pipeline_depth=depth, device=device))
        c.run_samples(stream)
        c.close()
        out[stream_cell.ingest_key(ingest, depth)] = hashlib.sha256(
            open(path, "rb").read()).hexdigest()
    return out


# the CLI's main in a subprocess, with the Viterbi's and the search tail's
# counts printed after
CLI_WITH_COUNTS = (
    "import json, sys\n"
    "from ltesniffer_tpu_torch import cli\n"
    "from ltesniffer_tpu_torch.kernels import pdcch_tail, viterbi\n"
    "from ltesniffer_tpu_torch.sniffer import pdcch_rx\n"
    "calls, real = [0], pdcch_rx._candidate_decode_tail\n"
    "def counted(*a, **k):\n"
    "    calls[0] += 1\n"
    "    return real(*a, **k)\n"
    "pdcch_rx._candidate_decode_tail = counted\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('viterbi_counts ' + json.dumps([viterbi.LAUNCHES['viterbi'], "
    "viterbi.PLAIN_CUDA['viterbi'], calls[0], "
    "dict(viterbi_search=viterbi.LAUNCHES['viterbi_search'], "
    "**pdcch_tail.LAUNCHES), sum(pdcch_tail.PLAIN_CUDA.values())]))\n"
    "sys.exit(rc)\n")


def run_cli(tmp: str) -> tuple:
    """The CLI as a user runs it, in a subprocess on the card: `--sync`
    over the golden stream behind a noise lead, written as an IQ file.
    Returns (pcap sha256, stats without the clock fields, seconds, the
    process's [Viterbi plain-entry launches, plain step loops on the card,
    search tails, the tail kernels' launches, plain tails on the
    card])."""
    from ltesniffer_tpu_torch.io import iq as iq_mod
    from ltesniffer_tpu_torch.testing import stream_cell
    cell, stream, _ = stream_cell.golden_scenario()
    iq_path = os.path.join(tmp, "golden_lead.iq")
    iq_mod.write_iq(iq_path, stream_cell.cli_stream(stream))
    pc, st = os.path.join(tmp, "cli.pcap"), os.path.join(tmp, "cli.json")
    cmd = [sys.executable, "-c", CLI_WITH_COUNTS] + \
        stream_cell.cli_args(cell, iq_path, pc, st)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    dt = time.perf_counter() - t0
    for line in r.stdout.splitlines()[:3]:
        log(f"  cli: {line}")
    if r.returncode != 0:
        raise AssertionError(f"the CLI exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    stats = json.load(open(st))
    for k in stream_cell.CLI_CLOCK_KEYS:
        stats.pop(k)
    counts = [json.loads(line.split(" ", 1)[1])
              for line in r.stdout.splitlines()
              if line.startswith("viterbi_counts ")][-1]
    return (hashlib.sha256(open(pc, "rb").read()).hexdigest(), stats, dt,
            counts)


# ---------------------------------------------------------------------------
# phase 8: scaling out
# ---------------------------------------------------------------------------
def run_sharded(stream, mesh, single_device) -> dict:
    """8a: one batch of the loaded cell through the split over `mesh`, and
    through `make_pipeline` on `single_device` twice: shard by shard (the
    same shapes as the split) and as the whole batch in one call."""
    import numpy as np
    from ltesniffer_tpu_torch.parallel import sharding
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    from ltesniffer_tpu_torch.testing import loaded_cell
    cell = loaded_cell.CELL
    n = cell.sf_len
    x = stream[:SHARD_BATCH * n].reshape(SHARD_BATCH, 1, n)
    sfs = np.arange(SHARD_BATCH) % 10
    fe = sharding.make_sharded_frontend(cell, mesh)
    search, st = sharding.make_sharded_search(cell, SHARD_CFI, mesh)
    run, _ = pdcch_rx.make_pipeline(cell, SHARD_CFI)
    sizes = sorted({st["sizes"][f] + 16 for f in st["sizes"]})
    keys = [f"{p}_{D}" for D in sizes for p in ("rnti", "bits")] + [
        "cce_power", "snr_db"]
    m = SHARD_BATCH // mesh.size

    def sharded():
        s_d, sf_d = sharding.shard_subframes(mesh, x, sfs)
        return sharding.gather(search(fe(s_d, sf_d), sf_d), keys)

    def single(step):
        outs = [run(x[i:i + step], sfs[i:i + step], device=single_device)
                for i in range(0, SHARD_BATCH, step)]
        return sharding.gather(outs, keys)

    def timed(fn):
        fn()                            # the first call uploads constants
        t0 = time.perf_counter()
        out = fn()                      # the host reads every shard back
        return out, time.perf_counter() - t0
    reset_counts()                      # the split's own launches only
    got, t_sharded = timed(sharded)
    n_vit = viterbi_count(f"split over {mesh.size} shards")
    want, t_single = timed(lambda: single(SHARD_BATCH))
    return dict(got=got, want=want, per_shard=single(m), sizes=sizes,
                st=st, sfs=sfs, t_sharded=t_sharded, t_single=t_single,
                viterbi=n_vit)


def resolve_all(out: dict, st: dict, sfs):
    """The native resolver (fresh state) over a search's subframes, fed
    its per-size bits and RNTIs: the accepted DCIs, (subframe, RNTI,
    format, L, CCE, payload bits)."""
    from ltesniffer_tpu_torch import native
    from ltesniffer_tpu_torch.testing import loaded_cell
    search = native.NativeDciBlindSearch(loaded_cell.CELL,
                                         native.default_native_manager())
    acc = []
    for b, sf in enumerate(sfs):
        for a in search.resolve_subframe(out, b, st["locs"], st["nof_cce"],
                                         int(sf), sfn=b // 10):
            acc.append((b, a.rnti, a.fmt, a.l, a.ncce,
                        bytes(a.payload.astype("uint8"))))
    return acc


def compare_sharded(r: dict):
    """The split against make_pipeline on one card: shard by shard every
    output equal; against the whole batch in one call, CCE powers within
    SHARD_RTOL / SHARD_ATOL and the resolver's accepted DCIs (payloads
    included) equal.  The card's matrix products pick their kernels by
    shape, so a 64-subframe call and a 256-subframe call differ in the
    last bit of most grid values, and candidates that carry no DCI decode
    noise through near-tie path metrics: their RNTIs and bits are counted,
    not required equal."""
    import numpy as np
    got, shard, full = r["got"], r["per_shard"], r["want"]
    for k in got:
        n = int((got[k] != shard[k]).sum())
        if n:
            raise AssertionError(f"8a: {k}: {n} values differ between the "
                                 "split and make_pipeline on the same "
                                 "shards")
    np.testing.assert_allclose(got["cce_power"], full["cce_power"],
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    e = float(np.abs(got["cce_power"] - full["cce_power"]).max())
    acc_got = resolve_all(got, r["st"], r["sfs"])
    acc_full = resolve_all(full, r["st"], r["sfs"])
    if acc_got != acc_full:
        diff = sorted(set(acc_got) ^ set(acc_full))[:5]
        raise AssertionError(f"8a: accepted DCIs differ: {len(acc_got)} vs "
                             f"{len(acc_full)}; e.g. {diff}")
    n_cand = sum(got[f"rnti_{D}"].size for D in r["sizes"])
    n_noise = sum(int((got[f"rnti_{D}"] != full[f"rnti_{D}"]).sum())
                  for D in r["sizes"])
    n_bits = sum(int((got[f"bits_{D}"] != full[f"bits_{D}"]).any(-1).sum())
                 for D in r["sizes"])
    log(f"  the split equals make_pipeline on the same shards (every output "
        f"of {len(r['sizes'])} payload sizes, bit for bit); against the "
        f"whole batch in one call: CCE power max |diff| {e:.3e} (rtol "
        f"{SHARD_RTOL}, atol {SHARD_ATOL}), {len(acc_got)} accepted DCIs "
        f"equal, {n_noise} RNTIs and {n_bits} bit rows of {n_cand} "
        "candidates differ, none of them an accepted DCI")


def run_blocks(device, stream, tmp: str) -> dict:
    """8b: the loaded cell in time blocks on the card, merged, and the
    single-host run beside it."""
    import torch
    from ltesniffer_tpu_torch.io import pcap as pcap_mod
    from ltesniffer_tpu_torch.kernels import bcjr, turbo_decode
    from ltesniffer_tpu_torch.parallel import multihost
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell, multihost_cell
    cell = loaded_cell.CELL
    wd = os.path.join(tmp, "blocks")
    os.makedirs(wd)
    sync = torch.cuda.synchronize \
        if torch.device(device).type == "cuda" else None
    reset_counts()
    blocks, cores, logs, secs = multihost_cell.run_hosts(
        core, multihost, cell, stream, wd, sync=sync, device=device)
    launches = (turbo_decode.LAUNCHES["turbo_decode"], bcjr.LAUNCHES["bcjr"])
    n_vit = viterbi_count("time blocks")
    merged_recs = multihost.merge_pcap_records(
        [pcap_mod.read_pcap(os.path.join(wd, f"host{b.host}.pcap"))
         for b in blocks], blocks)
    single_path = os.path.join(tmp, "blocks_single.pcap")
    _, _, t_single = multihost_cell.run_single(
        core, cell, stream, single_path, sync=sync, device=device)
    single_recs = pcap_mod.read_pcap(single_path)
    return dict(
        blocks=blocks, secs=secs, launches=launches, viterbi=n_vit,
        dcis=multihost_cell.merged_dcis(multihost, logs, blocks),
        results=multihost.merge_accepted([c.results for c in cores], blocks),
        merged_recs=merged_recs, single_recs=single_recs, t_single=t_single,
        n_differ=multihost_cell.count_differing(merged_recs, single_recs))


def run_runner(stream, tmp: str) -> dict:
    """8c: the process-per-block runner on a file of the stream."""
    from ltesniffer_tpu_torch.io import iq as iq_mod, pcap as pcap_mod
    from ltesniffer_tpu_torch.testing import loaded_cell, multihost_cell
    cell = loaded_cell.CELL
    iq_path = os.path.join(tmp, "loaded.iq")
    iq_mod.write_iq(iq_path, stream)
    out = os.path.join(tmp, "runner.pcap")
    wd = os.path.join(tmp, "runner")
    cmd = [sys.executable, "-m", "ltesniffer_tpu_torch.parallel.run_multihost",
           "-i", iq_path, "-c", str(cell.n_id_cell), "-p", str(cell.n_prb),
           "-P", str(cell.nof_ports), "-n", str(multihost_cell.N_HOSTS),
           "-B", str(multihost_cell.BATCH),
           "--overlap", str(multihost_cell.OVERLAP_SF), "-o", out,
           "--workdir", wd]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    dt = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"  runner: {line}")
    if r.returncode != 0:
        raise AssertionError(f"the runner exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    children = [json.load(open(os.path.join(wd, f"host{h}.json")))
                for h in range(multihost_cell.N_HOSTS)]
    return dict(recs=pcap_mod.read_pcap(out), seconds=dt,
                children=children)


def scale_out(device, card: str, loaded_stream, placed: int,
              tmp: str) -> dict:
    """Phase 8: the split over devices, time blocks, the runner.  Returns
    the launch counts for the `kernels` line."""
    import torch
    from ltesniffer_tpu_torch.parallel import sharding
    from ltesniffer_tpu_torch.testing import loaded_cell, multihost_cell
    with Phase(f"8a the split over devices: {SHARD_BATCH} subframes of "
               f"the loaded cell at CFI {SHARD_CFI}"):
        # 4 shards on cuda:0 always; with more cards also one per card
        n_cards = torch.cuda.device_count()
        meshes = [sharding.make_mesh(["cuda:0"] * 4)]
        if n_cards > 1:
            meshes.append(sharding.make_mesh())
        n_split = 0
        for mesh in meshes:
            n_on = len(set(mesh.devices))
            where = (f"{mesh.size} shards on {n_on} card"
                     f"{'s' if n_on > 1 else ''}")
            log(f"  mesh {[str(d) for d in mesh.devices]} ({where})")
            r8a = run_sharded(loaded_stream, mesh, "cuda:0")
            n_split += r8a["viterbi"]
            compare_sharded(r8a)
            log(f"  on {card}: split frontend + search "
                f"{r8a['t_sharded']:.3f} s "
                f"({SHARD_BATCH / r8a['t_sharded']:.1f} sf/s, {where}); "
                f"make_pipeline on cuda:0 {r8a['t_single']:.3f} s "
                f"({SHARD_BATCH / r8a['t_single']:.1f} sf/s); both warm, "
                "host arrays in and out")
        if n_cards < 2:
            log("  the mesh of distinct cards did not run: only one card "
                "is present")
        vit = {"split": n_split}
    with Phase("8b time blocks: the loaded cell, 512 subframes, 2 blocks, "
               "overlap 200, batch 8"):
        rec_mh = json.load(open(EXPECTED_MULTIHOST))
        if rec_mh["params"] != multihost_cell.params() or \
                rec_mh["placed"] != placed:
            raise AssertionError("multihost record does not match the "
                                 "scenario")
        r8b = run_blocks(device, loaded_stream, tmp)
        n_fused_mh, n_pass_mh = r8b["launches"]
        for b, sec in zip(r8b["blocks"], r8b["secs"]):
            n_b = b.warmup_sf + b.own_count_sf
            log(f"  block {b.host}: {n_b} subframes ({b.warmup_sf} "
                f"replayed, {b.own_count_sf} owned) in {sec:.2f} s: "
                f"{n_b / sec:.1f} sf/s, {b.own_count_sf / sec:.1f} owned "
                f"sf/s on {card}")
        t_blocks = sum(r8b["secs"])
        log(f"  whole run, blocks one after another: "
            f"{loaded_cell.N_SF / t_blocks:.1f} owned sf/s "
            f"({t_blocks:.2f} s); single host at batch "
            f"{multihost_cell.BATCH}: "
            f"{loaded_cell.N_SF / r8b['t_single']:.1f} sf/s "
            f"({r8b['t_single']:.2f} s)")
        log(f"  merged: {len(r8b['dcis'])} DCIs, {len(r8b['results'])} "
            f"results, {len(r8b['merged_recs'])} pcap records; single "
            f"host {len(r8b['single_recs'])}; differing "
            f"{r8b['n_differ']} (JAX package: "
            f"{rec_mh['n_records_differ']})")
        log(f"  launches in this run: turbo_decode (fused) {n_fused_mh}, "
            f"bcjr (pass kernel) {n_pass_mh}")
        compare_loaded(rec_mh, types.SimpleNamespace(
            results=r8b["results"]), r8b["dcis"])
        if r8b["n_differ"] != rec_mh["n_records_differ"]:
            raise AssertionError(
                f"{r8b['n_differ']} merged records differ from the "
                f"single-host run; the JAX package's merge: "
                f"{rec_mh['n_records_differ']}")
        if n_fused_mh <= 0:
            raise AssertionError("the time blocks launched no fused "
                                 "turbo kernel")
        if n_pass_mh != 0:
            raise AssertionError(f"the time blocks launched the pass "
                                 f"kernel {n_pass_mh} times")
    with Phase("8c the runner: one process per block"):
        r8c = run_runner(loaded_stream, tmp)
        for h, ch in enumerate(r8c["children"]):
            log(f"  child {h} on {ch['device']}: {ch['subframes']} "
                f"subframes in {ch['seconds']:.2f} s; launches "
                f"{ch['launches']}")
        log(f"  runner: {len(r8c['recs'])} merged records in "
            f"{r8c['seconds']:.1f} s wall with start-up on {card}")
        key = multihost_cell.pcap_key
        if [key(x) for x in r8c["recs"]] != \
                [key(x) for x in r8b["merged_recs"]]:
            raise AssertionError("the runner's merged pcap records "
                                 "differ from 8b's")
        if any(ch["launches"]["turbo_decode"] <= 0 or
               ch["launches"]["bcjr"] for ch in r8c["children"]):
            raise AssertionError("a runner child did not decode through "
                                 "the fused kernel alone")
        if any(ch["launches"]["viterbi_search"] <= 0 or
               ch["launches"]["viterbi_plain_cuda"]
               for ch in r8c["children"]):
            raise AssertionError("a runner child did not search through "
                                 "the Viterbi kernel alone")
        for h, ch in enumerate(r8c["children"]):
            la = ch["launches"]
            tail_check(f"runner child {h}", None,
                       {k: la[k] for k in TAIL_KERNELS},
                       la["pdcch_tail_plain_cuda"])
            VIT_LAUNCHES[f"runner child {h}"] = la["viterbi"]
    vit["multihost"] = r8b["viterbi"]
    vit["runner"] = [ch["launches"]["viterbi"] +
                     ch["launches"]["viterbi_search"]
                     for ch in r8c["children"]]
    return {"fused": n_fused_mh, "pass": n_pass_mh,
            "runner": [ch["launches"]["turbo_decode"]
                       for ch in r8c["children"]], "viterbi": vit}


def main() -> int:
    import numpy as np
    import torch
    if no_card():
        return 2
    sys.path.insert(0, REPO)
    from ltesniffer_tpu_torch import native
    from ltesniffer_tpu_torch.kernels import bcjr, nvcc_build, turbo_decode
    from ltesniffer_tpu_torch.kernels import cb_derm, mimo_eq, pdcch_tail
    from ltesniffer_tpu_torch.kernels import pdsch_eq, tb_finish, viterbi
    from ltesniffer_tpu_torch.phy import tables, turbo as turbo_host
    from ltesniffer_tpu_torch.io import sdr
    from ltesniffer_tpu_torch.sniffer import core, prof
    from ltesniffer_tpu_torch.sniffer import sync
    from ltesniffer_tpu_torch.testing import loaded_cell, mimo_cell, ul_cell
    from ltesniffer_tpu_torch.testing import stream_cell
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(20260817)
    count_tail_calls()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("1 card and build"):
            card = card_line()
            log(card)
            log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
                f"device {kind}")
            # one compiler run for each source, all started together
            with concurrent.futures.ThreadPoolExecutor(9) as ex:
                builds = {m.__name__.rsplit(".", 1)[1]: ex.submit(m.build)
                          for m in (turbo_decode, bcjr, viterbi, mimo_eq,
                                    pdcch_tail, tb_finish, pdsch_eq,
                                    cb_derm, native)}
            for name, mod in (("turbo_decode", "turbo_decode"),
                              ("bcjr", "bcjr"), ("viterbi_tb", "viterbi"),
                              ("mimo_eq_demap", "mimo_eq"),
                              ("pdcch_tail", "pdcch_tail"),
                              ("tb_finish", "tb_finish"),
                              ("pdsch_eq_demap", "pdsch_eq"),
                              ("cb_derm", "cb_derm")):
                log(f"  nvcc build of kernels/csrc/{name}.cu: "
                    f"{builds[mod].result():.2f} s")
                sass = nvcc_build.sass_counts(name)
                for fn, regs, st, ld in nvcc_build.ptxas_report(name):
                    log(f"  ptxas {name}: {regs} registers, {st} bytes "
                        f"spill stores, {ld} bytes spill loads, "
                        f"{sass.get(fn, 'n/a')} SASS instructions ({fn})")
            log(f"  g++ build of csrc/resolver.cpp (native resolver): "
                f"{builds['native'].result():.2f} s")
        with Phase("scenarios (port generator)"):
            _, _, golden_truth = stream_cell.golden_scenario()
            t0 = time.perf_counter()
            loaded_stream, placed, loaded_truth = loaded_cell.build_stream()
            words, scales = loaded_cell.pack(loaded_stream)
            log(f"  loaded cell: {loaded_cell.N_SF} subframes, {placed} "
                f"placed TBs, built in {time.perf_counter() - t0:.1f} s")
            rec = json.load(open(EXPECTED))
            if rec["params"] != loaded_cell.params() or \
                    rec["placed"] != placed:
                raise AssertionError("expected record does not match the "
                                     "scenario")
            t0 = time.perf_counter()
            m_words, m_scales, mimo_truth = mimo_cell.build_packed()
            log(f"  MIMO cell: {mimo_cell.N_SF} subframes, "
                f"{len(mimo_truth)} placed TBs, built in "
                f"{time.perf_counter() - t0:.1f} s")
            rec_mimo = json.load(open(EXPECTED_MIMO))
            if rec_mimo["params"] != mimo_cell.params() or \
                    rec_mimo["placed"] != len(mimo_truth) or \
                    rec_mimo["config"]["batch_size"] != MIMO_BATCH:
                raise AssertionError("MIMO expected record does not match "
                                     "the scenario")
            t0 = time.perf_counter()
            ul_dl, ul_ul, ul_placed, ul_truth = ul_cell.build_packed()
            log(f"  UL cell: {ul_cell.N_SF} subframes, {ul_placed} placed "
                f"DCI0s, {len(ul_truth)} PUSCH sent, built in "
                f"{time.perf_counter() - t0:.1f} s")
            rec_ul = json.load(open(EXPECTED_UL))
            if rec_ul["params"] != ul_cell.params() or \
                    rec_ul["placed"] != ul_placed or \
                    rec_ul["config"]["batch_size"] != ul_cell.BATCH:
                raise AssertionError("UL expected record does not match "
                                     "the scenario")
        with Phase("2 kernels vs plain version"):
            ks_loaded = code_block_sizes(loaded_truth)
            ks = dict(ks_loaded)
            for K, m in code_block_sizes(golden_truth).items():
                ks.setdefault(K, m)
            # the smallest block and the largest shared-memory case
            ks.setdefault(40, 8)
            ks.setdefault(6144, 8)
            log(f"  K values: {sorted(ks)}")
            err = check_decoders(ks, device, rng)
            # the MIMO cell: n_iter 8, two code blocks per call (one
            # two-codeword grant whose codewords share K)
            ks_mimo = code_block_sizes(
                [t for t in mimo_truth if t["fmt"] != "1A"])
            log(f"  MIMO K values (n_iter {MIMO_N_ITER}): {sorted(ks_mimo)}")
            err_m = check_decoders(ks_mimo, device, rng,
                                   iters=(MIMO_N_ITER,), blocks=2)
            for k in err:
                err[k] = max(err[k], err_m[k])
            # the uplink: the UL cell's and UL golden's grants (MCS 6 on
            # 8 PRB) and the UCI grant (MCS 6 on 10 PRB)
            ks_ul = {}
            for n_prb in (ul_cell.N_PRB_GRANT, 10):
                _, itbs = tables.ul_mcs_to_qm_itbs(ul_cell.UL_MCS)
                for K in turbo_host.segment_sizes(
                        tables.tbs_lookup(itbs, n_prb)).K:
                    ks_ul[K] = ks_ul.get(K, 0) + ul_cell.GRANTS * \
                        ul_cell.BATCH
            log(f"  UL K values (n_iter 2 and 12): {sorted(ks_ul)}")
            err_u = check_decoders(ks_ul, device, rng)
            for k in err:
                err[k] = max(err[k], err_u[k])
            # timing at the loaded cell's most common K, with the code
            # blocks one batch of 256 subframes carries
            K_main = max(ks_loaded, key=ks_loaded.get)
            B_main = ks_loaded[K_main] * 256 // loaded_cell.N_SF
            td = time_decoders(K_main, B_main, device, rng)
            geo = turbo_decode.launch_geometry(K_main, B_main)
            # one MIMO-shaped decode: the cell's most common K, the code
            # blocks of one two-codeword grant at that K
            K_mimo = max(ks_mimo, key=ks_mimo.get)
            B_mimo = grant_blocks(
                K_mimo, [t for t in mimo_truth if t["fmt"] != "1A"])
            td[MIMO_N_ITER] = time_decoders(K_mimo, B_mimo, device, rng,
                                            iters=(MIMO_N_ITER,))[MIMO_N_ITER]
            # the UL cell: K = 832, the code blocks of the grants of one
            # batch of 256 subframes in one call, n_iter 2
            _, itbs = tables.ul_mcs_to_qm_itbs(ul_cell.UL_MCS)
            K_ul = turbo_host.segment_sizes(
                tables.tbs_lookup(itbs, ul_cell.N_PRB_GRANT)).K[0]
            B_ul = ul_cell.GRANTS * ul_cell.BATCH
            t_ul = time_decoders(K_ul, B_ul, device, rng, iters=(2,))[2]
            log(f"  whole decode at the UL cell's shape K={K_ul}, B={B_ul}, "
                f"n_iter=2 on {card}: fused kernel {t_ul['ms']:.4f} ms "
                f"(turns {t_ul['ms_turns'][0]:.4f}, "
                f"{t_ul['ms_turns'][1]:.4f}); lane decoder + pass kernel "
                f"{t_ul['lanes_ms']:.4f} ms; plain version "
                f"{t_ul['plain_ms']:.4f} ms; bound {t_ul['bound_ms']:.4f} "
                f"ms ({t_ul['bound_by']})")
            for n_iter, t in td.items():
                K, B = (K_mimo, B_mimo) if n_iter == MIMO_N_ITER else \
                    (K_main, B_main)
                log(f"  whole decode at K={K}, B={B}, n_iter="
                    f"{n_iter} on {card}: fused kernel {t['ms']:.4f} ms "
                    f"(turns {t['ms_turns'][0]:.4f}, {t['ms_turns'][1]:.4f})"
                    f"; lane decoder + pass kernel {t['lanes_ms']:.4f} ms "
                    f"(turns {t['lanes_turns'][0]:.4f}, "
                    f"{t['lanes_turns'][1]:.4f}); plain version "
                    f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}: max(ops / 67 TFLOP/s, bytes / "
                    f"3.35 TB/s))")
            log(f"  fused launch at the main shape: {geo['ctas']} CTAs x "
                f"{geo['threads']} threads ({geo['G']} code blocks of "
                f"{geo['NW']} windows, W={geo['W']}, S={geo['S']}), "
                f"{geo['smem']} bytes of shared memory each")
            tm = time_bcjr(K_main, B_main, device)
            log(f"  one pass at K={K_main} (W={tm['W']}, L={tm['L']}) on "
                f"{card}: kernel {tm['ms']:.4f} ms, plain twin "
                f"{tm['plain_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
                f"({tm['bound_by']}: (4W+32)*L*4 B over 3.35 TB/s); no "
                "single PyTorch call computes a BCJR pass or a turbo "
                "decode, so there is no library time")
        with Phase("2b the Viterbi kernel vs its plain version"):
            tv = check_viterbi(device, loaded_stream, rng)
            report_viterbi(tv, card)
        with Phase("2c the two-codeword eq/demap kernel vs its plain "
                   "version"):
            tq = check_mimo_eq(device, m_words, m_scales, tmp, card)
        with Phase("2d the search tail: the two-launch route vs the "
                   "three-launch route and the plain versions"):
            tt = check_pdcch_tail(device, loaded_stream, rng, card)
        with Phase("2e the transport-block finish vs its plain version"):
            tf = check_tb_finish(device, rng, card)
        with Phase("2f the batched single-layer eq/demap vs its plain "
                   "version"):
            te = check_pdsch_eq(device, card)
        with Phase("2g the batched de-rate-match and the turbo kernel's "
                   "packing entry vs their plain versions"):
            tdm = check_cb_derm(device, card)
        with Phase("3 golden scenario on the card"):
            reset_counts()
            run_golden(device, tmp)
            vit = {"golden": viterbi_count("golden scenario")}
        with Phase("4 loaded cell, 20 MHz, 512 subframes, batch 256, "
                   "format-2A load"):
            prof.reset()
            reset_counts()
            c, acc, dt = run_loaded(device, words, scales, tmp)
            n_fused = turbo_decode.LAUNCHES["turbo_decode"]
            n_pass = bcjr.LAUNCHES["bcjr"]
            vit["loaded"] = viterbi_count("loaded cell")
            search = prof.report().get("p2_search", {"s": 0.0, "n": 0})
            log(f"  p2_search span {search['s']:.4f} s over {search['n']} "
                "batches (first pass)")
            resolve = prof.report().get("resolve", {"s": 0.0, "n": 0})
            s = c.summary()
            log(f"  summary: subframes {s['subframes']}, dcis {s['dcis']}, "
                f"pdsch_ok {s['pdsch_ok']}, placed {placed} "
                f"(pdsch_ok/placed {s['pdsch_ok'] / placed:.4f}), "
                f"wrong-MIMO {wrong_mimo(c)} (expected "
                f"{rec['wrong_mimo']})")
            log(f"  resolver: {type(c.search).__module__}."
                f"{type(c.search).__name__}; resolve span {resolve['s']:.4f}"
                f" s over {resolve['n']} subframes")
            log(f"  {loaded_cell.N_SF / dt:.1f} subframes/s on {card} "
                f"({dt:.2f} s wall, first reading, not a target)")
            log(f"  launches in this run: turbo_decode (fused) {n_fused}, "
                f"bcjr (pass kernel) {n_pass}")
            const_passes = [const_cache("first pass")]
            compare_loaded(rec, c, acc)
            if not isinstance(c.search, native.NativeDciBlindSearch):
                raise AssertionError("the main path did not run the native "
                                     "resolver")
            if wrong_mimo(c) != rec["wrong_mimo"]:
                raise AssertionError(f"wrong-MIMO count {wrong_mimo(c)} != "
                                     f"{rec['wrong_mimo']}")
            if n_fused <= 0:
                raise AssertionError("the main path launched no fused "
                                     "turbo kernel")
            if n_pass != 0:
                raise AssertionError(f"the main path launched the pass "
                                     f"kernel {n_pass} times")
            cnt = prof.counters()
            n_tbf = tb_finish.LAUNCHES["tb_finish"]
            dev_tb = cnt.get("pdsch_tb_device", {"total": 0, "events": 0})
            log(f"  tb_finish launches {n_tbf}: {dev_tb['total']} blocks "
                f"finished on the card in {dev_tb['events']} dispatches, "
                f"{cnt.get('pdsch_tb_host', {'total': 0})['total']} on the "
                "host (single-grant path)")
            if n_tbf <= 0 or n_tbf != dev_tb["events"]:
                raise AssertionError(f"tb_finish launched {n_tbf} times for "
                                     f"{dev_tb['events']} batched dispatches")
            n_peq = pdsch_eq.LAUNCHES["pdsch_eq_demap"]
            n_disp = sum(cnt.get(k, {"events": 0})["events"]
                         for k in ("pdsch_grant", "pdsch_grant_retried"))
            n_single = host_reads("grant_llr")
            eq_g = cnt.get("pdsch_eq_grants", {"total": 0, "events": 0})
            log(f"  pdsch_eq_demap launches {n_peq}: {eq_g['total']} grants "
                f"({eq_g['total'] / max(1, eq_g['events']):.1f} a launch) "
                f"for {n_disp} batched dispatches and {n_single} single-grant "
                "decodes")
            if n_peq <= 0 or n_peq != n_disp + n_single or \
                    eq_g["events"] != n_peq:
                raise AssertionError(f"pdsch_eq_demap launched {n_peq} times "
                                     f"for {n_disp} batched dispatches and "
                                     f"{n_single} single-grant decodes")
            # the first pass pays one-time costs (constant tables, Gold
            # bases, first launches); a second pass reads the warm rate
            prof.reset()
            _, _, dt2 = run_loaded(device, words, scales, tmp)
            search = prof.report().get("p2_search", {"s": 0.0, "n": 0})
            log(f"  warm second pass: {loaded_cell.N_SF / dt2:.1f} "
                f"subframes/s on {card} ({dt2:.2f} s wall; p2_search "
                f"{search['s']:.4f} s)")
            const_passes.append(const_cache("warm second pass"))
        with Phase("4b where the time goes (profiled third pass)"):
            chains = {"loaded": profile_pass(
                lambda: run_loaded(device, words, scales, tmp)[2],
                PLAIN_CHAINS + DL_PLAIN_CHAINS)}
            const_passes.append(const_cache("profiled third pass"))
            if const_passes[2][1] != const_passes[1][1] or \
                    const_passes[2][0] > const_passes[1][0]:
                raise AssertionError(f"the constant cache grew from the "
                                     f"second pass to the third: "
                                     f"{const_passes[1:]}")
        with Phase("5 MIMO cell, 20 MHz, 2x2, 64 subframes, batch "
                   f"{MIMO_BATCH}"):
            reset_counts()
            prof.reset()
            cm, acc_m, dt_m = run_loaded(device, m_words, m_scales, tmp,
                                         batch_size=MIMO_BATCH,
                                         cell=mimo_cell.CELL)
            n_fused_m = turbo_decode.LAUNCHES["turbo_decode"]
            n_pass_m = bcjr.LAUNCHES["bcjr"]
            n_eq_m = mimo_eq.LAUNCHES["mimo_eq_demap"]
            n_eq_plain = mimo_eq.PLAIN_CUDA["mimo_eq_demap"]
            vit["mimo"] = viterbi_count("MIMO cell")
            reads = host_reads("mimo_llr", "mimo_bits")
            sm = cm.summary()
            n_2tb = sum(1 for a in acc_m if a[2] in ("2", "2A"))
            mspan = prof.report().get("p3_mimo", {"s": 0.0, "n": 0})
            log(f"  summary: subframes {sm['subframes']}, dcis "
                f"{sm['dcis']}, pdsch_ok {sm['pdsch_ok']}, placed "
                f"{len(mimo_truth)}, two-codeword DCIs {n_2tb}, wrong-MIMO "
                f"{wrong_mimo(cm)}")
            log(f"  {mimo_cell.N_SF / dt_m:.1f} subframes/s on {card} "
                f"({dt_m:.2f} s wall, first reading, not a target)")
            log(f"  two-codeword path: {reads} host reads for {n_2tb} "
                f"grants; p3_mimo span {mspan['s']:.4f} s over "
                f"{mspan['n']} decodes")
            log(f"  launches in this run: turbo_decode (fused) {n_fused_m},"
                f" bcjr (pass kernel) {n_pass_m}, mimo_eq_demap {n_eq_m} "
                f"(plain eq/demap chains on the card {n_eq_plain}); per "
                f"two-codeword decode: {n_eq_m / max(1, mspan['n']):.2f} "
                f"eq/demap launches, {n_fused_m / max(1, mspan['n']):.2f} "
                f"turbo launches, {reads / max(1, mspan['n']):.2f} host "
                "reads")
            compare_loaded(rec_mimo, cm, acc_m)
            sent = {(t["sf"], t["rnti"], t["payload"]) for t in mimo_truth}
            bad = [r for r in cm.results if r.crc_ok and (
                r.dci.sfn * 10 + r.dci.sf_idx, int(r.dci.rnti), r.payload)
                not in sent]
            log(f"  CRC-ok payloads not sent by the generator: {len(bad)}")
            if bad:
                raise AssertionError(f"{len(bad)} CRC-ok payloads differ "
                                     "from the generator's truth")
            if n_2tb == 0 or reads <= 0:
                raise AssertionError("the MIMO cell decoded no "
                                     "two-codeword grant")
            if n_fused_m <= 0:
                raise AssertionError("the MIMO path launched no fused "
                                     "turbo kernel")
            if n_pass_m != 0:
                raise AssertionError(f"the MIMO path launched the pass "
                                     f"kernel {n_pass_m} times")
            if n_eq_m != mspan["n"] or n_eq_m <= 0:
                raise AssertionError(f"mimo_eq_demap launched {n_eq_m} times"
                                     f" for {mspan['n']} two-codeword "
                                     "decodes")
            if n_eq_plain != 0:
                raise AssertionError(f"the MIMO path ran the plain eq/demap "
                                     f"chain on the card {n_eq_plain} times")
            prof.reset()
            _, _, dt_m2 = run_loaded(device, m_words, m_scales, tmp,
                                     batch_size=MIMO_BATCH,
                                     cell=mimo_cell.CELL)
            mspan2 = prof.report().get("p3_mimo", {"s": 0.0, "n": 0})
            log(f"  warm second pass: {mimo_cell.N_SF / dt_m2:.1f} "
                f"subframes/s on {card} ({dt_m2:.2f} s wall; p3_mimo "
                f"{mspan2['s']:.4f} s over {mspan2['n']} decodes)")
            # before and after in turns: the parent's route (the plain
            # chain, the RE index uploaded per grant), then the kernel
            turns = {"kernel": [(dt_m2, mspan2["s"])], "parent": []}
            for route in ("parent", "kernel", "parent"):
                prof.reset()
                with parent_route(route == "parent"):
                    _, _, dt_r = run_loaded(device, m_words, m_scales, tmp,
                                            batch_size=MIMO_BATCH,
                                            cell=mimo_cell.CELL)
                sp = prof.report().get("p3_mimo", {"s": 0.0, "n": 0})
                turns[route].append((dt_r, sp["s"]))
                log(f"  warm pass, {route} route: "
                    f"{mimo_cell.N_SF / dt_r:.1f} subframes/s on {card} "
                    f"({dt_r:.2f} s wall; p3_mimo {sp['s']:.4f} s over "
                    f"{sp['n']} decodes, {1e3 * sp['s'] / max(1, sp['n']):.3f}"
                    " ms a decode)")
        with Phase("5b where the MIMO cell's time goes (profiled pass)"):
            chains["mimo"] = profile_pass(
                lambda: run_loaded(device, m_words, m_scales, tmp,
                                   batch_size=MIMO_BATCH,
                                   cell=mimo_cell.CELL)[2],
                PLAIN_CHAINS + DL_PLAIN_CHAINS)
        with Phase("6 uplink: UL golden, UL cell (20 MHz, 1024 subframes, "
                   "8 PUSCH/sf, batch 256), UCI grant"):
            reset_counts()
            run_ul_golden(device, tmp)
            vit["ul_golden"] = viterbi_count("UL golden scenario")
            prof.reset()
            reset_counts()
            cu, dci0, dt_u = run_ul(device, ul_dl, ul_ul, tmp)
            n_fused_u = turbo_decode.LAUNCHES["turbo_decode"]
            n_pass_u = bcjr.LAUNCHES["bcjr"]
            vit["ul"] = viterbi_count("UL cell")
            n_ok = sum(r.crc_ok for r in cu.ul_results)
            log(f"  UL cell: {len(dci0)} accepted DCI0s, "
                f"{len(cu.ul_results)} PUSCH results, {n_ok} CRC-ok "
                f"(placed {ul_placed}; record {rec_ul['crc_ok']} of "
                f"{rec_ul['n_results']})")
            log(f"  {ul_cell.N_SF / dt_u:.1f} subframes/s on {card} "
                f"({dt_u:.2f} s wall, first reading, not a target)")
            log(f"  launches in this run: turbo_decode (fused) {n_fused_u}, "
                f"bcjr (pass kernel) {n_pass_u}; PUSCH host reads "
                f"{host_reads('pu_d2h', 'pu_escalate')}")
            for line in prof.pretty().splitlines():
                log(f"  host span {line}")
            compare_ul(rec_ul, cu, dci0, ul_truth)
            if n_fused_u <= 0:
                raise AssertionError("the UL path launched no fused turbo "
                                     "kernel")
            if n_pass_u != 0:
                raise AssertionError(f"the UL path launched the pass kernel "
                                     f"{n_pass_u} times")
            prof.reset()
            _, _, dt_u2 = run_ul(device, ul_dl, ul_ul, tmp)
            search = prof.report().get("p2_search", {"s": 0.0, "n": 0})
            log(f"  warm second pass: {ul_cell.N_SF / dt_u2:.1f} "
                f"subframes/s on {card} ({dt_u2:.2f} s wall; p2_search "
                f"{search['s']:.4f} s)")
            reset_counts()
            run_uci(device)
            vit["uci"] = viterbi_count("UCI grant")
        with Phase("6b where the UL cell's time goes (profiled pass)"):
            chains["ul"] = profile_pass(
                lambda: run_ul(device, ul_dl, ul_ul, tmp)[2])
        with Phase("7a DL stream (20 MHz, 512 subframes, noise lead, 300 Hz "
                   "CFO, 2.5-subframe gap) through run_source"):
            rec_s = json.load(open(EXPECTED_DL_STREAM))
            cell = loaded_cell.CELL
            # the loaded cell as it is: acquisition fails in both packages
            x, _, _ = stream_cell.build_dl_stream(n_sf=13, pdsch_free_sf=())
            window = x[:12 * cell.sf_len]
            peak = sync.find_pss(window, cell.n_fft).peak
            try:
                core.LTESnifferCore(core.SnifferConfig(
                    cell=cell, device=device)).run_source(sdr.ArraySource(
                        window, cell.srate,
                        chunk_limit=stream_cell.dl_chunk_limit()))
                acq_err = None
            except RuntimeError as e:
                acq_err = str(e)
            log(f"  loaded cell as it is: find_pss peak {peak:.6f} (record "
                f"{rec_s['loaded_acquire']['find_pss_peak']:.6f}, threshold"
                f" 0.3); run_source: {acq_err!r}")
            if acq_err != rec_s["loaded_acquire"]["error"] or abs(
                    peak - rec_s["loaded_acquire"]["find_pss_peak"]) > 1e-6:
                raise AssertionError("the loaded cell's acquisition differs "
                                     "from the record")
            t0 = time.perf_counter()
            stream, s_placed, _ = stream_cell.build_dl_stream()
            log(f"  stream (subframes {stream_cell.PDSCH_FREE_SF} without "
                f"grants): {len(stream)} samples, {s_placed} placed TBs, "
                f"built in {time.perf_counter() - t0:.1f} s")
            if rec_s["params"] != stream_cell.dl_params() or \
                    rec_s["placed"] != s_placed:
                raise AssertionError("DL stream record does not match the "
                                     "scenario")
            # host costs of the tracker (numpy, on the card's host)
            det = None

            def search():
                nonlocal det
                det = sync.find_cell(stream[:12 * cell.sf_len], cell.n_fft)
            t_find = host_ms(search)
            tr = sync.SubframeTracker(cell, det.subframe_offset,
                                      5 if det.is_subframe5 else 0,
                                      cfo=det.cfo)
            n_framed = []
            t_frames = host_ms(lambda: n_framed.append(
                sum(1 for _ in tr.frames(stream))))
            tr2 = sync.SubframeTracker(cell, 0, 0)
            t_reacq = host_ms(lambda: tr2._reacquire(stream, 0))
            log(f"  host on {card}'s machine: find_cell over 12 subframes "
                f"{t_find:.1f} ms; one SubframeTracker.frames pass over the "
                f"whole stream {t_frames:.1f} ms ({n_framed[0]} subframes, "
                f"{tr.drift_corrections} drift corrections, {tr.resyncs} "
                f"re-acquires); one _reacquire (12-subframe np.correlate) "
                f"{t_reacq:.1f} ms")
            prof.reset()
            reset_counts()
            cs, acc_s, segs, dt_s = run_dl_stream(device, stream, tmp)
            n_fused_s = turbo_decode.LAUNCHES["turbo_decode"]
            n_pass_s = bcjr.LAUNCHES["bcjr"]
            vit["stream"] = viterbi_count("DL stream")
            got = stream_counts(cs)
            log(f"  summary: {got}, dcis {cs.summary()['dcis']}, pdsch_ok "
                f"{cs.summary()['pdsch_ok']}; record {rec_s['summary']}")
            log(f"  segments (subframes, first sf_idx): {segs}; record "
                f"{rec_s['segments']}")
            log(f"  launches in this run: turbo_decode (fused) {n_fused_s}, "
                f"bcjr (pass kernel) {n_pass_s}")
            for line in prof.pretty().splitlines():
                log(f"  host span {line}")
            compare_loaded(rec_s, cs, acc_s)
            want = {k: rec_s["summary"][k] for k in got}
            if got != want or segs != rec_s["segments"]:
                raise AssertionError(f"stream counts {got} / segments differ "
                                     f"from the record {want}")
            if got["resyncs"] < 1:
                raise AssertionError("the stream did not re-acquire")
            if n_fused_s <= 0:
                raise AssertionError("the stream path launched no fused "
                                     "turbo kernel")
            if n_pass_s != 0:
                raise AssertionError(f"the stream path launched the pass "
                                     f"kernel {n_pass_s} times")
            _, _, _, dt_s2 = run_dl_stream(device, stream, tmp)
            dt_f = framing_only_s(device, stream)
            _, _, dt_p = run_loaded(device, words, scales, tmp,
                                    batch_size=stream_cell.BATCH)
            n_sf = got["subframes"]
            log(f"  run_source on {card}: {n_sf / dt_s:.1f} sf/s first pass "
                f"({dt_s:.2f} s), {n_sf / dt_s2:.1f} sf/s warm "
                f"({dt_s2:.2f} s); run_packed on the aligned loaded cell at "
                f"batch {stream_cell.BATCH}, warm: "
                f"{loaded_cell.N_SF / dt_p:.1f} sf/s ({dt_p:.2f} s); "
                f"run_source's framing alone (segments dropped, not "
                f"decoded) {dt_f:.2f} s")
        with Phase("7b live mode (live_buffer_sf 20) on the 7a stream"):
            reset_counts()
            cl, _, _, dt_l = run_dl_stream(device, stream, tmp, live=True)
            vit["live"] = viterbi_count("live mode")
            sl = cl.summary()
            kept = sl["subframes"] / max(1, sl["subframes"] + sl["sf_skipped"])
            log(f"  live: {sl['subframes']} kept, {sl['sf_skipped']} "
                f"skipped in {dt_l:.2f} s; share of a 1000 sf/s air kept "
                f"{kept:.4f} on {card}")
            if sl["subframes"] + sl["sf_skipped"] != got["subframes"]:
                raise AssertionError("live mode lost subframes: kept + "
                                     "skipped != framed")
        with Phase("7c dual stream (UL cell, 20 MHz, 512 subframes, UL 37 "
                   "samples late) through run_dual_source"):
            rec_us = json.load(open(EXPECTED_UL_STREAM))
            t0 = time.perf_counter()
            us_dl, us_ul, us_placed, us_truth = stream_cell.build_ul_streams()
            log(f"  streams built in {time.perf_counter() - t0:.1f} s, "
                f"{us_placed} placed DCI0s")
            if rec_us["params"] != stream_cell.ul_params() or \
                    rec_us["placed"] != us_placed:
                raise AssertionError("UL stream record does not match the "
                                     "scenario")
            reset_counts()
            cus, dci0_s, dt_us = run_ul_stream(device, us_dl, us_ul, tmp)
            n_fused_us = turbo_decode.LAUNCHES["turbo_decode"]
            vit["ul_stream"] = viterbi_count("dual stream")
            log(f"  {len(dci0_s)} DCI0s, {len(cus.ul_results)} results, "
                f"{sum(r.crc_ok for r in cus.ul_results)} CRC-ok (record "
                f"{len(rec_us['dci0'])}, {rec_us['n_results']}, "
                f"{rec_us['crc_ok']}); {stream_cell.N_SF / dt_us:.1f} sf/s "
                f"({dt_us:.2f} s); fused launches {n_fused_us}")
            compare_ul(rec_us, cus, dci0_s, us_truth)
            if n_fused_us <= 0:
                raise AssertionError("the dual stream launched no fused "
                                     "turbo kernel")
        with Phase("7d ingest options on the golden scenario"):
            rec_i = json.load(open(EXPECTED_INGEST))["pcap_sha256"]
            reset_counts()
            shas = run_ingest(device, tmp)
            vit["ingest"] = viterbi_count("ingest options")
            for key, sha in shas.items():
                log(f"  {key}: sha256 {sha} "
                    f"({'equal' if sha == rec_i[key] else 'DIFFERS'})")
                if sha != rec_i[key]:
                    raise AssertionError(f"ingest {key}: pcap differs from "
                                         "the JAX package's")
        with Phase("7e the CLI (--sync) in a subprocess"):
            rec_c = json.load(open(EXPECTED_CLI))
            sha, stats, dt_c, cli_vit = run_cli(tmp)
            log(f"  the CLI's process: viterbi_tb launches {cli_vit[0]} "
                f"(plain entry) + {cli_vit[3]['viterbi_search']} (search "
                f"entry), plain Viterbi step loops on the card {cli_vit[1]}")
            if cli_vit[0] + cli_vit[3]["viterbi_search"] <= 0 or \
                    cli_vit[1] != 0:
                raise AssertionError("the CLI did not decode through the "
                                     "Viterbi kernel alone")
            vit["cli"] = cli_vit[0] + cli_vit[3]["viterbi_search"]
            VIT_LAUNCHES["CLI"] = cli_vit[0]
            tail_check("CLI", cli_vit[2],
                       {k: cli_vit[3][k] for k in TAIL_KERNELS}, cli_vit[4])
            log(f"  CLI pcap sha256 {sha} ({'equal' if sha == rec_c['pcap_sha256'] else 'DIFFERS'}); "
                f"{dt_c:.1f} s wall with its start-up; stats {stats}")
            if sha != rec_c["pcap_sha256"] or stats != rec_c["stats"]:
                raise AssertionError("the CLI's pcap or stats differ from the "
                                     "JAX CLI's")
        mh = scale_out(device, card, loaded_stream, placed, tmp)
        vit.update(mh["viterbi"])
        t2, t12, t8 = td[2], td[12], td[MIMO_N_ITER]
        line = {"kernels": [{
            "name": "turbo_decode", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/turbo_decode.cu",
            "replaces": TURBO_REPLACES, "launches": n_fused,
            "max_abs_err": err["turbo_decode"], "ms": t2["ms"],
            "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
            "bound_by": t2["bound_by"], "library_ms": None,
            "shape": {"K": K_main, "B": B_main, "n_iter": 2},
            "lanes_ms": t2["lanes_ms"],
            "n_iter_12": {k: t12[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "lanes_ms")},
            "mimo": {"launches": n_fused_m,
                     "shape": {"K": K_mimo, "B": B_mimo,
                               "n_iter": MIMO_N_ITER},
                     **{k: t8[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "lanes_ms")}},
            "ul": {"launches": n_fused_u,
                   "shape": {"K": K_ul, "B": B_ul, "n_iter": 2},
                   **{k: t_ul[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "lanes_ms")}},
            "pack": {"launches": DERM_LAUNCHES["loaded cell"][1],
                     **tdm["pack"]},
            "stream": {"launches": n_fused_s},
            "ul_stream": {"launches": n_fused_us},
            "multihost": {"launches": mh["fused"],
                          "runner_launches": mh["runner"]},
        }, {
            "name": "bcjr", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/bcjr.cu",
            "replaces": BCJR_REPLACES, "launches": n_pass,
            "max_abs_err": err["bcjr"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None,
            "launches_mimo": n_pass_m, "launches_ul": n_pass_u,
            "launches_stream": n_pass_s, "launches_multihost": mh["pass"]}, {
            "name": "viterbi_tb", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/viterbi_tb.cu",
            "replaces": VITERBI_REPLACES,
            "launches": VIT_LAUNCHES["loaded cell"],
            # the plain entry's main-path calls are the MIB's (12 x 40);
            # the search call's shape (the three-launch route) is a yardstick
            "max_abs_err": tv["err"],
            **{k: tv["mib"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "smem_per_block",
                "warps_per_sm")},
            "library_ms": None,
            "shape": {"groups": [(12, 40)], "wrap": 32},
            "registers": tv["registers"], "spill_bytes": tv["spill_bytes"],
            "max_d": tv["d_max"],
            "search_shape": {"shape": {"groups": tv["shapes"], "wrap": 32},
                             **{k: tv[k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by",
                                 "smem_per_block", "warps_per_sm")}},
            "launches_per_path": dict(VIT_LAUNCHES),
            "both_entries_per_path": vit}, {
            "name": "mimo_eq_demap", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/mimo_eq_demap.cu",
            "replaces": MIMO_EQ_REPLACES, "launches": n_eq_m,
            "max_abs_err": tq["err"], "ms": tq["ms"],
            "plain_ms": tq["plain_ms"], "bound_ms": tq["bound_ms"],
            "bound_by": tq["bound_by"], "library_ms": None,
            "shape": tq["shape"], "device_ms": tq["device_ms"],
            "ms_turns": tq["ms_turns"], "variants": tq["variants"],
            "real_grants": tq["real_grants"], "step": tq["step"],
            "two_codeword_decodes": mspan["n"],
            "mimo_turns": {r: [{"sf_per_s": mimo_cell.N_SF / dt,
                                "p3_mimo_s": sp} for dt, sp in v]
                           for r, v in turns.items()},
            "launches_per_path": dict(EQ_LAUNCHES),
            "launch_chains": chains}]}
        for key, src, src_line in (
                ("viterbi_search", "viterbi_tb.cu", SEARCH_REPLACES),
                ("pdcch_pack", "pdcch_tail.cu", PACK_REPLACES),
                ("pdcch_derm", "pdcch_tail.cu", DERM_REPLACES),
                ("pdcch_crc_pack", "pdcch_tail.cu", PACK_REPLACES)):
            line["kernels"].append({
                "name": key, "route": "cuda",
                "source": f"ltesniffer_tpu_torch/kernels/csrc/{src}",
                "replaces": src_line,
                "launches": TAIL_LAUNCHES["loaded cell"][key],
                **{f: tt[key][f] for f in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")},
                "library_ms": None, "shape": tt["tail"]["shape"],
                **{f: tt[key][f] for f in ("ms_turns", "bytes", "ops",
                                           "device_ms", "kernels_per_call")},
                "launches_per_path": {p_: v[key] for p_, v in
                                      TAIL_LAUNCHES.items()},
                "search_tails_per_path": {p_: v["calls"] for p_, v in
                                          TAIL_LAUNCHES.items()},
                **({"registers": tv["search_registers"],
                    "spill_bytes": tv["search_spill_bytes"],
                    "cases": tt[key]["cases"], "tail": tt["tail"],
                    "const_cache": const_passes}
                   if key == "viterbi_search" else {}),
                **({"cases": tt[key]["cases"]}
                   if key == "pdcch_derm" else {})})
        line["kernels"].append({
            "name": "tb_finish", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/tb_finish.cu",
            "replaces": TB_FINISH_REPLACES,
            "launches": TBF_LAUNCHES["loaded cell"], "max_abs_err": 0,
            "library_ms": None,
            **{k: tf[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                  "bound_ms", "bound_by", "bytes", "shape",
                                  "registers", "spill_bytes", "cases")},
            "launches_per_path": dict(TBF_LAUNCHES)})
        line["kernels"].append({
            "name": "pdsch_eq_demap", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/pdsch_eq_demap.cu",
            "replaces": PDSCH_EQ_REPLACES,
            "launches": PEQ_LAUNCHES["loaded cell"], "library_ms": None,
            **{k: te[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                  "bound_ms", "bound_by", "bytes", "shape",
                                  "registers", "spill_bytes", "cases",
                                  "max_abs_err", "max_rel_err",
                                  "floats_differ")},
            "launches_per_path": dict(PEQ_LAUNCHES),
            "chains": {k: {n: c for n, c in v.items()
                           if n.startswith(("pdsch_eq.", "pdsch_rx._eq_"))}
                       for k, v in chains.items()}})
        line["kernels"].append({
            "name": "cb_derm", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/cb_derm.cu",
            "replaces": CB_DERM_REPLACES,
            "launches": DERM_LAUNCHES["loaded cell"][0], "library_ms": None,
            "max_abs_err": max(c["max_abs_card"]
                               for c in tdm["cases"].values()),
            **{k: tdm[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                   "bound_ms", "bound_by", "bytes", "shape",
                                   "registers", "spill_bytes", "cases")},
            "launches_per_path": dict(DERM_LAUNCHES),
            "chains": {k: {n: c for n, c in v.items()
                           if n.endswith(("_derm_turbo_static_fn",
                                          "derm_plain", "_crc_pack"))}
                       for k, v in chains.items()}})
        log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_scale_out() -> int:
    """`chip_smoke.py --scale-out`: phase 1's build and phase 8 alone, for
    a machine with several cards (the no-argument run needs one)."""
    import torch
    if no_card():
        return 2
    sys.path.insert(0, REPO)
    from ltesniffer_tpu_torch import native
    from ltesniffer_tpu_torch.kernels import bcjr, cb_derm, pdcch_tail
    from ltesniffer_tpu_torch.kernels import pdsch_eq, turbo_decode, viterbi
    from ltesniffer_tpu_torch.testing import loaded_cell
    kind = torch.cuda.get_device_name(0)
    count_tail_calls()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("1 card and build"):
            card = card_line()
            log(card)
            log(f"  {torch.cuda.device_count()} cards")
            with concurrent.futures.ThreadPoolExecutor(6) as ex:
                for f in [ex.submit(m.build)
                          for m in (turbo_decode, bcjr, viterbi, pdcch_tail,
                                    pdsch_eq, cb_derm, native)]:
                    f.result()
        loaded_stream, placed, _ = loaded_cell.build_stream()
        mh = scale_out("cuda", card, loaded_stream, placed, tmp)
        log(json.dumps({"scale_out_launches": mh}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_scale_out() if sys.argv[1:] == ["--scale-out"] else main())
