// Tail-biting Viterbi decode of the blind PDCCH search (and of PBCH's MIB)
// in one launch, for Hopper.
//
// Replaces the XLA scan of the JAX package, ltesniffer_tpu/kernels/
// viterbi.py:_acs_scan and :_traceback, reached through viterbi_decode_tb
// and viterbi_decode_tb_multi (a lax.scan, not a Pallas kernel).  Same
// function as the port's plain version (kernels/viterbi.py, the
// _extend / _acs_scan / _traceback step loop):
//
//   input   per group g: llr (N_g, 3, D_g) f32, stream-major, positive LLR
//           means bit 0; wrap w_g = min(wrap, D_g)
//   output  per group g: bits (N_g, D_g) u8, the decoded payloads
//
// The code is the 64-state, K = 7, rate-1/3 code of 36.212 5.1.3.1 with
// the butterfly state convention s' = (b << 5) | (s >> 1): the two
// predecessors of states m and 32 + m are 2m and 2m + 1.  Each codeword
// runs T = D + 2w steps over its LLR columns (s - w) mod D: w training
// steps from its tail, the D kept steps, w steps from its head.
//
// Bound on the card: operations.  A codeword-step needs about 327 float32
// operations (4 distinct branch sums of 2 adds, 128 adds, 64 compares, 63
// for the maximum, 64 subtracts) against 12 bytes of LLRs read per column
// and one byte written per kept bit.  One search call of 64 subframes
// (6 sizes x 10048 codewords, T = 93..131) is 6.9 M codeword-steps: 34 us
// at 67 TFLOP/s, 68 us at the 33.5 T/s that adds and compares alone can
// issue (67 TFLOP/s counts an FMA as two), against 12 us of memory traffic
// on an H100 SXM.
//
// Design: one codeword per thread, so that a step is the thread's own
// arithmetic and nothing else: no shuffle, ballot or warp reduction.
// - Warps belong to one group each: a group's codewords fill whole warps
//   from its first (the last warp of a group may be partial; its spare
//   lanes run on unused shared memory and write nothing), so the lanes of
//   a warp share D and T and never diverge.  One warp per block, the
//   simplest: blocks of 2 or 4 warps took the same time on an H100 at the
//   search call's and the MIB's shapes (kernels/viterbi_variants.py).  The
//   groups' warps are numbered longest T first, so that the last blocks to
//   start are the shortest: 2.7 % faster at the search call's shape than
//   the caller's order, by the same script.
// - The 64 path metrics live in registers.  The butterfly is unrolled: per
//   step a thread forms the four distinct branch sums (l0 +- l1) +- l2 (the
//   other four sign patterns are their negations, taken by subtracting
//   instead of adding), then 64 add-compare-selects, the maximum and 64
//   subtracts.
// - The maximum comes from the metrics entering the step, so that it
//   overlaps the add-compare-selects instead of following them as a
//   63-deep tree on the ALU pipe alone.  The two candidates out of a
//   predecessor are RN(pm + b) and RN(pm - b) for one branch sum b, the
//   larger is RN(pm + |b|), and rounding is monotone: the largest
//   candidate, which is the largest new metric, is the largest of
//   RN(Q_i + |base[i]|), Q_i the largest entering metric of the
//   butterflies on branch sum i.  The same float, by another route.
// - The select and the decision keep off the half-rate ALU pipe where they
//   can: the select is fmaxf(cand0, cand1), the decision the sign bit of
//   cand0 - cand1 (an add on the float pipe), shifted into its word by one
//   funnel shift.  Both equal the strict compare's outcome for finite
//   LLRs, because no candidate is ever -0 (see the float order below):
//   two equal candidates are the same float, and cand0 - cand1 is 0 only
//   when they are equal, and then +0 (sign 0: j = 0).
// - The decisions of a step, two u32 words a lane, are stored as a uint2
//   at [step][lane] in dynamic shared memory (a warp stores 256
//   contiguous bytes, free of bank conflicts), only for the D + w steps
//   the traceback reads (steps w .. T - 1).  Every lane then runs its own
//   traceback from shared memory, all 32 at once, into byte staging that
//   overlays the LLR rows, and the warp writes its codewords' D bytes each
//   in 4-byte words, coalesced (a warp's codewords are contiguous in
//   (N, D)).
// - LLRs are staged once, not read from device memory at every step.  At
//   a step a lane reads one float of each stream at its own codeword's
//   column: from device memory through L1 that is 3 loads of 32 scattered
//   lines a warp-step, and the lines of the warps an SM holds (~12 KB a
//   warp) do not fit in the L1 left beside their decisions, so each 4-byte
//   read would fetch a 32-byte sector from L2 (a variant that read them so
//   ran 8 warps an SM instead of 4 and was 17 % slower at the search
//   call's shape on an H100, by the same script).  Instead the warp
//   copies its codewords' contiguous (n, 3, D)
//   block with cp.async (4 bytes a lane, consecutive lanes on consecutive
//   addresses, no registers held) into rows [stream * D + column][lane] of
//   33 floats (the pad keeps the transposing stores free of bank
//   conflicts); a step then reads 32 consecutive floats a stream, the next
//   step's while the current one computes.
// - A slot (LLR rows + decisions) is 652 D + 8192 bytes at D >= 32 with
//   the default wrap: 51.9 KB at D = 67, so the search call runs 4 warps
//   an SM, one per scheduler, carried by the 64 independent add-compare-
//   selects of a step.  Above 48 KB the block needs the dynamic shared-
//   memory attribute, set once per device (it belongs to the device that
//   is current when it is set).
// - The circular extension is an index, not a copy, and each codeword runs
//   only its own T steps.  The plain version's fused scan pads shorter
//   codewords with zero LLRs at the front; through the pad every metric
//   stays +0 (0 + +-0 = +0, ties keep j = 0, the max subtracts to +0), so
//   the real steps start from the same all-zero metrics and the bits are
//   equal.
// - Float order, so that the bits equal the plain version's and not merely
//   come close: a branch metric is (s0 l0 + s1 l1) + s2 l2 with s_i = +-1,
//   the k-order of the plain version's K = 3 matrix product; negating all
//   three signs negates the sum exactly but for the sign of a zero, which
//   no later step sees: a metric is 0 or x - max, never -0 (x - x = +0),
//   and so neither is a candidate pm +- b (a sum is -0 only when both
//   terms are).  Then cand = pm + bm, the decision cand1 > cand0 (strict:
//   ties keep j = 0), the select and pm - max.  Built with --fmad=false,
//   each a single rounding.  The final state is the first state, in the
//   order n = 32b + m, whose metric is 0 after the last subtraction, which
//   is the first maximum as torch.argmax picks it (two different floats
//   never subtract to 0).
//
// The search entry (viterbi_search_launch) is the same body with the blind
// search's de-rate-match folded into the staging and its per-codeword
// words formed after the traceback.  With pdcch_tail.cu's pdcch_pack it
// replaces the tail of ltesniffer_tpu/sniffer/pdcch_rx.py:71
// _candidate_decode_tail (its de-rate-match :81-87, the CRC :89-149) and
// ends the round trip through pdcch_derm's 37 MB buffer:
//
//   input   llr (B, n_bits) f32, the search head's descrambled LLRs;
//           loc (n_loc,) i32, 72 ncce << 2 | level of each location; per
//           (group, level) a transposed de-rate-match table (reps, 3 D)
//           i16, row r the r-th e-offset of each stream position k, in
//           increasing e, -1 past the last; crc: word k is D^(k+16) mod
//           g(D) of LTE's CRC16, MSB first
//   output  per group g (payload size D, n = B n_loc codewords, row
//           b n_loc + j for subframe b and location j): comp (n, 3) u32,
//           the payload bits LSB-first in two words, then rnti | bit 0 <<
//           16 with rnti = crc16(payload) ^ the 16 received bits MSB
//           first; the (n, D) u8 bits only where a pointer is given
//
// - Staging, in the slot's decision region, which no step has written
//   yet: the warp copies its group's tables (each level's rows that hold
//   an e-offset, 16 bytes a copy) and, kGroup codewords at a time (fewer
//   where the region is short), each codeword's E = 72 << level window
//   of its subframe's LLR row (at most 2304 bytes) with cp.async into two
//   buffers: the next codewords' windows load while these sum.  A
//   codeword's subframe, location and level are its own (a warp may span
//   two subframes and several levels).  For the stream positions k = i +
//   32 c of the codewords, lane i reads at each repetition r consecutive
//   i16s of the shared tables, then the LLRs they name from the shared
//   windows, and sums them into row [k][q] (banks (k + q) mod 32: distinct
//   across the lanes; the window reads meet at most 3 to a bank at the
//   search's sizes).  Trial builds on an H100 chose this layout: reading
//   the windows through L1 left the entry slower than pdcch_derm and the
//   plain entry together (a warp's gather touches up to 18 lines of a
//   window, and 4 warps an SM cannot hide that); a branch per chunk of
//   positions, though every lane takes it alike, cost a convergence
//   barrier each, so every chunk is computed and predicated instead; of
//   1 to 8 codewords at a time, 3 was fastest.  A lane with no e-offset
//   at r reads a valid place and adds +0, which leaves a sum from +0 as
//   it was.
// - Float order, pdcch_derm's: from +0, one add at a time in increasing
//   e, within blocks of kKBlock e-offsets, each block's partial sum added
//   to the total in order.  A window spans at most two blocks, so the
//   staged float is p0 + p1 of the two blocks' sums from +0
//   (pdcch_derm's total is +0 + p0, which is p0, since no sum from +0 is
//   -0).  A position no e maps to is +0.  So every staged float equals
//   the one pdcch_derm writes, and none is -0.
// - The add-compare-select loop and the traceback are the plain entry's.
// - Epilogue: each lane reads its codeword's D bytes from its byte staging
//   and forms its three words (the CRC as the XOR of crc[L - 1 - i] over
//   the set payload bits i, L = D - 16); the warp stores them through the
//   decision region, which the traceback no longer reads, as 3 nv
//   consecutive words.
// Bound: operations, as the plain entry's (the de-rate-match adds 1.9e7
// float adds to 2.3e9 operations at the 20 MHz cell's search call), with
// 1.55 MB of LLRs read and 2.9 MB of words written instead of 40 MB.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 1;          // warps (32 codewords each) per block
constexpr int kMaxGroups = 8;      // payload sizes one launch takes
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90 (227 KB)
constexpr int kMaxDevices = 64;    // devices with a remembered attribute
constexpr int kRow = 33;           // floats per LLR row: 32 lanes + a pad
constexpr int kLevels = 4;         // aggregation levels of the search
constexpr int kKBlock = 288;       // e-offsets summed apart (pdcch_derm's)
constexpr int kGroup = 3;          // codewords the staging sums at once
constexpr int kWindow = 72 << 3;   // floats of the largest LLR window
constexpr int kChunks = 8;         // stream positions a lane stages: 3 D <= 256
constexpr int kCrcLen = 64;        // payload bits (D - 16) the CRC table covers
constexpr int kSearchWrap = 32;    // the search entry's wrap (the plain's)
// every window (E = 72 << level, level <= 3) spans at most two blocks
static_assert((72 << 3) <= 2 * kKBlock, "a window spans two blocks");
static_assert(3 * (16 + kCrcLen) <= 32 * kChunks, "a lane's positions");

struct Group {
  const float* llr;    // (n, 3, d) f32, contiguous
  uint8_t* bits;       // (n, d) u8, contiguous
  int n, d, w;
  int first;           // global index of the group's first warp
};

struct Table {
  Group g[kMaxGroups];
  int count;           // groups in use
  int warps;           // warps of all groups
  int llr_bytes;       // bytes of a slot's LLR rows (3 d_max rows)
  int slot;            // bytes of shared memory per warp
};

// The search entry's constants of a group, in the warps' order.
struct SearchGroup {
  const int16_t* tab[kLevels];  // (reps, 3 d) i16 table of each level
  int nrep[kLevels];            // its rows that hold an e-offset
  int grp;                      // codewords the staging takes at once
  uint32_t* comp;               // (n, 3) u32 words
};

struct Search {
  const float* llr;     // (B, n_bits) f32
  const int* loc;       // (n_loc,) i32: 72 ncce << 2 | level
  const uint32_t* crc;  // kCrcLen u32
  int n_bits, n_loc;
  SearchGroup g[kMaxGroups];
};

struct NoSearch {};     // the plain entry: LLRs staged as they are

// Bytes of a slot's LLR rows for payloads up to d_max, rounded to 16.
constexpr int llr_bytes(int d_max) {
  return (3 * d_max * kRow * 4 + 15) / 16 * 16;
}

// Bytes of shared memory per warp: the LLR rows, then one uint2 per lane
// for each of the k_max = max(d + w) steps whose decisions are kept.
constexpr int slot_bytes(int d_max, int k_max) {
  return llr_bytes(d_max) + 8 * 32 * k_max;
}

// The branch from predecessor p under input b, reg = (b << 6) | p,
// generator polynomials 133, 171, 165 (octal) as phy/conv.py forms them
// (output bit 1 means sign -1): its metric is base[branch_sum(reg)],
// negated if branch_negated(reg).  base[i] holds (l0 + s1 l1) + s2 l2 for
// s1 = i & 2 ? -1 : 1, s2 = i & 1 ? -1 : 1; a branch whose s0 is -1 is the
// negation of the base with s1, s2 flipped.  Every polynomial has taps at
// bits 0 and 6, so the four branches of butterfly m (p = 2m, 2m + 1 and
// b = 0, 1) share one branch sum, two of them negated.  reg is a constant
// once the butterfly is unrolled, so these fold.
__device__ __forceinline__ int branch_negated(int reg) {
  return __popc(reg & 0133) & 1;
}

__device__ __forceinline__ int branch_sum(int reg) {
  const int o0 = branch_negated(reg);
  return (((__popc(reg & 0171) & 1) ^ o0) << 1) |
         ((__popc(reg & 0165) & 1) ^ o0);
}

// cand = pm + bm, one add or subtract
__device__ __forceinline__ float cand(float pm, int reg,
                                      const float (&base)[4]) {
  const float b = base[branch_sum(reg)];
  return branch_negated(reg) ? __fsub_rn(pm, b) : __fadd_rn(pm, b);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes from a 16-byte aligned source to a 16-byte aligned destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One warp's codewords, the body of both entries: Mode is NoSearch for
// the plain entry, Search for the search entry.
template <class Mode>
__device__ __forceinline__ void decode_warp(const Table& tab,
                                            const Mode& mode) {
  constexpr bool kSearch = std::is_same<Mode, Search>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + wib;
  if (gw >= tab.warps) return;          // whole warps leave together

  // the group of this warp: the last one that starts at or before it
  const float* llr = nullptr;
  uint8_t* out = nullptr;
  int n = 0, D = 0, w = 0, first = 0;
#pragma unroll
  for (int q = 0; q < kMaxGroups; ++q) {
    if (q < tab.count && gw >= tab.g[q].first) {
      llr = tab.g[q].llr;
      out = tab.g[q].bits;
      n = tab.g[q].n;
      D = tab.g[q].d;
      w = tab.g[q].w;
      first = tab.g[q].first;
    }
  }
  // the search entry's constants of the group
  const int16_t *t0 = nullptr, *t1 = nullptr, *t2 = nullptr, *t3 = nullptr;
  int r0 = 0, r1 = 0, r2 = 0, r3 = 0, grp = 0;
  uint32_t* comp = nullptr;
  if constexpr (kSearch) {
#pragma unroll
    for (int q = 0; q < kMaxGroups; ++q) {
      if (q < tab.count && gw >= tab.g[q].first) {
        t0 = mode.g[q].tab[0];
        t1 = mode.g[q].tab[1];
        t2 = mode.g[q].tab[2];
        t3 = mode.g[q].tab[3];
        r0 = mode.g[q].nrep[0];
        r1 = mode.g[q].nrep[1];
        r2 = mode.g[q].nrep[2];
        r3 = mode.g[q].nrep[3];
        grp = mode.g[q].grp;
        comp = mode.g[q].comp;
      }
    }
  }
  const int cw0 = (gw - first) * 32;    // the warp's first codeword
  const int nv = min(32, n - cw0);      // its codewords (lanes in use)

  unsigned char* slot = smem + static_cast<size_t>(wib) * tab.slot;
  float* sl = reinterpret_cast<float*>(slot);
  uint2* sdec = reinterpret_cast<uint2*>(slot + tab.llr_bytes);

  if constexpr (kSearch) {
    const int d3 = 3 * D;
    // the group's tables (each level's rows that hold an e-offset, in
    // 16-byte pieces) into the decision region, which no step has
    // written yet, then two buffers of grp windows of kWindow floats
    int16_t* stab = reinterpret_cast<int16_t*>(sdec);
    const uint32_t stab_s =
        static_cast<uint32_t>(__cvta_generic_to_shared(stab));
    const int so1 = (r0 * d3 + 7) & ~7, so2 = so1 + ((r1 * d3 + 7) & ~7),
              so3 = so2 + ((r2 * d3 + 7) & ~7);
    const int n_tab = so3 + ((r3 * d3 + 7) & ~7);
    for (int i = 8 * lane; i < so1; i += 256)
      cp_async16(stab_s + 2u * i, t0 + i);
    for (int i = 8 * lane; i < so2 - so1; i += 256)
      cp_async16(stab_s + 2u * (so1 + i), t1 + i);
    for (int i = 8 * lane; i < so3 - so2; i += 256)
      cp_async16(stab_s + 2u * (so2 + i), t2 + i);
    for (int i = 8 * lane; i < n_tab - so3; i += 256)
      cp_async16(stab_s + 2u * (so3 + i), t3 + i);
    float* swin = reinterpret_cast<float*>(stab + n_tab);
    const uint32_t swin_s = stab_s + 2u * n_tab;
    // lane q's codeword (row cw0 + q: subframe b, location j): its
    // location word and the start of its LLR window
    const int row = cw0 + lane;
    const int bq = row / mode.n_loc;
    const int lwq = lane < nv ? __ldg(mode.loc + (row - bq * mode.n_loc))
                              : 0;
    const int xq = bq * mode.n_bits + (lwq >> 2);
    // copy the windows of codewords q0 .. q0 + grp - 1 into buffer h
    const auto fetch = [&](int q0, int h) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int lw = __shfl_sync(0xffffffffu, lwq, (q0 + g) & 31);
        const int xo = __shfl_sync(0xffffffffu, xq, (q0 + g) & 31);
        if (g >= grp || q0 + g >= nv) continue;
        const float* src = mode.llr + xo;
        const uint32_t dst =
            swin_s + 4u * static_cast<uint32_t>((h * grp + g) * kWindow);
        for (int i = 4 * lane; i < (72 << (lw & 3)); i += 128)
          cp_async16(dst + 4u * i, src + i);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    fetch(0, 0);
    int h = 0;
#pragma unroll 1
    for (int q0 = 0; q0 < nv; q0 += grp, h ^= 1) {
      // the next group's windows load while this group sums
      if (q0 + grp < nv) {
        fetch(q0 + grp, h ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      // offsets of each codeword's table and window: indices into
      // stab and swin, so that every read is a shared-memory load
      int tg[kGroup], wg[kGroup], nrg[kGroup];
      int nr = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int lvl = __shfl_sync(0xffffffffu, lwq, (q0 + g) & 31) & 3;
        nrg[g] = g >= grp || q0 + g >= nv ? 0
                 : lvl == 0 ? r0 : lvl == 1 ? r1 : lvl == 2 ? r2 : r3;
        tg[g] = lvl == 0 ? 0 : lvl == 1 ? so1 : lvl == 2 ? so2 : so3;
        wg[g] = (h * grp + min(g, grp - 1)) * kWindow;
        nr = max(nr, nrg[g]);
      }
      // every lane loads from a valid place and adds +0 where it has no
      // e-offset, which leaves a sum from +0 as it was (it is never -0):
      // no branch a lane could take apart from its neighbours; p0 sums
      // the e-offsets below kKBlock, p1 those from kKBlock on
      float p0[kGroup][kChunks], p1[kGroup][kChunks];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          p0[g][c] = 0.f;
          p1[g][c] = 0.f;
        }
#pragma unroll 1
      for (int r = 0; r < nr; ++r) {
        // every load of the repetition first, then the adds in order, each
        // predicated, not branched: a read past a table's rows or its
        // row's end lands in later tables or the windows, inside the
        // region, and is not used
        int e[kGroup][kChunks];
        float x[kGroup][kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            e[g][c] = stab[tg[g] + r * d3 + lane + 32 * c];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            e[g][c] = lane + 32 * c < d3 && r < nrg[g] ? e[g][c] : -1;
            x[g][c] = swin[wg[g] + max(e[g][c], 0)];
          }
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            p0[g][c] = __fadd_rn(p0[g][c], e[g][c] >= 0 && e[g][c] < kKBlock
                                               ? x[g][c] : 0.f);
            p1[g][c] = __fadd_rn(p1[g][c],
                                 e[g][c] >= kKBlock ? x[g][c] : 0.f);
          }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int k = lane + 32 * c;
          if (q0 + g < nv && g < grp && k < d3)
            sl[k * kRow + q0 + g] = __fadd_rn(p0[g][c], p1[g][c]);
        }
      __syncwarp();          // this buffer is the group after next's
    }
    // the decisions overwrite the tables and windows from the first step
  } else {
    // stage the warp's (nv, 3, D) block: element q = cw * 3D + r goes to
    // row r, column cw
    const float* src = llr + static_cast<size_t>(cw0) * 3 * D;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(sl));
    const int R = 3 * D;
    int cw = 0, r = lane;
    while (r >= R) { r -= R; ++cw; }
    for (int q = lane; cw < nv; q += 32) {
      cp_async4(dst + 4u * static_cast<uint32_t>(r * kRow + cw), src + q);
      r += 32;
      while (r >= R) { r -= R; ++cw; }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncwarp();

  const int T = D + 2 * w;
  float pm[64];
#pragma unroll
  for (int s = 0; s < 64; ++s) pm[s] = 0.f;
  const float* col = sl + lane;
  int c = (D - w) % D;                  // LLR column of step 0
  float l0 = col[c * kRow], l1 = col[(D + c) * kRow],
        l2 = col[(2 * D + c) * kRow];
#pragma unroll 1
  for (int s = 0; s < T; ++s) {
    if (++c == D) c = 0;
    // the next step's column (the last step's wraps to a valid one)
    const float x0 = col[c * kRow], x1 = col[(D + c) * kRow],
                x2 = col[(2 * D + c) * kRow];
    const float a = __fadd_rn(l0, l1), b = __fsub_rn(l0, l1);
    const float base[4] = {__fadd_rn(a, l2), __fsub_rn(a, l2),
                           __fadd_rn(b, l2), __fsub_rn(b, l2)};
    // the step's maximum, from the metrics entering it: per branch sum i,
    // the largest metric of the butterflies that use it plus |base[i]|
    const float ninf = __int_as_float(0xff800000);
    float q[4] = {ninf, ninf, ninf, ninf};
#pragma unroll
    for (int m = 0; m < 32; ++m)
      q[branch_sum(2 * m)] = fmaxf(q[branch_sum(2 * m)],
                                   fmaxf(pm[2 * m], pm[2 * m + 1]));
    const float mx =
        fmaxf(fmaxf(__fadd_rn(q[0], fabsf(base[0])),
                    __fadd_rn(q[1], fabsf(base[1]))),
              fmaxf(__fadd_rn(q[2], fabsf(base[2])),
                    __fadd_rn(q[3], fabsf(base[3]))));
    // decision bit m of word b is cand1 > cand0 of state 32b + m; the
    // words fill from the top, so m runs down
    float nw[64];
    uint32_t d0 = 0, d1 = 0;
#pragma unroll
    for (int m = 31; m >= 0; --m) {
      const float p0 = pm[2 * m], p1 = pm[2 * m + 1];
      const float c00 = cand(p0, 2 * m, base);
      const float c01 = cand(p1, 2 * m + 1, base);
      const float c10 = cand(p0, 64 | (2 * m), base);
      const float c11 = cand(p1, 64 | (2 * m + 1), base);
      nw[m] = fmaxf(c00, c01);
      nw[32 + m] = fmaxf(c10, c11);
      d0 = __funnelshift_l(__float_as_uint(__fsub_rn(c00, c01)), d0, 1);
      d1 = __funnelshift_l(__float_as_uint(__fsub_rn(c10, c11)), d1, 1);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) pm[i] = __fsub_rn(nw[i], mx);
    if (s >= w) sdec[(s - w) * 32 + lane] = make_uint2(d0, d1);
    l0 = x0;
    l1 = x1;
    l2 = x2;
  }

  // first state whose metric is the maximum (0 after the subtraction)
  int st = 0;
#pragma unroll
  for (int i = 63; i >= 0; --i)
    if (pm[i] == 0.f) st = i;

  // every lane's traceback; its bits go to bytes [lane * D, lane * D + D)
  // over the LLR rows, which no lane reads any more
  __syncwarp();
  uint8_t* sbits = slot;
#pragma unroll 4
  for (int t = T - 1; t >= w; --t) {
    if (t < w + D) sbits[lane * D + t - w] = static_cast<uint8_t>(st >> 5);
    const uint2 dd = sdec[(t - w) * 32 + lane];
    const uint32_t word = (st & 32) ? dd.y : dd.x;
    st = ((st & 31) << 1) | ((word >> (st & 31)) & 1);
  }
  __syncwarp();
  // the warp's nv * D bytes are contiguous in (n, D) and start 4-aligned
  // (the entry takes 4-aligned outputs, and cw0 * D is a multiple of 32);
  // the search entry writes them only where it is given bits
  if (!kSearch || out) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + static_cast<size_t>(cw0) * D);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sbits);
    const int bytes = nv * D;
    for (int i = lane; i < bytes >> 2; i += 32) dst[i] = sw[i];
    for (int i = (bytes & ~3) + lane; i < bytes; i += 32)
      reinterpret_cast<uint8_t*>(dst)[i] = sbits[i];
  }
  if constexpr (kSearch) {
    // the lane's codeword's words from its D bytes
    const uint8_t* mine = sbits + lane * D;
    const int L = D - 16;
    uint32_t p0 = 0, p1 = 0, crc = 0, rx = 0;
    for (int i = 0; i < L; ++i) {
      const uint32_t bit = mine[i];
      crc ^= (0u - bit) & __ldg(mode.crc + (L - 1 - i));
      if (i < 32)
        p0 |= bit << i;
      else
        p1 |= bit << (i - 32);
    }
    for (int i = 0; i < 16; ++i) rx = (rx << 1) | mine[L + i];
    const uint32_t meta = ((crc ^ rx) & 0xFFFFu) | (uint32_t(mine[0]) << 16);
    // through the decision region (read by no lane since the traceback),
    // stride 3 words a lane: free of bank conflicts
    uint32_t* sw3 = reinterpret_cast<uint32_t*>(sdec);
    sw3[3 * lane] = p0;
    sw3[3 * lane + 1] = p1;
    sw3[3 * lane + 2] = meta;
    __syncwarp();
    uint32_t* dst3 = comp + 3 * static_cast<size_t>(cw0);
    for (int i = lane; i < 3 * nv; i += 32) dst3[i] = sw3[i];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_tb_kernel(const Table tab) {
  decode_warp(tab, NoSearch{});
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_search_kernel(const Table tab, const Search srch) {
  decode_warp(tab, srch);
}

// Shared memory a block takes for groups of payload sizes d[] and wraps
// w[]; -1 if it is more than a block may have.
int block_smem(const int* d, const int* w, int count) {
  int d_max = 0, k_max = 0;
  for (int g = 0; g < count; ++g) {
    if (d[g] > kMaxSmem) return -1;     // keeps the sums below in int
    if (d[g] > d_max) d_max = d[g];
    if (d[g] + w[g] > k_max) k_max = d[g] + w[g];
  }
  const long long smem = static_cast<long long>(kWarps) *
                         slot_bytes(d_max, k_max);
  return smem > kMaxSmem ? -1 : static_cast<int>(smem);
}

// The shared-memory limit is an attribute of a kernel on the device that
// is current when it is set, so it is set once per kernel and device (the
// wrappers make the tensors' device current); devices past the table's
// end set it on every launch.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool> (&attr_set)[
                                          kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && attr_set[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && known) attr_set[dev].store(true);
  return e;
}

std::atomic<bool> tb_attr[kMaxDevices], search_attr[kMaxDevices];

bool bad_group(int n, int d, int w) {
  return n < 1 || d < 1 || w < 0 || w > d;
}

// The groups in the order of their warps: longest T = d + 2w first.
void order_groups(const int* d, const int* w, int count, int* order) {
  for (int g = 0; g < count; ++g) {
    int k = g;
    for (; k > 0 && d[order[k - 1]] + 2 * w[order[k - 1]] < d[g] + 2 * w[g];
         --k)
      order[k] = order[k - 1];
    order[k] = g;
  }
}

}  // namespace

// Groups one launch takes; the wrapper checks its own limit against it.
extern "C" int viterbi_tb_max_groups() { return kMaxGroups; }

// The largest payload size D a launch takes with wrap `wrap` (w = min(wrap,
// D)): the shared-memory limit of the slot layout.
extern "C" int viterbi_tb_max_d(int wrap) {
  int d = 0;
  for (;;) {
    const int next = d + 1;
    const int w = wrap < next ? wrap : next;
    if (wrap < 0 || block_smem(&next, &w, 1) < 0) return d;
    d = next;
  }
}

// Occupancy of a launch for groups of payload sizes d[] and wraps w[] on
// the current device: warps an SM holds at once and shared memory per
// block.  Returns a cudaError_t (cudaErrorInvalidValue where a launch
// would refuse the shapes).
extern "C" int viterbi_tb_occupancy(const int* d, const int* w, int count,
                                    int* warps_per_sm, int* smem_per_block) {
  if (count < 1 || count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g < count; ++g)
    if (bad_group(1, d[g], w[g]))
      return static_cast<int>(cudaErrorInvalidValue);
  const int smem = block_smem(d, w, count);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(viterbi_tb_kernel, tb_attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, viterbi_tb_kernel, kWarps * 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *warps_per_sm = blocks * kWarps;
  *smem_per_block = smem;
  return 0;
}

// Plain C entry point, loaded with ctypes.  For each of `count` groups:
// llr[g] a device pointer to a contiguous (n[g], 3, d[g]) f32 tensor,
// bits[g] one to a contiguous, 4-byte aligned (n[g], d[g]) u8 tensor, w[g]
// its wrap (0 <= w <= d).  stream is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); what it does not take (see
// viterbi_tb_max_d for the payload sizes) returns cudaErrorInvalidValue.
extern "C" int viterbi_tb_launch(const void* const* llr, void* const* bits,
                                 const int* n, const int* d, const int* w,
                                 int count, void* stream) {
  if (count < 1 || count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int g = 0; g < count; ++g)
    if (bad_group(n[g], d[g], w[g]) || !llr[g] || !bits[g] ||
        (reinterpret_cast<uintptr_t>(llr[g]) & 3) ||
        (reinterpret_cast<uintptr_t>(bits[g]) & 3))
      return static_cast<int>(cudaErrorInvalidValue);
  // the table in the order of the groups' warps: longest T = d + 2w first
  int order[kMaxGroups];
  order_groups(d, w, count, order);
  Table tab{};
  long long warps = 0;
  for (int q = 0; q < count; ++q) {
    const int g = order[q];
    tab.g[q] = Group{static_cast<const float*>(llr[g]),
                     static_cast<uint8_t*>(bits[g]), n[g], d[g], w[g],
                     static_cast<int>(warps)};
    warps += (n[g] + 31) / 32;
  }
  const int smem = block_smem(d, w, count);
  if (smem < 0 || warps > (1LL << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  int d_max = 0;
  for (int g = 0; g < count; ++g) d_max = d[g] > d_max ? d[g] : d_max;
  tab.count = count;
  tab.warps = static_cast<int>(warps);
  tab.llr_bytes = llr_bytes(d_max);
  tab.slot = smem / kWarps;
  const cudaError_t e = allow_smem(viterbi_tb_kernel, tb_attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  viterbi_tb_kernel<<<blocks, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

// The search entry's constants; the wrapper checks its own against them.
extern "C" int viterbi_search_kblock() { return kKBlock; }
extern "C" int viterbi_search_crc_len() { return kCrcLen; }

// Plain C entry of the search mode, loaded with ctypes.  llr: contiguous
// (B, n_bits) f32 whose rows hold every location's window (the wrapper
// checks the locations' reach); loc: (n_loc,) i32; tab: the transposed
// i16 tables, group g's level l at tab_off[g * 4 + l] (host array), nrep
// the rows of each that hold an e-offset (host, 0 <= nrep <= reps); crc:
// kCrcLen u32; comp: (count, B n_loc, 3) u32; bits: null, or a host array
// of count device pointers to contiguous, 4-aligned (B n_loc, d[g]) u8;
// d: host ints with 17 <= d <= 16 + kCrcLen (so 3 d <= 32 kChunks), each
// size's wrap min(kSearchWrap, d); stream: a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); what it does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int viterbi_search_launch(const void* llr, const void* loc,
                                     const void* tabs, const void* crc,
                                     void* comp, void* const* bits,
                                     const int* tab_off, const int* nrep,
                                     const int* d, int count, int B,
                                     int n_loc, int n_bits, int reps,
                                     void* stream) {
  const auto misaligned = [](const void* ptr, uintptr_t a) {
    return !ptr || (reinterpret_cast<uintptr_t>(ptr) & (a - 1));
  };
  if (count < 1 || count > kMaxGroups || B < 1 || n_loc < 1 ||
      n_bits < 1 || (n_bits & 3) || reps < 1 ||
      misaligned(llr, 16) ||
      misaligned(loc, 4) || misaligned(tabs, 16) || misaligned(crc, 4) ||
      misaligned(comp, 4) || !tab_off || !nrep || !d)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * n_loc;
  if (n > (1LL << 28) || static_cast<long long>(B) * n_bits > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int w[kMaxGroups];
  for (int g = 0; g < count; ++g) {
    if (d[g] - 16 < 1 || d[g] - 16 > kCrcLen ||
        (bits && misaligned(bits[g], 4)))
      return static_cast<int>(cudaErrorInvalidValue);
    w[g] = kSearchWrap < d[g] ? kSearchWrap : d[g];
    for (int l = 0; l < kLevels; ++l)
      if (tab_off[g * kLevels + l] < 0 || (tab_off[g * kLevels + l] & 7) ||
          nrep[g * kLevels + l] < 0 || nrep[g * kLevels + l] > reps)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  int order[kMaxGroups];
  order_groups(d, w, count, order);
  Table tab{};
  Search srch{};
  long long warps = 0;
  for (int q = 0; q < count; ++q) {
    const int g = order[q];
    tab.g[q] = Group{nullptr,
                     bits ? static_cast<uint8_t*>(bits[g]) : nullptr,
                     static_cast<int>(n), d[g], w[g],
                     static_cast<int>(warps)};
    for (int l = 0; l < kLevels; ++l) {
      srch.g[q].tab[l] = static_cast<const int16_t*>(tabs) +
                         tab_off[g * kLevels + l];
      srch.g[q].nrep[l] = nrep[g * kLevels + l];
    }
    srch.g[q].comp = static_cast<uint32_t*>(comp) + 3 * n * g;
    warps += (n + 31) / 32;
  }
  const int smem = block_smem(d, w, count);
  if (smem < 0 || warps > (1LL << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  int d_max = 0;
  for (int g = 0; g < count; ++g) d_max = d[g] > d_max ? d[g] : d_max;
  tab.count = count;
  tab.warps = static_cast<int>(warps);
  tab.llr_bytes = llr_bytes(d_max);
  tab.slot = smem / kWarps;
  // the staging keeps a group's table rows and two buffers of windows in
  // the slot's decision region: as many codewords at once as fit
  for (int q = 0; q < count; ++q) {
    const int g = order[q];
    int rows = 0;
    for (int l = 0; l < kLevels; ++l)
      rows += (3 * d[g] * nrep[g * kLevels + l] + 7) & ~7;
    const int room = tab.slot - tab.llr_bytes - 2 * rows;
    const int grp = room / (2 * 4 * kWindow);
    if (grp < 1) return static_cast<int>(cudaErrorInvalidValue);
    srch.g[q].grp = grp < kGroup ? grp : kGroup;
  }
  srch.llr = static_cast<const float*>(llr);
  srch.loc = static_cast<const int*>(loc);
  srch.crc = static_cast<const uint32_t*>(crc);
  srch.n_bits = n_bits;
  srch.n_loc = n_loc;
  const cudaError_t e = allow_smem(viterbi_search_kernel, search_attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  viterbi_search_kernel<<<blocks, kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(tab, srch);
  return static_cast<int>(cudaGetLastError());
}
