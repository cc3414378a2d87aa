// The blind PDCCH search's candidate tail around the Viterbi, for Hopper.
//
// On the main path the Viterbi's search entry (viterbi_tb.cu) de-rate-
// matches as it stages its LLRs and writes each codeword's three words
// (two payload words and rnti | bit 0 << 16), and pdcch_pack packs those
// words into the fused host row: a search call's tail is 2 launches.
// pdcch_derm (every payload size's de-rate-matched LLRs into one buffer)
// and pdcch_crc_pack (the same row from the Viterbi's u8 bits) are the
// earlier three-launch route, kept as the fold's yardstick.
//
// Replaces the tail of the JAX package's jitted search program,
// ltesniffer_tpu/sniffer/pdcch_rx.py:71 _candidate_decode_tail (XLA inside
// :257 run_from_grids' jit, not a Pallas kernel): its de-rate-match part
// (:81-87) and its CRC / packing part (:89-149).  The port's plain version
// (kernels/pdcch_tail.py, derm_plain and crc_pack_plain) runs them as
// ~230 CUDA kernels and 30 host-to-device copies a search call.
//
// pdcch_derm, for S payload sizes D_s, B subframes and n_loc locations:
//   input   llr (B, n_bits) f32, the search head's descrambled LLRs;
//           loc (n_loc,) i32, 72 ncce << 2 | level of each location;
//           tab: per (size, level) a (3 D, reps) i16 table, row k the
//           e-offsets (0 <= e < E = 72 << level) whose rate-matched bit
//           is stream position k, in increasing e, -1 past the last
//   output  out: size s's (B n_loc, 3, D_s) f32 block at float offset
//           B n_loc 3 sum_{s' < s} D_s', blocks back to back
//   out[b, j, k] = the sum of llr[b, 72 ncce_j + e] over row k's e, taken
//   as a BLAS takes a product with the 0/1 matrix W[e, k]: from +0, one
//   add at a time in increasing e, within blocks of kblock e-offsets, each
//   block's partial sum added to the total in order.  kblock = 288 is the
//   order the plain version's einsum takes on the host (MKL's sgemm sums
//   K = 576 as two blocks of 288; K <= 288 in one), so the kernel equals
//   the plain version on the host bit for bit.  cuBLAS on the card picks
//   its order by shape; a reordering of at most 7 adds moves a sum by at
//   most 6 * 2^-24 * sum |terms|.  A position no e maps to (level 0, and
//   level 1 for D >= 55, puncture) comes out +0, as the product gives: a
//   sum from +0 is never -0.
//
// pdcch_crc_pack, per subframe b and candidate c = loc S + s (m = n_loc S):
//   input   bits[s] (B n_loc, D_s) u8, the Viterbi's decisions; cce
//           (B, nof_cce) f32; scal (B, 4) f32 or null; crc: word k holds
//           D^(k+16) mod g(D) of LTE's CRC16 (phy/crc.py's remainder
//           table, MSB first), k < kCrcLen
//   rnti(c) = crc16(payload) ^ the 16 received CRC bits MSB first, where
//   crc16 of the L = D - 16 payload bits is the XOR of crc[L - 1 - i] over
//   the set bits i (phy/crc.py's linear form)
//   output  fused (B, W) u32 words, sniffer/pdcch_rx.py unpack_fused's
//           layout: rnti(c) two a word (c even low), ceil(m / 32) words of
//           payload bit 0 (c in bit c % 32), the CCE powers as f16 pairs
//           (round to nearest even, as torch's .to(float16)), the scalars
//           as two f16-pair words when given, then c's two LSB-first
//           payload words; an odd m or nof_cce pads with 0.  Optional
//           (null = skip): rnti (B, m) i32, meta (B, m) i32 = rnti | bit 0
//           << 16, pay (B, m, 2) u32.
//   All integer work and one f32 -> f16 rounding: equal word for word.
//
// Bound on the card: bytes.  At one search call of the 20 MHz cell (B 64,
// n_loc 157, D = 31, 44, 46, 55, 64, 67) pdcch_derm writes 37.0 MB and
// reads 1.55 MB (~0.0115 ms at 3.35 TB/s) and pdcch_crc_pack reads 3.09
// MB of bits and writes 0.62 MB (~0.0011 ms).  What the design does: one
// launch each, one thread per output float (derm; its reads of a
// subframe's 576-float window hit L1) and one thread per fused word
// (pack: a word's RNTI pair, bitmap, f16 pair or payload word is computed
// where it is written, so no thread waits on another), no host-to-device
// copy (tables uploaded once per device, shapes in the parameter block).
//
// pdcch_pack, per subframe b and candidate c = loc S + s (m = n_loc S):
//   input   comp (S, B n_loc, 3) u32, the Viterbi search entry's words of
//           row b n_loc + loc: payload word 0, payload word 1, rnti | bit
//           0 << 16; cce, scal as pdcch_crc_pack's
//   output  fused (B, W) u32 and optional rnti / meta / pay, as
//           pdcch_crc_pack's, word for word
//   One thread per fused word, as pdcch_crc_pack, but every input it
//   reads is a 4-byte word: an RNTI pair two metas, a bitmap word 32 metas'
//   bit 16, a payload word one payload word.  Bound on the card: bytes
//   (12 m B read and 4 W B written: 1.37 MB at the 20 MHz search call,
//   ~0.0004 ms).
#include <climits>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSizes = 8;
constexpr int kLevels = 4;
constexpr int kCrcLen = 64;  // payload bits (D - 16) the CRC table covers

struct DermParams {
  const float* llr;
  const int* loc;
  const int16_t* tab;
  float* out;
  int out_off[kMaxSizes + 1];  // float offsets of each size's block
  int tab_off[kMaxSizes][kLevels];
  int d3[kMaxSizes];           // 3 D
  int n_sizes, n_loc, n_bits, reps, kblock;
};

__global__ void __launch_bounds__(kThreads)
    pdcch_derm_kernel(const DermParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.out_off[p.n_sizes]) return;
  int s = 0;
  while (i >= p.out_off[s + 1]) ++s;
  const int local = i - p.out_off[s];
  const int d3 = p.d3[s];
  const int row = local / d3;
  const int k = local - row * d3;
  const int b = row / p.n_loc;
  const int j = row - b * p.n_loc;
  const int lw = __ldg(p.loc + j);
  const int16_t* t = p.tab + p.tab_off[s][lw & 3] + k * p.reps;
  const float* x = p.llr + static_cast<long long>(b) * p.n_bits + (lw >> 2);
  float total = 0.0f, part = 0.0f;
  int blk = 0;
  for (int r = 0; r < p.reps; ++r) {
    const int e = __ldg(t + r);
    if (e < 0) break;
    const int eb = e / p.kblock;
    if (eb != blk) {
      total = total + part;
      part = 0.0f;
      blk = eb;
    }
    part = part + __ldg(x + e);
  }
  p.out[i] = total + part;
}

struct PackParams {
  const uint8_t* bits[kMaxSizes];
  const float* cce;
  const float* scal;
  const uint32_t* crc;
  uint32_t* fused;
  int* rnti;
  int* meta;
  uint32_t* pay;
  int d[kMaxSizes];
  int n_sizes, n_loc, nof_cce, m, mp2, mbw, ncw, sw, W;
};

__device__ __forceinline__ const uint8_t* cand_row(const PackParams& p,
                                                   int b, int c, int* d) {
  const int s = c % p.n_sizes;
  const int loc = c / p.n_sizes;
  *d = p.d[s];
  return p.bits[s] + (static_cast<long long>(b) * p.n_loc + loc) * *d;
}

__device__ __forceinline__ uint32_t rnti_of(const PackParams& p,
                                            const uint8_t* r, int d) {
  const int L = d - 16;
  uint32_t crc = 0;
  for (int i = 0; i < L; ++i)
    if (r[i]) crc ^= __ldg(p.crc + (L - 1 - i));
  uint32_t rx = 0;
  for (int i = 0; i < 16; ++i) rx = (rx << 1) | r[L + i];
  return (crc ^ rx) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t f16_bits(float x) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(x)));
}

__global__ void __launch_bounds__(kThreads)
    pdcch_crc_pack_kernel(const PackParams p) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  uint32_t word = 0;
  int d;
  if (w < p.mp2) {
    // two candidates' RNTIs (and, when asked, their meta words)
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * w + h;
      if (c >= p.m) break;
      const uint8_t* r = cand_row(p, b, c, &d);
      const uint32_t rn = rnti_of(p, r, d);
      word |= rn << (16 * h);
      const long long o = static_cast<long long>(b) * p.m + c;
      if (p.rnti) p.rnti[o] = static_cast<int>(rn);
      if (p.meta) p.meta[o] = static_cast<int>(rn | (uint32_t(r[0]) << 16));
    }
  } else if (w < p.mp2 + p.mbw) {
    const int c0 = 32 * (w - p.mp2);
    for (int t = 0; t < 32 && c0 + t < p.m; ++t)
      word |= uint32_t(cand_row(p, b, c0 + t, &d)[0]) << t;
  } else if (w < p.mp2 + p.mbw + p.ncw) {
    const int q = 2 * (w - p.mp2 - p.mbw);
    const float* x = p.cce + static_cast<long long>(b) * p.nof_cce;
    word = f16_bits(x[q]);
    if (q + 1 < p.nof_cce) word |= f16_bits(x[q + 1]) << 16;
  } else if (w < p.mp2 + p.mbw + p.ncw + p.sw) {
    const int q = 2 * (w - p.mp2 - p.mbw - p.ncw);
    const float* x = p.scal + 4LL * b;
    word = f16_bits(x[q]) | (f16_bits(x[q + 1]) << 16);
  } else {
    const int q = w - p.mp2 - p.mbw - p.ncw - p.sw;
    const uint8_t* r = cand_row(p, b, q >> 1, &d);
    const int i0 = 32 * (q & 1);
    const int L = d - 16;
    for (int t = 0; t < 32 && i0 + t < L; ++t)
      word |= uint32_t(r[i0 + t]) << t;
    if (p.pay) p.pay[static_cast<long long>(b) * 2 * p.m + q] = word;
  }
  p.fused[static_cast<long long>(b) * p.W + w] = word;
}

struct WordsParams {
  const uint32_t* comp;   // (n_sizes, N, 3)
  const float* cce;
  const float* scal;
  uint32_t* fused;
  int* rnti;
  int* meta;
  uint32_t* pay;
  long long N;            // B n_loc
  int n_sizes, n_loc, nof_cce, m, mp2, mbw, ncw, sw, W;
};

// the three words of candidate c of subframe b
__device__ __forceinline__ const uint32_t* cand_words(const WordsParams& p,
                                                      int b, int c) {
  const int s = c % p.n_sizes;
  const int loc = c / p.n_sizes;
  return p.comp + 3 * (s * p.N + static_cast<long long>(b) * p.n_loc + loc);
}

__global__ void __launch_bounds__(kThreads)
    pdcch_pack_kernel(const WordsParams p) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  uint32_t word = 0;
  if (w < p.mp2) {
    // two candidates' RNTIs (and, when asked, their meta words)
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * w + h;
      if (c >= p.m) break;
      const uint32_t mt = __ldg(cand_words(p, b, c) + 2);
      const uint32_t rn = mt & 0xFFFFu;
      word |= rn << (16 * h);
      const long long o = static_cast<long long>(b) * p.m + c;
      if (p.rnti) p.rnti[o] = static_cast<int>(rn);
      if (p.meta) p.meta[o] = static_cast<int>(mt);
    }
  } else if (w < p.mp2 + p.mbw) {
    const int c0 = 32 * (w - p.mp2);
    for (int t = 0; t < 32 && c0 + t < p.m; ++t)
      word |= ((__ldg(cand_words(p, b, c0 + t) + 2) >> 16) & 1u) << t;
  } else if (w < p.mp2 + p.mbw + p.ncw) {
    const int q = 2 * (w - p.mp2 - p.mbw);
    const float* x = p.cce + static_cast<long long>(b) * p.nof_cce;
    word = f16_bits(x[q]);
    if (q + 1 < p.nof_cce) word |= f16_bits(x[q + 1]) << 16;
  } else if (w < p.mp2 + p.mbw + p.ncw + p.sw) {
    const int q = 2 * (w - p.mp2 - p.mbw - p.ncw);
    const float* x = p.scal + 4LL * b;
    word = f16_bits(x[q]) | (f16_bits(x[q + 1]) << 16);
  } else {
    const int q = w - p.mp2 - p.mbw - p.ncw - p.sw;
    word = __ldg(cand_words(p, b, q >> 1) + (q & 1));
    if (p.pay) p.pay[static_cast<long long>(b) * 2 * p.m + q] = word;
  }
  p.fused[static_cast<long long>(b) * p.W + w] = word;
}

bool aligned(const void* ptr, uintptr_t a) {
  return ptr && !(reinterpret_cast<uintptr_t>(ptr) & (a - 1));
}

}  // namespace

extern "C" int pdcch_tail_max_sizes() { return kMaxSizes; }
extern "C" int pdcch_tail_crc_len() { return kCrcLen; }

// Plain C entry of pdcch_derm, loaded with ctypes.  llr: contiguous
// (B, n_bits) f32; loc: (n_loc,) i32; tab: the i16 tables, (s, level)'s
// at tab_off[s * 4 + level] (host array); out: B n_loc 3 sum(d) f32 (all
// device pointers, 4-aligned; tab 2-aligned); d: n_sizes host ints; reps:
// the tables' row length; kblock: the block of e-offsets summed apart;
// stream: a cudaStream_t.  Returns the cudaError_t of the launch (0 on
// success); shapes it does not take return cudaErrorInvalidValue and
// launch nothing.
extern "C" int pdcch_derm_launch(const void* llr, const void* loc,
                                 const void* tab, void* out,
                                 const int* tab_off, const int* d,
                                 int n_sizes, int B, int n_loc, int n_bits,
                                 int reps, int kblock, void* stream) {
  if (!aligned(llr, 4) || !aligned(loc, 4) || !aligned(tab, 2) ||
      !aligned(out, 4) || !tab_off || !d || n_sizes < 1 ||
      n_sizes > kMaxSizes || B < 1 || n_loc < 1 || n_bits < 1 ||
      reps < 1 || kblock < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DermParams p{};
  long long off = 0;
  for (int s = 0; s < n_sizes; ++s) {
    if (d[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.out_off[s] = static_cast<int>(off);
    p.d3[s] = 3 * d[s];
    for (int l = 0; l < kLevels; ++l) {
      if (tab_off[s * kLevels + l] < 0)
        return static_cast<int>(cudaErrorInvalidValue);
      p.tab_off[s][l] = tab_off[s * kLevels + l];
    }
    off += 3LL * d[s] * n_loc * B;
    if (off > INT_MAX - kThreads)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out_off[n_sizes] = static_cast<int>(off);
  p.llr = static_cast<const float*>(llr);
  p.loc = static_cast<const int*>(loc);
  p.tab = static_cast<const int16_t*>(tab);
  p.out = static_cast<float*>(out);
  p.n_sizes = n_sizes;
  p.n_loc = n_loc;
  p.n_bits = n_bits;
  p.reps = reps;
  p.kblock = kblock;
  const int blocks = static_cast<int>((off + kThreads - 1) / kThreads);
  pdcch_derm_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of pdcch_crc_pack, loaded with ctypes.  bits: n_sizes
// device pointers to contiguous (B n_loc, d[s]) u8; d: host ints with
// 17 <= d - 16 <= kCrcLen; cce: (B, nof_cce) f32; scal: (B, 4) f32 or
// null; crc: kCrcLen u32 words; fused: (B, W) u32, W the layout's width
// (refused unless it matches); rnti, meta: (B, n_loc n_sizes) i32 and pay:
// (B, n_loc n_sizes, 2) u32, each null to skip; stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success); shapes it does not
// take return cudaErrorInvalidValue and launch nothing.
extern "C" int pdcch_crc_pack_launch(const void* const* bits, const int* d,
                                     int n_sizes, const void* cce,
                                     const void* scal, const void* crc,
                                     void* fused, void* rnti, void* meta,
                                     void* pay, int B, int n_loc,
                                     int nof_cce, int W, void* stream) {
  if (!bits || !d || n_sizes < 1 || n_sizes > kMaxSizes ||
      !aligned(cce, 4) || (scal && !aligned(scal, 4)) || !aligned(crc, 4) ||
      !aligned(fused, 4) || (rnti && !aligned(rnti, 4)) ||
      (meta && !aligned(meta, 4)) || (pay && !aligned(pay, 4)) || B < 1 ||
      B > 65535 || n_loc < 1 || nof_cce < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PackParams p{};
  for (int s = 0; s < n_sizes; ++s) {
    if (!bits[s] || d[s] - 16 < 1 || d[s] - 16 > kCrcLen)
      return static_cast<int>(cudaErrorInvalidValue);
    p.bits[s] = static_cast<const uint8_t*>(bits[s]);
    p.d[s] = d[s];
  }
  const long long m = static_cast<long long>(n_loc) * n_sizes;
  if (m > (INT_MAX - kThreads) / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_sizes = n_sizes;
  p.n_loc = n_loc;
  p.nof_cce = nof_cce;
  p.m = static_cast<int>(m);
  p.mp2 = (p.m + 1) / 2;
  p.mbw = (p.m + 31) / 32;
  p.ncw = (nof_cce + 1) / 2;
  p.sw = scal ? 2 : 0;
  p.W = p.mp2 + p.mbw + p.ncw + p.sw + 2 * p.m;
  if (W != p.W) return static_cast<int>(cudaErrorInvalidValue);
  p.cce = static_cast<const float*>(cce);
  p.scal = static_cast<const float*>(scal);
  p.crc = static_cast<const uint32_t*>(crc);
  p.fused = static_cast<uint32_t*>(fused);
  p.rnti = static_cast<int*>(rnti);
  p.meta = static_cast<int*>(meta);
  p.pay = static_cast<uint32_t*>(pay);
  const dim3 grid((p.W + kThreads - 1) / kThreads, B);
  pdcch_crc_pack_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of pdcch_pack, loaded with ctypes.  comp: contiguous
// (n_sizes, B n_loc, 3) u32, the Viterbi search entry's words; cce: (B,
// nof_cce) f32; scal: (B, 4) f32 or null; fused: (B, W) u32, W the
// layout's width (refused unless it matches); rnti, meta: (B, n_loc
// n_sizes) i32 and pay: (B, n_loc n_sizes, 2) u32, each null to skip;
// stream: a cudaStream_t.  Returns the cudaError_t of the launch (0 on
// success); shapes it does not take return cudaErrorInvalidValue and
// launch nothing.
extern "C" int pdcch_pack_launch(const void* comp, int n_sizes,
                                 const void* cce, const void* scal,
                                 void* fused, void* rnti, void* meta,
                                 void* pay, int B, int n_loc, int nof_cce,
                                 int W, void* stream) {
  if (!aligned(comp, 4) || n_sizes < 1 || n_sizes > kMaxSizes ||
      !aligned(cce, 4) || (scal && !aligned(scal, 4)) ||
      !aligned(fused, 4) || (rnti && !aligned(rnti, 4)) ||
      (meta && !aligned(meta, 4)) || (pay && !aligned(pay, 4)) || B < 1 ||
      B > 65535 || n_loc < 1 || nof_cce < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(n_loc) * n_sizes;
  if (m > (INT_MAX - kThreads) / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  WordsParams p{};
  p.comp = static_cast<const uint32_t*>(comp);
  p.N = static_cast<long long>(B) * n_loc;
  p.n_sizes = n_sizes;
  p.n_loc = n_loc;
  p.nof_cce = nof_cce;
  p.m = static_cast<int>(m);
  p.mp2 = (p.m + 1) / 2;
  p.mbw = (p.m + 31) / 32;
  p.ncw = (nof_cce + 1) / 2;
  p.sw = scal ? 2 : 0;
  p.W = p.mp2 + p.mbw + p.ncw + p.sw + 2 * p.m;
  if (W != p.W) return static_cast<int>(cudaErrorInvalidValue);
  p.cce = static_cast<const float*>(cce);
  p.scal = static_cast<const float*>(scal);
  p.fused = static_cast<uint32_t*>(fused);
  p.rnti = static_cast<int*>(rnti);
  p.meta = static_cast<int*>(meta);
  p.pay = static_cast<uint32_t*>(pay);
  const dim3 grid((p.W + kThreads - 1) / kThreads, B);
  pdcch_pack_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
