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
// Design: one warp per codeword, kWarps warps a block, one launch for every
// group of a call (a by-value table of at most kMaxGroups groups).
// - Lane m holds the path metrics of states m and 32 + m; it reads those of
//   2m and 2m + 1 with four shuffles, forms its four branch metrics,
//   compares and selects, and the warp takes the maximum with five
//   xor-shuffles.  The two decision words of a step are the ballots of the
//   two halves' decisions: bit m of word b decides state 32b + m, the
//   packing of the plain version.
// - The codeword's 3D LLRs, its 2T decision words and its D output bytes
//   live in the warp's slot of shared memory (a few KB; the block stays
//   under 48 KB, so no shared-memory attribute is set).  The traceback runs
//   from shared memory in lane 0 and stops at the first kept step; the warp
//   writes the D bytes out together.
// - The circular extension is an index, not a copy, and each codeword runs
//   only its own T steps.  The plain version's fused scan pads shorter
//   codewords with zero LLRs at the front; through the pad every metric
//   stays +0 (0 + +-0 = +0, ties keep j = 0, the max subtracts to +0), so
//   the real steps start from the same all-zero metrics and the bits are
//   equal.
// - Float order, so that the bits equal the plain version's and not merely
//   come close: a branch metric is (s0 l0 + s1 l1) + s2 l2 with s_i = +-1
//   (a sign flip, exact), the k-order of the plain version's K = 3 matrix
//   product; then cand = pm + bm, the decision cand1 > cand0 (strict: ties
//   keep j = 0), the select and pm - max.  Built with --fmad=false, each a
//   single rounding.  The final state is the first state, in the order
//   n = 32b + m, whose metric is 0 after the last subtraction, which is the
//   first maximum as torch.argmax picks it (two different floats never
//   subtract to 0).
//
// Bound on the card: operations.  A codeword-step needs about 327 float32
// operations (4 distinct branch sums of 2 adds, 128 adds, 64 compares, 63
// for the maximum, 64 subtracts) against 12 bytes of LLRs read per column
// and one byte written per kept bit.  One search call of 64 subframes
// (6 sizes x 10048 codewords, T = 93..131) is 6.9 M codeword-steps: 34 us
// of float32 work against 12 us of memory traffic on an H100 SXM.  The
// design reads each LLR from device memory once and keeps the decisions
// on chip (the plain version writes and reads back an int64 word pair per
// codeword-step); what is left is the step's dependency chain through the
// shuffles, hidden by running many warps per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // codewords (warps) per block
constexpr int kMaxGroups = 8;      // payload sizes one launch takes
constexpr int kMaxSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Group {
  const float* llr;    // (n, 3, d) f32, contiguous
  uint8_t* bits;       // (n, d) u8, contiguous
  int n, d, w;
  int first;           // global warp index of the group's first codeword
};

struct Table {
  Group g[kMaxGroups];
  int count;           // groups in use
  int total;           // codewords of all groups
  int d_max;           // largest d: the slot's LLR and bit room
  int t_max;           // largest d + 2w: the slot's decision room
  int slot;            // bytes of shared memory per warp
};

// Sign-bit masks of the three encoder outputs for the 7-bit register
// (u_k << 6) | s, generator polynomials 133, 171, 165 (octal), as
// phy/conv.py forms them: output bit 1 means sign -1.
__device__ __forceinline__ uint3 sign_masks(int reg) {
  return make_uint3((__popc(reg & 0133) & 1u) << 31,
                    (__popc(reg & 0171) & 1u) << 31,
                    (__popc(reg & 0165) & 1u) << 31);
}

__device__ __forceinline__ float flip(float x, uint32_t m) {
  return __uint_as_float(__float_as_uint(x) ^ m);
}

// (s0 l0 + s1 l1) + s2 l2 for the signs m
__device__ __forceinline__ float branch(float l0, float l1, float l2,
                                       uint3 m) {
  return __fadd_rn(__fadd_rn(flip(l0, m.x), flip(l1, m.y)), flip(l2, m.z));
}

__global__ void __launch_bounds__(kWarps * 32)
viterbi_tb_kernel(const Table tab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + wib;
  if (gw >= tab.total) return;          // whole warps leave together

  // the group of this warp: the last one that starts at or before it
  const float* llr = nullptr;
  uint8_t* out = nullptr;
  int D = 0, w = 0, first = 0;
#pragma unroll
  for (int q = 0; q < kMaxGroups; ++q) {
    if (q < tab.count && gw >= tab.g[q].first) {
      llr = tab.g[q].llr;
      out = tab.g[q].bits;
      D = tab.g[q].d;
      w = tab.g[q].w;
      first = tab.g[q].first;
    }
  }
  const size_t cw = static_cast<size_t>(gw - first);

  unsigned char* slot = smem + static_cast<size_t>(wib) * tab.slot;
  float* sl = reinterpret_cast<float*>(slot);                  // 3 d_max
  uint32_t* sdec = reinterpret_cast<uint32_t*>(slot + 12 * tab.d_max);
  uint8_t* sbits = slot + 12 * tab.d_max + 8 * tab.t_max;      // d_max

  const float* src = llr + cw * 3 * D;
  for (int q = lane; q < 3 * D; q += 32) sl[q] = src[q];
  __syncwarp();

  // sign masks of the four branches this lane forms: new state 32b + m
  // from predecessor 2m + j under input b
  const uint3 m00 = sign_masks(2 * lane), m01 = sign_masks(2 * lane + 1);
  const uint3 m10 = sign_masks(64 | (2 * lane));
  const uint3 m11 = sign_masks(64 | (2 * lane + 1));
  const int src0 = (2 * lane) & 31;     // lane of states 2m (and 2m + 1)
  const bool upper = lane >= 16;        // 2m, 2m + 1 sit in the upper half

  const int T = D + 2 * w;
  float pm0 = 0.f, pm1 = 0.f;           // states m and 32 + m
  int c = (D - w) % D;                  // LLR column of step 0
  for (int s = 0; s < T; ++s) {
    const float l0 = sl[c], l1 = sl[D + c], l2 = sl[2 * D + c];
    if (++c == D) c = 0;
    const float a0 = __shfl_sync(kFull, pm0, src0);
    const float a1 = __shfl_sync(kFull, pm1, src0);
    const float b0 = __shfl_sync(kFull, pm0, src0 + 1);
    const float b1 = __shfl_sync(kFull, pm1, src0 + 1);
    const float p0 = upper ? a1 : a0;   // metric of state 2m
    const float p1 = upper ? b1 : b0;   // metric of state 2m + 1

    const float c00 = __fadd_rn(p0, branch(l0, l1, l2, m00));
    const float c01 = __fadd_rn(p1, branch(l0, l1, l2, m01));
    const float c10 = __fadd_rn(p0, branch(l0, l1, l2, m10));
    const float c11 = __fadd_rn(p1, branch(l0, l1, l2, m11));
    const bool d0 = c01 > c00;
    const bool d1 = c11 > c10;
    const float n0 = d0 ? c01 : c00;
    const float n1 = d1 ? c11 : c10;

    float mx = fmaxf(n0, n1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    pm0 = __fsub_rn(n0, mx);
    pm1 = __fsub_rn(n1, mx);

    const uint32_t w0 = __ballot_sync(kFull, d0);
    const uint32_t w1 = __ballot_sync(kFull, d1);
    if (lane == 0) {
      sdec[2 * s] = w0;
      sdec[2 * s + 1] = w1;
    }
  }

  // first state whose metric is the maximum (0 after the subtraction)
  const uint32_t z0 = __ballot_sync(kFull, pm0 == 0.f);
  const uint32_t z1 = __ballot_sync(kFull, pm1 == 0.f);
  if (lane == 0) {
    int st = z0 ? __ffs(z0) - 1 : 32 + __ffs(z1) - 1;
    for (int t = T - 1; t >= w; --t) {
      if (t < w + D) sbits[t - w] = static_cast<uint8_t>(st >> 5);
      const uint32_t word = sdec[2 * t + (st >> 5)];
      st = ((st & 31) << 1) | ((word >> (st & 31)) & 1);
    }
  }
  __syncwarp();
  uint8_t* dst = out + cw * D;
  for (int q = lane; q < D; q += 32) dst[q] = sbits[q];
}

}  // namespace

// Groups one launch takes; the wrapper checks its own limit against it.
extern "C" int viterbi_tb_max_groups() { return kMaxGroups; }

// Plain C entry point, loaded with ctypes.  For each of `count` groups:
// llr[g] a device pointer to a contiguous (n[g], 3, d[g]) f32 tensor,
// bits[g] one to a contiguous (n[g], d[g]) u8 tensor, w[g] its wrap
// (0 <= w <= d).  stream is a cudaStream_t.  Returns the cudaError_t of the
// launch (0 on success); what it does not take returns
// cudaErrorInvalidValue.
extern "C" int viterbi_tb_launch(const void* const* llr, void* const* bits,
                                 const int* n, const int* d, const int* w,
                                 int count, void* stream) {
  if (count < 1 || count > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  long long total = 0;
  for (int g = 0; g < count; ++g) {
    if (n[g] < 1 || d[g] < 1 || w[g] < 0 || w[g] > d[g] || !llr[g] ||
        !bits[g])
      return static_cast<int>(cudaErrorInvalidValue);
    tab.g[g] = Group{static_cast<const float*>(llr[g]),
                     static_cast<uint8_t*>(bits[g]), n[g], d[g], w[g],
                     static_cast<int>(total)};
    total += n[g];
    if (d[g] > tab.d_max) tab.d_max = d[g];
    if (d[g] + 2 * w[g] > tab.t_max) tab.t_max = d[g] + 2 * w[g];
  }
  if (total > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  tab.count = count;
  tab.total = static_cast<int>(total);
  tab.slot = (13 * tab.d_max + 8 * tab.t_max + 15) / 16 * 16;
  const int smem = kWarps * tab.slot;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kWarps - 1) / kWarps);
  viterbi_tb_kernel<<<blocks, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
