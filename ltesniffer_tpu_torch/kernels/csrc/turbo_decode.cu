// Whole max-log-MAP turbo decode of the LTE turbo code in one launch, for
// Hopper.
//
// Replaces the TPU kernel ltesniffer_tpu/kernels/turbo_pallas.py:make_bcjr
// together with the decoder that calls it twice per iteration,
// ltesniffer_tpu/kernels/turbo.py:_make_decoder_pallas.  Same function as
// that decoder (and as the port's lane decoder kernels/turbo.py:
// make_decoder_lanes, its plain version here):
//
//   input   d_llrs (B, 3, K+4) f32: systematic, parity 1, parity 2, each
//           with its termination tail in the last 4 columns
//   outputs llr (B, K) f32, the a-posteriori LLR of decoder 2
//           de-interleaved to natural order; bits (B, K) u8 = llr < 0
//
// n_iter iterations of two constituent decoders, each a windowed BCJR over
// NW = K/W windows of W steps, whose boundary metrics (alpha at a window's
// end, beta at its start) seed the neighbouring windows in the next
// iteration; the last window's beta comes from the termination tail.
//
// Design: one CTA per G code blocks, one thread per (code block, window).
// - The code block lives in dynamic shared memory for the whole decode:
//   systematic, parity 1, parity 2 and ONE extrinsic buffer, all in natural
//   order, loaded once with coalesced reads.  Decoder 1 reads and writes
//   position j of its window; decoder 2 reads and writes position pi(i) for
//   interleaved position i of its window.  pi is a bijection, so each
//   position is read and rewritten by exactly one thread per half-iteration
//   and the extrinsic is exchanged in place, with no inverse table.
// - pi is walked on the fly in 32-bit integers with the QPP recurrence
//   (struct Qpp), up and down the window; no index table, no int64 gather.
// - A buffer position p sits at p + p / W (one pad float per window), so
//   the 32 threads of a warp, each at step k of its own window, hit 32
//   different banks in the natural-order sweeps, and the parity loads take
//   constant offsets from the window's base.
// - Window-boundary metrics stay in shared memory between iterations.
//   Each half-iteration every thread first reads its neighbours' metrics,
//   then a __syncthreads(), then the pass, which stores the thread's own
//   a_end as soon as its forward sweep ends and b_start at the end.
// - The alpha window does not fit in registers (32 steps x 8 states spill
//   in the per-pass kernel bcjr.cu).  The forward sweep keeps a checkpoint
//   every S = 8 steps and the alphas of the last S steps; the backward
//   sweep recomputes each earlier segment's alphas from its checkpoint.
//   The recomputation does the same adds in the same order, so it changes
//   no bit; it costs W - S extra forward steps per pass (24 at W = 32).
//   Registers are capped at 168 a thread (kMinBlocks), so that the main
//   path's 729 code blocks of K = 1824 run in one wave of CTAs.
// - Code size: the SMs' instruction caches hold a few thousand
//   instructions, and a warp that misses them waits on every step.  Both
//   decoders run one copy of the pass (decoder 1 walks the identity where
//   decoder 2 walks the QPP), and the loops over segments stay rolled with
//   each segment's S steps unrolled, which keeps the kernel several times
//   smaller than a fully unrolled one (chip_smoke.py prints its SASS
//   instruction count).
// - The recurrence itself is bcjr_step.cuh, shared with bcjr.cu; built with
//   --fmad=false, the decided bits and LLRs equal the plain version's.
//
// Bound on the card: operations.  A decode does about 107 float32
// operations per trellis step and constituent pass, 2 * n_iter * K * B
// steps, against 3 * (K+4) * B * 4 bytes read and 5 * K * B bytes written
// once.  At K = 1824, B = 729, n_iter = 12 that is 51 us of float32 work
// and 6.8 us of memory traffic on an H100 SXM.  The design keeps every
// intermediate in shared memory and registers, so the memory side stays at
// one read and one write; what is left is the recurrence's dependency chain
// over W steps per thread and K/W threads per code block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bcjr_step.cuh"

namespace {

// Launch bound: at most 192 threads a CTA (K = 6144; packed small blocks
// stay under 128), and room for kMinBlocks such CTAs per SM, which caps a
// thread at 168 registers (the main path's grid then fits in one wave).
constexpr int kMaxThreads = 192;
constexpr int kMinBlocks = 2;
// Checkpoint spacing S of the alpha window (S = W when W < kSeg): 8 steps
// of alphas in registers; 16 spills under the cap and ran slower.
constexpr int kSeg = 8;
constexpr int kMaxSmem = 232448;        // a block's dynamic shared memory
constexpr int kMaxDevices = 64;         // devices with a per-device flag

// QPP interleaver pi(i) = (f1 i + f2 i^2) mod K, walked with its first
// difference g(i) = pi(i+1) - pi(i) mod K, whose own difference is 2 f2.
// Every intermediate stays below 2^31 for K <= 6144.
struct Qpp {
  int K, f1, f2, d2;                    // d2 = 2 f2 mod K

  __device__ __forceinline__ void at(int i, int& p, int& g) const {
    p = ((f1 + (f2 * i) % K) * i) % K;
    g = (f1 + (f2 * (2 * i + 1)) % K) % K;
  }
  __device__ __forceinline__ void up(int& p, int& g) const {    // i -> i+1
    p += g;
    if (p >= K) p -= K;
    g += d2;
    if (g >= K) g -= K;
  }
  __device__ __forceinline__ void down(int& p, int& g) const {  // i -> i-1
    g -= d2;
    if (g < 0) g += K;
    p -= g;
    if (p < 0) p += K;
  }
};

// Shared-memory slot of trellis position p: one pad float after every
// W-window, so that the 32 threads of a warp, each at step k of its own
// window, hit 32 different banks, and window w's step k sits at the
// constant offset k from w * (W + 1).
template <int W>
__device__ __forceinline__ int pad(int p) {
  return p + static_cast<int>(static_cast<unsigned>(p) / W);
}

// One constituent decoder over window w of one code block.  q walks the
// window's positions in the order the decoder reads them: the QPP
// interleaver for decoder 2, the identity (f1 = 1, f2 = 0) for decoder 1,
// so both decoders run one copy of the code.  alpha holds alpha_0 on entry
// and beta holds beta_W (see the caller); the pass stores a_end as soon as
// its forward sweep ends and b_start at the end.  The extrinsic, or on the
// last half-iteration the full LLR, overwrites the a-priori input in ext.
// The segment loops stay rolled (each segment's S steps unrolled) to keep
// the code small enough for the instruction cache.
template <int W>
__device__ __forceinline__ void half_pass(float* __restrict__ ext,
                                          const float* __restrict__ sys,
                                          const float* __restrict__ par,
                                          int w, const Qpp& q, bool last,
                                          float alpha[8], float beta[8],
                                          float* __restrict__ a_end,
                                          float* __restrict__ b_start,
                                          int NW) {
  constexpr int S = W < kSeg ? W : kSeg;
  constexpr int NS = W / S;
  const int i0 = w * W;
  const int base = w * (W + 1);         // pad(i0): the window's par slots
  float ck[NS][8];                      // alpha at each segment's start
  float ab[S][8];                       // alphas of the segment in hand
  int p, g;
  q.at(i0, p, g);
  // forward sweep over segments 0..NS-2, checkpointing each start
#pragma unroll 1
  for (int seg = 0; seg < NS - 1; ++seg) {
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
      if (seg == j) {
#pragma unroll
        for (int s = 0; s < 8; ++s) ck[j][s] = alpha[s];
      }
    }
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int o = pad<W>(p);
      bcjr_alpha_step(alpha, ext[o], sys[o], par[base + seg * S + t]);
      q.up(p, g);
    }
  }
  // backward sweep, last segment first: each segment's alphas are (re)made
  // from its start (the forward sweep's alpha for the last segment, a
  // checkpoint for the others), then its beta steps run
#pragma unroll 1
  for (int seg = NS - 1; seg >= 0; --seg) {
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) {
      if (seg == j) {
#pragma unroll
        for (int s = 0; s < 8; ++s) alpha[s] = ck[j][s];
      }
    }
    q.at(i0 + seg * S, p, g);
#pragma unroll
    for (int t = 0; t < S; ++t) {
#pragma unroll
      for (int s = 0; s < 8; ++s) ab[t][s] = alpha[s];
      const int o = pad<W>(p);
      bcjr_alpha_step(alpha, ext[o], sys[o], par[base + seg * S + t]);
      q.up(p, g);
    }
    if (seg == NS - 1) {
#pragma unroll
      for (int s = 0; s < 8; ++s) a_end[s * NW] = alpha[s];
    }
#pragma unroll
    for (int t = S - 1; t >= 0; --t) {
      q.down(p, g);
      const int o = pad<W>(p);
      const float apr = ext[o];
      const float sy = sys[o];
      const float e =
          bcjr_beta_step(beta, ab[t], apr, sy, par[base + seg * S + t]);
      ext[o] = last ? (e + apr) + sy : e;
    }
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) b_start[s * NW] = beta[s];
}

// Shared memory of one code block, in floats: sys, par1, par2, ext (K + NW
// each, padded), boundary metrics (4 x 8 states x NW windows: a_end and b_start
// of decoder 1, then of decoder 2), the 3 x 4 tail LLRs, beta_K of both
// decoders (16), padded to a multiple of 4.
__host__ __device__ __forceinline__ int block_floats(int K, int NW) {
  return 4 * (K + NW) + 32 * NW + 32;
}

template <int W>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
turbo_decode_kernel(const float* __restrict__ d_llrs,
                    float* __restrict__ llr_out,
                    uint8_t* __restrict__ bits_out, int B, int K, int n_iter,
                    int G, Qpp q) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NW = K / W;
  const int SB = block_floats(K, NW);
  const int Kp = K + 4;
  const int b0 = blockIdx.x * G;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  // stage the code blocks: coalesced reads of d_llrs, padded stores; the
  // extrinsic (decoder 1's first a-priori) and the boundary metrics start
  // at zero, as the lane decoder's do
  const int KP = K + NW;
  for (int gi = 0; gi < G; ++gi) {
    float* blk = smem + gi * SB;
    const bool present = b0 + gi < B;
    const float* src = d_llrs + static_cast<size_t>(b0 + gi) * 3 * Kp;
    for (int r = 0; r < 3; ++r) {
      for (int p = tid; p < Kp; p += nthr) {
        const float v = present ? src[r * Kp + p] : 0.f;
        if (p < K)
          blk[r * KP + pad<W>(p)] = v;
        else
          blk[4 * KP + 32 * NW + 4 * r + (p - K)] = v;
      }
    }
    for (int p = tid; p < KP; p += nthr) blk[3 * KP + p] = 0.f;
    for (int e = tid; e < 32 * NW; e += nthr) blk[4 * KP + e] = 0.f;
  }
  __syncthreads();

  const int gi = tid / NW;
  const int w = tid - gi * NW;
  const Qpp q_nat{K, 1, 0, 0};          // decoder 1 walks natural order
  const bool active = b0 + gi < B;
  float* blk = smem + gi * SB;
  float* ext = blk + 3 * KP;
  float* bnd = blk + 4 * KP;
  const float* tail = bnd + 32 * NW;
  float* bk = bnd + 32 * NW + 12;

  // tail-terminated beta_K of both decoders, in the order of
  // kernels/turbo.py:_tails and _beta_init_from_tail; only the last
  // window's thread reads it
  if (active && w == NW - 1) {
#pragma unroll
    for (int dec = 0; dec < 2; ++dec) {
      const int c = 2 * dec;
      const float ts[3] = {tail[c], tail[8 + c], tail[4 + c + 1]};
      const float tp[3] = {tail[4 + c], tail[c + 1], tail[8 + c + 1]};
      float beta[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) beta[s] = (s == 0) ? 0.f : BCJR_NEG;
#pragma unroll
      for (int k = 2; k >= 0; --k) bcjr_tail_step(beta, ts[k], tp[k]);
#pragma unroll
      for (int s = 0; s < 8; ++s) bk[8 * dec + s] = beta[s];
    }
  }

  // Per half-iteration: every thread reads its window's boundary inputs
  // (the neighbours' a_end and b_start of this decoder's last pass, as
  // kernels/turbo.py:shift_a / shift_b form them), a barrier, then the
  // pass, which overwrites those metrics with its own.
  for (int h = 0; h < 2 * n_iter; ++h) {
    const int d = h & 1;
    float* a_arr = bnd + 16 * d * NW;   // a_end of decoder d, (8, NW)
    float* b_arr = a_arr + 8 * NW;      // b_start of decoder d, (8, NW)
    float alpha[8], beta[8];
    __syncthreads();
    if (active) {
      const int sa = w > 0 ? w - 1 : w;
      const float ma = w > 0 ? 1.f : 0.f;
      const bool lastw = (w == NW - 1);
      const int sb = lastw ? w : w + 1;
      const float mb = lastw ? 0.f : 1.f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        alpha[s] = a_arr[s * NW + sa] * ma +
                   ((w == 0 && s > 0) ? BCJR_NEG : 0.f);
        beta[s] = b_arr[s * NW + sb] * mb + (lastw ? bk[8 * d + s] : 0.f);
      }
    }
    __syncthreads();
    if (active) {
      const bool last = (h == 2 * n_iter - 1);
      half_pass<W>(ext, blk, blk + (1 + d) * KP, w, d ? q : q_nat, last,
                   alpha, beta, a_arr + w, b_arr + w, NW);
    }
  }
  __syncthreads();

  for (int g2 = 0; g2 < G; ++g2) {
    if (b0 + g2 >= B) break;
    const float* e = smem + g2 * SB + 3 * KP;
    const size_t o = static_cast<size_t>(b0 + g2) * K;
    for (int p = tid; p < K; p += nthr) {
      const float v = e[pad<W>(p)];
      llr_out[o + p] = v;
      bits_out[o + p] = v < 0.f ? 1 : 0;
    }
  }
}

template <int W>
cudaError_t launch(const float* d, float* llr, uint8_t* bits, int B, int K,
                   int n_iter, int G, const Qpp& q, cudaStream_t stream) {
  // The shared-memory limit is an attribute of the kernel on the device
  // that is current when it is set, so it is set once per device (the
  // wrapper makes the tensors' device current); devices past the table's
  // end set it on every launch.
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (!known || !attr_set[dev].load()) {
    e = cudaFuncSetAttribute(turbo_decode_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    if (known) attr_set[dev].store(true);
  }
  const int NW = K / W;
  const int threads = G * NW;
  const size_t smem =
      static_cast<size_t>(G) * block_floats(K, NW) * sizeof(float);
  if (threads > kMaxThreads || smem > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const int blocks = (B + G - 1) / G;
  turbo_decode_kernel<W><<<blocks, threads, smem, stream>>>(
      d, llr, bits, B, K, n_iter, G, q);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  d_llrs, llr and bits are device
// pointers of contiguous tensors ((B, 3, K+4) f32, (B, K) f32, (B, K) u8);
// (f1, f2) are K's QPP coefficients; W is the window, G the code blocks per
// CTA; stream is a cudaStream_t.  Returns the cudaError_t of the launch
// (0 on success); a shape it does not take returns cudaErrorInvalidValue.
extern "C" int turbo_decode_launch(const void* d_llrs, void* llr, void* bits,
                                   int B, int K, int n_iter, int f1, int f2,
                                   int W, int G, void* stream) {
  if (B <= 0 || n_iter <= 0 || G <= 0 || K < 40 || K > 6144 || K % W != 0 ||
      f1 <= 0 || f1 >= K || f2 <= 0 || f2 >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Qpp q{K, f1, f2, (2 * f2) % K};
  const float* pd = static_cast<const float*>(d_llrs);
  float* pl = static_cast<float*>(llr);
  uint8_t* pb = static_cast<uint8_t*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8:
      return static_cast<int>(launch<8>(pd, pl, pb, B, K, n_iter, G, q, s));
    case 16:
      return static_cast<int>(launch<16>(pd, pl, pb, B, K, n_iter, G, q, s));
    case 32:
      return static_cast<int>(launch<32>(pd, pl, pb, B, K, n_iter, G, q, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
