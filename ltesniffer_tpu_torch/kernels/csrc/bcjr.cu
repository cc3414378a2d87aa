// Windowed max-log-MAP BCJR pass of the LTE turbo decoder, for Hopper.
//
// Replaces the TPU kernel ltesniffer_tpu/kernels/turbo_pallas.py:make_bcjr
// (body _bcjr_kernel).  Same function: one constituent BCJR pass over
// W-step windows for L lanes, one lane per (code block x window):
//
//   inputs  apr, l_sys, l_par (W, L) f32; a0, bK (8, L) f32
//   outputs ext (W, L) = llr - (apr + l_sys); a_end (8, L) = alpha at the
//           window end; b_start (8, L) = beta at the window start.
//
// Design: one thread per lane.  The 8 RSC state metrics live in registers;
// the window's forward alphas (W <= 32 steps x 8 states) live in a
// per-thread array (registers, spilling to L1-cached local memory at
// W = 32).  The backward recursion is fused with the extrinsic output.
// Neighbouring threads take neighbouring lanes, so every (W, L) row load
// and store is coalesced.  The loops are unrolled over W (a template
// parameter), so the trellis tables of bcjr_step.cuh fold into constant
// indices.
//
// Rounding: built with --fmad=false, and every sum is formed in the same
// order as the plain twin (kernels/bcjr.py:bcjr_plain), so the decided
// bits equal the twin's, not just come close.
//
// Bound on the card: the pass is memory-bound.  It reads apr, l_sys, l_par
// and a0, bK once and writes ext, a_end, b_start once:
// bytes = (4*W + 32) * L * 4 per pass (about 24 ACS operations per state
// per step is far below the float32 rate).
//
// The recurrence (trellis tables, sum order) is bcjr_step.cuh, shared with
// the fused whole-decode kernel turbo_decode.cu, which the main path runs;
// this per-pass kernel stays as that kernel's yardstick
// (kernels/turbo.py:make_decoder_lanes).

#include <cuda_runtime.h>

#include "bcjr_step.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(128)
bcjr_kernel(const float* __restrict__ apr, const float* __restrict__ l_sys,
            const float* __restrict__ l_par, const float* __restrict__ a0,
            const float* __restrict__ bK, float* __restrict__ ext,
            float* __restrict__ a_end, float* __restrict__ b_start, int L) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;

  float alphas[W][8];
  float alpha[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) alpha[s] = a0[s * L + j];

  // forward: store alpha_k, carry alpha_{k+1} normalised to state 0
#pragma unroll
  for (int k = 0; k < W; ++k) {
#pragma unroll
    for (int s = 0; s < 8; ++s) alphas[k][s] = alpha[s];
    bcjr_alpha_step(alpha, apr[k * L + j], l_sys[k * L + j],
                    l_par[k * L + j]);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) a_end[s * L + j] = alpha[s];

  // backward fused with the extrinsic output
  float beta[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = bK[s * L + j];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int k = W - 1 - i;
    ext[k * L + j] = bcjr_beta_step(beta, alphas[k], apr[k * L + j],
                                    l_sys[k * L + j], l_par[k * L + j]);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) b_start[s * L + j] = beta[s];
}

template <int W>
cudaError_t launch(const float* apr, const float* l_sys, const float* l_par,
                   const float* a0, const float* bK, float* ext, float* a_end,
                   float* b_start, int L, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  bcjr_kernel<W><<<blocks, threads, 0, stream>>>(apr, l_sys, l_par, a0, bK,
                                                 ext, a_end, b_start, L);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous float32 tensors; stream is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); W outside {8, 16, 32} returns
// cudaErrorInvalidValue.
extern "C" int bcjr_launch(const void* apr, const void* l_sys,
                           const void* l_par, const void* a0, const void* bK,
                           void* ext, void* a_end, void* b_start, int L,
                           int W, void* stream) {
  const float* p_apr = static_cast<const float*>(apr);
  const float* p_sys = static_cast<const float*>(l_sys);
  const float* p_par = static_cast<const float*>(l_par);
  const float* p_a0 = static_cast<const float*>(a0);
  const float* p_bK = static_cast<const float*>(bK);
  float* p_ext = static_cast<float*>(ext);
  float* p_ae = static_cast<float*>(a_end);
  float* p_bs = static_cast<float*>(b_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8:
      return launch<8>(p_apr, p_sys, p_par, p_a0, p_bK, p_ext, p_ae, p_bs, L, s);
    case 16:
      return launch<16>(p_apr, p_sys, p_par, p_a0, p_bK, p_ext, p_ae, p_bs, L, s);
    case 32:
      return launch<32>(p_apr, p_sys, p_par, p_a0, p_bK, p_ext, p_ae, p_bs, L, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
