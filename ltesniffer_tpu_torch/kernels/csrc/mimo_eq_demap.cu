// Equalize, demap and descramble one two-codeword (TM3 / TM4) PDSCH grant
// in one launch, for Hopper.
//
// Replaces the jitted XLA program of the JAX package,
// ltesniffer_tpu/sniffer/pdsch_rx.py:130 _eq_demap_mimo_fn (not a Pallas
// kernel), which the port's plain version (kernels/mimo_eq.py,
// eq_demap_mimo_plain) runs as 162 CUDA kernels a grant.  Same
// function, for one grant:
//
//   input   grid (RX, L, 2) f32 and h (RX, P, L, 2) f32, the subframe's
//           flattened resource grid and port channels; noise, a 0-d f32
//           device tensor read by pointer; re_idx (n_pad,) i64, the
//           grant's RE positions in the grid, the padded tail repeating
//           the last RE; c_init of each codeword; tm in {3, 4}, the
//           precoders; qm0, qm1 in {2, 4, 6, 8}
//   output  out (n_pad * (qm0 + qm1),) f32: codeword 0's descrambled LLRs
//           (n_pad * qm0, symbol-major), then codeword 1's
//
// Per RE i (its position in the grant's list, not its grid index):
// 1. the effective 2-layer channel: hw = h W, W the TM4 codebook matrix,
//    or for TM3 W_CDD (2 ports) or codebook 12 + (i / 2) % 4 (4 ports),
//    then for TM3 the D(i) U tail he = hw c0 + (hw c1) (-1)^i with
//    c0 = diag(1, 0) U and c1 = diag(0, 1) U.  Every product runs as the
//    plain version's constant-matrix product does (kernels/mimo.py
//    _apply_const_matrix): re = sum_p hr wr - sum_p hi wi, im = sum_p hr wi
//    + sum_p hi wr, p in order.  The precoder, the tail and the cycle are
//    NOT folded into one matrix per RE class: that would round
//    differently from the plain version.
// 2. the 2x2 MMSE of kernels/mimo.py mmse_2layer, operation by operation
//    (sums over RX in order, det clamped at 1e-12, inv_det = 1 / det, the
//    two solves);
// 3. the max-log demap of kernels/demapper.py per codeword; the final
//    division by sqrt(10 | 42 | 170) is a multiply by the float32
//    reciprocal, as PyTorch computes a CUDA tensor divided by a scalar;
// 4. the Gold descramble: bit n of codeword q is
//    x1(n) XOR parity(c_init_q & m(n)), m(n) column n of the x2 basis
//    (phy/sequences.py gold_basis); the table word holds m(n) in bits
//    0-30 and x1(n) in bit 31, so with bit 31 set in c the bit is
//    popc(c & word) & 1: integer arithmetic, equal to the plain version's
//    Gold bits bit for bit.  A set bit negates the LLR.
// Built with --fmad=false (kernels/nvcc_build.py), so no multiply-add is
// contracted: the elementwise steps round as the plain version's torch
// ops do.  The plain version's constant-matrix products are einsums,
// which PyTorch hands to cuBLAS on the card; with 2 ports each of their
// sums has one product that is not exact (or none), so they equal the
// kernel's; with 4 ports cuBLAS may sum in another order or fuse, and
// the kernel is held within a tolerance.
//
// Bound on the card: bytes.  At the MIMO cell's 8-PRB grants (~1000 REs,
// 2 RX, 2 ports) the function reads ~56 KB of grid, channel and index and
// writes n_pad (qm0 + qm1) floats (16-64 KB): ~0.03 us at 3.35 TB/s, far
// under one launch's latency.  What the design does about it: the whole
// step is one launch, one thread per RE, with no intermediate in device
// memory (the chain it replaces writes and reads each of its temporaries)
// and no host-to-device copy: the precoders, c_init and the shapes ride
// as kernel parameters, the noise is read by pointer, the Gold table is
// uploaded once per device, and the RE index is the caller's (cached per
// subframe, CFI and PRB mask by sniffer/pdsch_rx.py).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPorts = 4;
constexpr int kMaxCycle = 4;
constexpr int kMatFloats = 4 * kMaxPorts;  // re[p][l], im[p][l]
// floats of the constant block the C entry takes: kMaxCycle precoders,
// the two tail matrices, then scale[4], inv_scale[4] of the demapper
// (QPSK, 16, 64, 256QAM)
constexpr int kConstFloats = (kMaxCycle + 2) * kMatFloats + 8;

// One complex (P x 2) matrix, [port][layer].
struct Mat {
  float re[kMaxPorts][2];
  float im[kMaxPorts][2];
};

struct Params {
  Mat w[kMaxCycle];  // precoders: w[0], or w[(i / 2) % 4] when cycling
  Mat tail[2];       // c0 = diag(1, 0) U, c1 = diag(0, 1) U (rows 0-1)
  float scale[4];    // demapper's sqrt(2), sqrt(10), sqrt(42), sqrt(170)
  float inv[4];      // their float32 reciprocals
  const float* grid;
  const float* h;
  const float* noise;
  const long long* re_idx;
  const uint32_t* gold;
  float* out;
  long long L;       // REs per antenna plane of the grid (14 n_sc)
  int n_pad, qm0, qm1, n_cycle, cdd;
  uint32_t c0, c1;   // c_init of each codeword, bit 31 set
};

// out = h W for one receive antenna: the plain version's four einsums
// (sums over p in order), then re = rr - ii, im = ri + ir.
template <int P>
__device__ __forceinline__ void apply(const float (&hr)[P],
                                      const float (&hi)[P], const Mat& w,
                                      float (&outr)[2], float (&outi)[2]) {
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    float rr = hr[0] * w.re[0][l], ii = hi[0] * w.im[0][l];
    float ri = hr[0] * w.im[0][l], ir = hi[0] * w.re[0][l];
#pragma unroll
    for (int p = 1; p < P; ++p) {
      rr = rr + hr[p] * w.re[p][l];
      ii = ii + hi[p] * w.im[p][l];
      ri = ri + hr[p] * w.im[p][l];
      ir = ir + hi[p] * w.re[p][l];
    }
    outr[l] = rr - ii;
    outi[l] = ri + ir;
  }
}

__device__ __forceinline__ int qm_slot(int qm) { return (qm >> 1) - 1; }

// Demap one layer's symbol (xr, xi) into qm LLRs, descramble them with
// Gold bits n0 .. n0 + qm - 1 and store them at dst[0 .. qm).
__device__ __forceinline__ void demap_store(const Params& p, float xr,
                                            float xi, int qm, uint32_t c,
                                            long long n0, float* dst) {
  const int s = qm_slot(qm);
  const float sc = p.scale[s], inv = p.inv[s];
  float v[8];
  const float re = xr * sc, im = xi * sc;
  if (qm == 2) {
    v[0] = re;
    v[1] = im;
  } else {
    // 16QAM: 2 - |re|; 64QAM: 4 - |re|, 2 - |b2|; 256QAM: 8, 4, 2
    const float top = qm == 4 ? 2.0f : (qm == 6 ? 4.0f : 8.0f);
    v[0] = re;
    v[1] = im;
    v[2] = top - fabsf(re);
    v[3] = top - fabsf(im);
    if (qm >= 6) {
      const float mid = qm == 6 ? 2.0f : 4.0f;
      v[4] = mid - fabsf(v[2]);
      v[5] = mid - fabsf(v[3]);
      if (qm == 8) {
        v[6] = 2.0f - fabsf(v[4]);
        v[7] = 2.0f - fabsf(v[5]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < qm) v[j] = v[j] * inv;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < qm) {
      const uint32_t bit = __popc(c & p.gold[n0 + j]) & 1u;
      dst[j] = bit ? -v[j] : v[j];
    }
  }
}

template <int RX, int P>
__global__ void __launch_bounds__(kThreads)
    mimo_eq_demap_kernel(const __grid_constant__ Params p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n_pad) return;
  const long long e = p.re_idx[i];
  float* out0 = p.out + static_cast<long long>(i) * p.qm0;
  float* out1 = p.out + static_cast<long long>(p.n_pad) * p.qm0 +
                static_cast<long long>(i) * p.qm1;
  if (e < 0 || e >= p.L) {
    // an index outside the grid reads nothing: its LLRs are NaN
    for (int j = 0; j < p.qm0; ++j) out0[j] = __int_as_float(0x7fc00000);
    for (int j = 0; j < p.qm1; ++j) out1[j] = __int_as_float(0x7fc00000);
    return;
  }
  const Mat& w = p.w[p.n_cycle == kMaxCycle ? (i >> 1) & 3 : 0];
  const float sign = (i & 1) ? -1.0f : 1.0f;
  float yr[RX], yi[RX], h0r[RX], h0i[RX], h1r[RX], h1i[RX];
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const float2 yv =
        reinterpret_cast<const float2*>(p.grid)[r * p.L + e];
    yr[r] = yv.x;
    yi[r] = yv.y;
    float hr[P], hi[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float2 hv = reinterpret_cast<const float2*>(
          p.h)[(static_cast<long long>(r) * P + q) * p.L + e];
      hr[q] = hv.x;
      hi[q] = hv.y;
    }
    float er[2], ei[2];
    apply<P>(hr, hi, w, er, ei);
    if (p.cdd) {
      float ar[2], ai[2], br[2], bi[2];
      apply<2>(er, ei, p.tail[0], ar, ai);
      apply<2>(er, ei, p.tail[1], br, bi);
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        er[l] = ar[l] + br[l] * sign;
        ei[l] = ai[l] + bi[l] * sign;
      }
    }
    h0r[r] = er[0];
    h0i[r] = ei[0];
    h1r[r] = er[1];
    h1i[r] = ei[1];
  }
  // mmse_2layer: a, d = sum_r |h|^2 + noise; b = sum_r h1 conj(h0);
  // z0, z1 = sum_r y conj(h0 | h1); sums over r in order
  float a = 0.f, d = 0.f, b_r = 0.f, b_i = 0.f;
  float z0r = 0.f, z0i = 0.f, z1r = 0.f, z1i = 0.f;
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const float va = h0r[r] * h0r[r] + h0i[r] * h0i[r];
    const float vd = h1r[r] * h1r[r] + h1i[r] * h1i[r];
    const float vbr = h1r[r] * h0r[r] + h1i[r] * h0i[r];
    const float vbi = h1i[r] * h0r[r] - h1r[r] * h0i[r];
    const float v0r = yr[r] * h0r[r] + yi[r] * h0i[r];
    const float v0i = yi[r] * h0r[r] - yr[r] * h0i[r];
    const float v1r = yr[r] * h1r[r] + yi[r] * h1i[r];
    const float v1i = yi[r] * h1r[r] - yr[r] * h1i[r];
    if (r == 0) {
      a = va; d = vd; b_r = vbr; b_i = vbi;
      z0r = v0r; z0i = v0i; z1r = v1r; z1i = v1i;
    } else {
      a = a + va; d = d + vd; b_r = b_r + vbr; b_i = b_i + vbi;
      z0r = z0r + v0r; z0i = z0i + v0i; z1r = z1r + v1r; z1i = z1i + v1i;
    }
  }
  const float nv = *p.noise;
  a = a + nv;
  d = d + nv;
  const float det = a * d - (b_r * b_r + b_i * b_i);
  // torch.clamp(det, min=1e-12) keeps a NaN; 1 / x is IEEE division
  const float inv_det = 1.0f / (det < 1e-12f ? 1e-12f : det);
  // x0 = (z0 d - b z1) inv_det; x1 = (z1 a - conj(b) z0) inv_det
  const float x0r = (z0r * d - (b_r * z1r - b_i * z1i)) * inv_det;
  const float x0i = (z0i * d - (b_r * z1i + b_i * z1r)) * inv_det;
  const float nbi = -b_i;
  const float x1r = (z1r * a - (b_r * z0r - nbi * z0i)) * inv_det;
  const float x1i = (z1i * a - (b_r * z0i + nbi * z0r)) * inv_det;
  demap_store(p, x0r, x0i, p.qm0, p.c0, static_cast<long long>(i) * p.qm0,
              out0);
  demap_store(p, x1r, x1i, p.qm1, p.c1, static_cast<long long>(i) * p.qm1,
              out1);
}

template <int RX, int P>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const int blocks = (p.n_pad + kThreads - 1) / kThreads;
  mimo_eq_demap_kernel<RX, P><<<blocks, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

bool good_qm(int qm) { return qm == 2 || qm == 4 || qm == 6 || qm == 8; }

}  // namespace

extern "C" int mimo_eq_demap_const_floats() { return kConstFloats; }

// Plain C entry point, loaded with ctypes.  grid: contiguous (rx, L, 2)
// f32; h: contiguous (rx, ports, L, 2) f32; noise: one f32; re_idx:
// (n_pad,) i64; gold: the Gold table words, at least n_pad * max(qm0,
// qm1) of them; out: n_pad * (qm0 + qm1) f32 (all device pointers,
// 8-byte aligned where they hold pairs).  c0, c1: the codewords' c_init.
// n_cycle: 1, or 4 to cycle the precoders per RE pair (TM3, 4 ports);
// cdd: 1 to apply the D(i) U tail (TM3).  consts: kConstFloats host floats
// (see Params).  stream: a cudaStream_t.  Returns the cudaError_t of the
// launch (0 on success); shapes it does not take return
// cudaErrorInvalidValue and launch nothing.
extern "C" int mimo_eq_demap_launch(const void* grid, const void* h,
                                    const void* noise, const void* re_idx,
                                    const void* gold, void* out, long long L,
                                    int rx, int ports, int n_pad, int qm0,
                                    int qm1, int n_cycle, int cdd,
                                    unsigned int c0, unsigned int c1,
                                    const float* consts, void* stream) {
  if (!grid || !h || !noise || !re_idx || !gold || !out || !consts ||
      L <= 0 || n_pad <= 0 || !good_qm(qm0) || !good_qm(qm1) ||
      (n_cycle != 1 && n_cycle != kMaxCycle) || (cdd != 0 && cdd != 1) ||
      (reinterpret_cast<uintptr_t>(grid) & 7) ||
      (reinterpret_cast<uintptr_t>(h) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  const float* c = consts;
  for (int k = 0; k < kMaxCycle + 2; ++k) {
    Mat& m = k < kMaxCycle ? p.w[k] : p.tail[k - kMaxCycle];
    for (int q = 0; q < kMaxPorts; ++q)
      for (int l = 0; l < 2; ++l) {
        m.re[q][l] = c[q * 2 + l];
        m.im[q][l] = c[2 * kMaxPorts + q * 2 + l];
      }
    c += kMatFloats;
  }
  for (int k = 0; k < 4; ++k) {
    p.scale[k] = c[k];
    p.inv[k] = c[4 + k];
  }
  p.grid = static_cast<const float*>(grid);
  p.h = static_cast<const float*>(h);
  p.noise = static_cast<const float*>(noise);
  p.re_idx = static_cast<const long long*>(re_idx);
  p.gold = static_cast<const uint32_t*>(gold);
  p.out = static_cast<float*>(out);
  p.L = L;
  p.n_pad = n_pad;
  p.qm0 = qm0;
  p.qm1 = qm1;
  p.n_cycle = n_cycle;
  p.cdd = cdd;
  p.c0 = (c0 & 0x7fffffffu) | 0x80000000u;
  p.c1 = (c1 & 0x7fffffffu) | 0x80000000u;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rx == 1 && ports == 2) return static_cast<int>(launch<1, 2>(p, s));
  if (rx == 1 && ports == 4) return static_cast<int>(launch<1, 4>(p, s));
  if (rx == 2 && ports == 2) return static_cast<int>(launch<2, 2>(p, s));
  if (rx == 2 && ports == 4) return static_cast<int>(launch<2, 4>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
