// Equalize, demap and descramble every single-layer PDSCH grant of a
// batched dispatch in one launch, for Hopper.
//
// Replaces the jitted XLA programs of the JAX package,
// ltesniffer_tpu/sniffer/pdsch_rx.py:294 _eq_demap_batch_fn, :336 _reorg_fn
// and :357 _eq_demap_prb_fn (not Pallas kernels), which the port's plain
// version (kernels/pdsch_eq.py, eq_demap_plain) runs as one chain of ~73
// CUDA kernels per group of grants (grants of one qm and one RE pattern
// size), ~5 groups a batch of the loaded cell.  Same function, for every
// grant of the dispatch:
//
//   input   grid (B, RX, L, 2) f32 and h (B, RX, P, L, 2) f32, the batch's
//           flattened resource grids and port channels in their own layout
//           (L = 14 n_sc); noise (B,) f32, read by pointer; the grants'
//           descriptors (below), one int32 buffer; re_tab (U, tab_w) i64,
//           RE index rows of the grants whose RE pattern is irregular
//   output  out (G, wm) f32: row g holds grant g's n_pad * qm descrambled
//           LLRs (symbol-major), then zeros to wm
//
// A grant's descriptor (kDescWords int32): b, qm, c_init, p_a (float bits),
// n_re, n_pad, src, shape.  Its REs come in one of two ways:
// - shape >= 0 (cfi << 8 | n_prb): the grant's PRB list, n_prb ascending
//   PRB numbers at aux[src], and the cell's data subcarriers of a PRB in
//   each symbol (cnt[l], ksel[l][..], kernel parameters: the CRS pattern
//   has period 6, so every PRB of a symbol has the same ones).  RE ordinal
//   i counts symbols l = cfi .. 13, in each the PRBs in order, in each the
//   data subcarriers: i -> (l, PRB slot, subcarrier) -> l n_sc + 12 PRB + k,
//   the order pdsch.grant_re_indices lists them in;
// - shape < 0: row src of re_tab (the centre PRBs of subframes 0 and 5,
//   two slot masks), the tail past n_re repeating the last RE.
// Ordinals past n_re read the last RE (the plain version's padding).  The
// descriptors are followed by first[G + 1], each grant's first block, and
// the PRB lists (aux): the whole buffer is one pinned host-to-device copy.
//
// Each block belongs to one grant (a binary search of first[]); a thread
// takes one RE (1 port), the Alamouti pair (2 ports, SFBC) or the quad (4
// ports, SFBC-FSTD) the combiner needs together, and:
// 1. gathers y and the port channels at its REs, the channels times p_a;
// 2. combines as kernels/chest.py does, operation by operation: port 0
//    (equalize_port0: sum_r y conj(h) over sum_r |h|^2 + noise), SFBC and
//    SFBC-FSTD (equalize_sfbc / equalize_sfbc4: per pair, the two
//    conjugate products summed over RX, divided by sum_r |ha|^2 + |hb|^2 +
//    noise, times sqrt(2));
// 3. demaps max-log as kernels/demapper.py does; the final division by
//    sqrt(10 | 42 | 170) is a multiply by the float32 reciprocal, as
//    PyTorch computes a CUDA tensor divided by a scalar;
// 4. descrambles: LLR n of the grant is negated when
//    popc((c_init | 1 << 31) & gold[n]) is odd (kernels/mimo_eq.py
//    gold_words: the x2 basis column in bits 0-30, x1(n) in bit 31), the
//    plain version's Gold bits bit for bit.
// The block's threads also zero the row's tail past n_pad * qm, so the
// output needs no memset.  Built with --fmad=false (kernels/nvcc_build.py):
// no multiply-add is contracted, each step rounds as the plain version's
// torch op does, so on the card the kernel gives the plain version's
// floats.
//
// Bound on the card: bytes, and below them the launch.  A batch of the
// loaded cell (~384 grants of ~1000 REs, 1 RX, 2 ports) reads ~24 B of grid
// and channel per RE and writes ~1.3 kB of LLRs per grant: ~10 MB, ~3 us
// at 3.35 TB/s.  What the design does about it: one launch for the whole
// dispatch whatever the grants' qm, size and RE pattern, no intermediate
// in device memory (the chain it replaces writes and reads each of its
// temporaries and two permuted copies of the grids), and one host-to-device
// copy of the descriptors, from pinned memory without a sync.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDescWords = 8;
constexpr int kSyms = 14;
constexpr int kSc = 12;
// the C entry's constant blocks: scale[4], inv[4], sqrt2; cnt[14], ksel
constexpr int kConstFloats = 9;
constexpr int kConstInts = kSyms + kSyms * kSc;

enum { kB = 0, kQm, kCinit, kPa, kNre, kNpad, kSrc, kShape };

struct Params {
  float scale[4];  // demapper's sqrt(2), sqrt(10), sqrt(42), sqrt(170)
  float inv[4];    // their float32 reciprocals
  float sqrt2;     // the SFBC combiners' float32 sqrt(2)
  int cnt[kSyms];  // data subcarriers of a PRB in symbol l
  unsigned char ksel[kSyms][kSc];  // which ones, ascending
  const float* grid;
  const float* h;
  const float* noise;
  const long long* re_tab;
  const uint32_t* gold;
  const int* desc;
  float* out;
  long long L;     // REs per antenna plane of a subframe (14 n_sc)
  int n_sc, wm, n_grants, tab_w;
};

__device__ __forceinline__ float2 ld2(const float* base, long long at) {
  return reinterpret_cast<const float2*>(base)[at];
}

// The grid position of RE ordinal i (already clamped below n_re).
__device__ __forceinline__ long long re_at(const Params& p, const int* d,
                                           const int* aux, int i) {
  const int shape = d[kShape];
  if (shape < 0)
    return p.re_tab[static_cast<long long>(d[kSrc]) * p.tab_w + i];
  const int n_prb = shape & 0xff;
  int l = shape >> 8, rem = i;
  for (; l < kSyms - 1; ++l) {
    const int seg = n_prb * p.cnt[l];
    if (rem < seg) break;
    rem -= seg;
  }
  const int c = p.cnt[l];
  const int slot = rem / c;
  const int k = p.ksel[l][rem - slot * c];
  return static_cast<long long>(l) * p.n_sc + aux[d[kSrc] + slot] * kSc + k;
}

// equalize_sfbc's algebra for ports (A, B) on REs (j, j + 1), summed over
// RX in order: xa = sum_r y_j conj(ha_j) + hb_j1 conj(y_j1), xb = sum_r
// y_j1 conj(ha_j1) - hb_j conj(y_j), over sum_r |ha_j|^2 + |hb_j|^2 + nv.
template <int RX>
__device__ __forceinline__ void pair(const float2 (&yj)[RX],
                                     const float2 (&yj1)[RX],
                                     const float2 (&haj)[RX],
                                     const float2 (&haj1)[RX],
                                     const float2 (&hbj)[RX],
                                     const float2 (&hbj1)[RX], float nv,
                                     float2& xa, float2& xb) {
  float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f, nrm = 0.f;
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const float2 y0 = yj[r], y1 = yj1[r], a0 = haj[r], a1 = haj1[r],
                 b0 = hbj[r], b1 = hbj1[r];
    const float tar = (y0.x * a0.x + y0.y * a0.y) + (b1.x * y1.x + b1.y * y1.y);
    const float tai = (y0.y * a0.x - y0.x * a0.y) + (b1.y * y1.x - b1.x * y1.y);
    const float tbr = (y1.x * a1.x + y1.y * a1.y) - (b0.x * y0.x + b0.y * y0.y);
    const float tbi = (y1.y * a1.x - y1.x * a1.y) - (b0.y * y0.x - b0.x * y0.y);
    const float tn = (a0.x * a0.x + a0.y * a0.y) + (b0.x * b0.x + b0.y * b0.y);
    if (r == 0) {
      ar = tar; ai = tai; br = tbr; bi = tbi; nrm = tn;
    } else {
      ar = ar + tar; ai = ai + tai; br = br + tbr; bi = bi + tbi;
      nrm = nrm + tn;
    }
  }
  nrm = nrm + nv;
  xa = make_float2(ar / nrm, ai / nrm);
  xb = make_float2(br / nrm, bi / nrm);
}

// Demap one symbol (xr, xi) into qm LLRs, descramble them with Gold bits
// n0 .. n0 + qm - 1 and store them at dst[0 .. qm).
__device__ __forceinline__ void demap_store(const Params& p, float xr,
                                            float xi, int qm, uint32_t c,
                                            long long n0, float* dst) {
  const int s = (qm >> 1) - 1;
  const float sc = p.scale[s], inv = p.inv[s];
  float v[8];
  const float re = xr * sc, im = xi * sc;
  v[0] = re;
  v[1] = im;
  if (qm > 2) {
    // 16QAM: 2 - |re|; 64QAM: 4 - |re|, 2 - |b2|; 256QAM: 8, 4, 2
    const float top = qm == 4 ? 2.0f : (qm == 6 ? 4.0f : 8.0f);
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

// REs a thread takes: 1 (port 0), 2 (SFBC pair), 4 (SFBC-FSTD quad).
template <int P>
constexpr int kN = P == 1 ? 1 : P;

template <int RX, int P>
__global__ void __launch_bounds__(kThreads)
    pdsch_eq_demap_kernel(const __grid_constant__ Params p) {
  constexpr int N = kN<P>;
  const int* first = p.desc + p.n_grants * kDescWords;
  const int* aux = first + p.n_grants + 1;
  const int blk = blockIdx.x;
  // the block's grant: the last g with first[g] <= blk
  int lo = 0, hi = p.n_grants - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int g = lo;
  const int* d = p.desc + g * kDescWords;
  const int chunk = blk - first[g], n_chunks = first[g + 1] - first[g];
  const int qm = d[kQm], n_re = d[kNre], n_pad = d[kNpad];
  float* row = p.out + static_cast<long long>(g) * p.wm;
  // the row's tail past n_pad * qm, spread over the grant's blocks
  for (int j = n_pad * qm + chunk * kThreads + threadIdx.x; j < p.wm;
       j += n_chunks * kThreads)
    row[j] = 0.0f;
  const int i0 = (chunk * kThreads + threadIdx.x) * N;
  if (i0 >= n_pad) return;
  const int b = d[kB];
  const float pa = __int_as_float(d[kPa]);
  const uint32_t c =
      (static_cast<uint32_t>(d[kCinit]) & 0x7fffffffu) | 0x80000000u;
  long long e[N];
  bool inside = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    e[k] = re_at(p, d, aux, min(i0 + k, n_re - 1));
    inside = inside && e[k] >= 0 && e[k] < p.L;
  }
  float* dst = row + static_cast<long long>(i0) * qm;
  if (!inside) {
    // an index outside the grid reads nothing: its LLRs are NaN
    for (int j = 0; j < N * qm; ++j) dst[j] = __int_as_float(0x7fc00000);
    return;
  }
  // port ka[k] and kb[k] of RE k: SFBC (0, 1); SFBC-FSTD (0, 2), (1, 3)
  float2 y[N][RX], ha[N][RX], hb[N][RX];
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const long long plane = static_cast<long long>(b) * RX + r;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      y[k][r] = ld2(p.grid, plane * p.L + e[k]);
      const int qa = P == 4 ? (k >> 1) : 0;
      const float2 va = ld2(p.h, (plane * P + qa) * p.L + e[k]);
      ha[k][r] = make_float2(va.x * pa, va.y * pa);
      if constexpr (P > 1) {
        const int qb = P == 4 ? 2 + (k >> 1) : 1;
        const float2 vb = ld2(p.h, (plane * P + qb) * p.L + e[k]);
        hb[k][r] = make_float2(vb.x * pa, vb.y * pa);
      }
    }
  }
  const float nv = p.noise[b];
  float2 x[N];
  if constexpr (P == 1) {
    // equalize_port0: sum_r y conj(h) / (sum_r |h|^2 + nv)
    float nr = 0.f, ni = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const float2 yv = y[0][r], hv = ha[0][r];
      const float tr = yv.x * hv.x + yv.y * hv.y;
      const float ti = yv.y * hv.x - yv.x * hv.y;
      const float tn = hv.x * hv.x + hv.y * hv.y;
      if (r == 0) {
        nr = tr; ni = ti; den = tn;
      } else {
        nr = nr + tr; ni = ni + ti; den = den + tn;
      }
    }
    den = den + nv;
    x[0] = make_float2(nr / den, ni / den);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      pair<RX>(y[k], y[k + 1], ha[k], ha[k + 1], hb[k], hb[k + 1], nv,
               x[k], x[k + 1]);
#pragma unroll
    for (int k = 0; k < N; ++k)
      x[k] = make_float2(x[k].x * p.sqrt2, x[k].y * p.sqrt2);
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    demap_store(p, x[k].x, x[k].y, qm, c,
                static_cast<long long>(i0 + k) * qm, dst + k * qm);
}

template <int RX, int P>
cudaError_t launch(const Params& p, int n_blocks, cudaStream_t s) {
  pdsch_eq_demap_kernel<RX, P><<<n_blocks, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pdsch_eq_demap_threads() { return kThreads; }
extern "C" int pdsch_eq_demap_desc_words() { return kDescWords; }
extern "C" int pdsch_eq_demap_const_floats() { return kConstFloats; }
extern "C" int pdsch_eq_demap_const_ints() { return kConstInts; }

// Plain C entry point, loaded with ctypes.  grid: contiguous (B, rx, L, 2)
// f32; h: contiguous (B, rx, ports, L, 2) f32; noise: (B,) f32; re_tab:
// (U, tab_w) i64 (may be null when no grant reads it); gold: the Gold table
// words, at least max n_pad * qm of them; desc: the n_grants descriptors,
// first[n_grants + 1] and the PRB lists, int32; out: (n_grants, wm) f32
// (all device pointers, 8-byte aligned where they hold pairs).  n_blocks:
// first[n_grants].  consts: kConstFloats host floats, ints: kConstInts host
// ints (see Params).  stream: a cudaStream_t.  Returns the cudaError_t of
// the launch (0 on success); shapes it does not take return
// cudaErrorInvalidValue and launch nothing.
extern "C" int pdsch_eq_demap_launch(const void* grid, const void* h,
                                     const void* noise, const void* re_tab,
                                     const void* gold, const void* desc,
                                     void* out, long long L, int n_sc, int rx,
                                     int ports, int n_grants, int n_blocks,
                                     int wm, int tab_w, const float* consts,
                                     const int* ints, void* stream) {
  if (!grid || !h || !noise || !gold || !desc || !out || !consts || !ints ||
      L <= 0 || L != static_cast<long long>(kSyms) * n_sc ||
      n_grants <= 0 || n_blocks < n_grants || wm <= 0 || tab_w < 0 ||
      (reinterpret_cast<uintptr_t>(grid) & 7) ||
      (reinterpret_cast<uintptr_t>(h) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int k = 0; k < 4; ++k) {
    p.scale[k] = consts[k];
    p.inv[k] = consts[4 + k];
  }
  p.sqrt2 = consts[8];
  for (int l = 0; l < kSyms; ++l) {
    p.cnt[l] = ints[l];
    if (p.cnt[l] < 1 || p.cnt[l] > kSc)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < kSc; ++k)
      p.ksel[l][k] = static_cast<unsigned char>(ints[kSyms + l * kSc + k]);
  }
  p.grid = static_cast<const float*>(grid);
  p.h = static_cast<const float*>(h);
  p.noise = static_cast<const float*>(noise);
  p.re_tab = static_cast<const long long*>(re_tab);
  p.gold = static_cast<const uint32_t*>(gold);
  p.desc = static_cast<const int*>(desc);
  p.out = static_cast<float*>(out);
  p.L = L;
  p.n_sc = n_sc;
  p.wm = wm;
  p.n_grants = n_grants;
  p.tab_w = tab_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rx == 1 && ports == 1) return static_cast<int>(launch<1, 1>(p, n_blocks, s));
  if (rx == 1 && ports == 2) return static_cast<int>(launch<1, 2>(p, n_blocks, s));
  if (rx == 1 && ports == 4) return static_cast<int>(launch<1, 4>(p, n_blocks, s));
  if (rx == 2 && ports == 1) return static_cast<int>(launch<2, 1>(p, n_blocks, s));
  if (rx == 2 && ports == 2) return static_cast<int>(launch<2, 2>(p, n_blocks, s));
  if (rx == 2 && ports == 4) return static_cast<int>(launch<2, 4>(p, n_blocks, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
