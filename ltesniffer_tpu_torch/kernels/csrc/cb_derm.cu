// The de-rate-match of every turbo code block of a batched downlink PDSCH
// dispatch, for Hopper: window select, lap fold, rv rotation, inverse
// sub-block permutation, filler LLRs and the HARQ prior, one launch for
// every code block of a dependency round.
//
// Replaces the torch chain the port ran once per (K, F, laps, rv, offset)
// sub-group (kernels/cb_derm.py derm_plain, which is the de-rate-match of
// ltesniffer_tpu_torch/sniffer/pdsch_rx.py _derm_turbo_static_fn; in the
// JAX package the XLA program ltesniffer_tpu/sniffer/pdsch_rx.py:468
// _derm_turbo_static_fn, no pallas_call).  That chain took ~12 torch
// launches and two blocking uploads a sub-group, and a segmented block gave
// each of its code-block indices a sub-group of its own, so the host, not
// the card, set its cost.  Here every code block is a row of data.
//
// cb_derm, for the n code blocks of one round:
//   input   rows: (T, wm) f32, row r the descrambled LLRs of one grant;
//           desc: int32, kDescWords words a code block:
//             [0] row of `rows`   [1] window start off   [2] E
//             [3] K               [4] F                  [5] laps
//             [6] L, the cycle    [7] s0, the rv start rank
//             [8] output offset in `out`, in floats
//             [9] prior offset in `up`, in floats, or -1
//             [10,11] address of the (K, F) map, int32 (3 (K+4),)
//             [12,13] address of the HARQ prior, 0 for none or in `up`
//             [14] rv, [15] round (read by the plain version only)
//           up: the uploaded buffer the descriptors sit in, read as floats
//           where a prior rides with them (a prior held on the host)
//   output  out: each code block's (3, K+4) combined LLRs at its offset
//   For position p of the d streams, rank = map[p] (the rank of p's bit
//   among the circular buffer's transmitted positions, L where none is):
//   d[p] = sum over laps l of x[(rank - s0 mod L) + l L], x[e] = rows[row,
//   off + e] for e < E (and off + e < wm), else 0, summed in ascending lap
//   order as the plain version sums; 0 where rank = L; 1e4 at the fillers
//   (streams 0 and 1, columns < F); then + prior[p].
//
// Design: one block row (blockIdx.x) per code block, its 3 (K+4) positions
// over blockIdx.y x kThreads threads, one position a thread.  The map reads
// are coalesced and shared by every code block of one (K, F) through L2;
// the LLR reads are a gather within one row.  The descriptors come from one
// pinned upload a dispatch; the rounds (a retransmission that combines
// with an earlier code block of the same dispatch) are launches in order.
//
// Bound on the card: bytes.  Each position writes 4 bytes and reads its map
// word and, once over the code block, the E LLRs; a batch of the E-TM 3.1
// cell (320 code blocks of K 3904-5120) writes ~17 MB and reads ~10 MB of
// LLRs: ~8 us at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDescWords = 16;

__device__ __forceinline__ const void* address(int lo, int hi) {
  return reinterpret_cast<const void*>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
      static_cast<unsigned>(lo));
}

__global__ void __launch_bounds__(kThreads)
    cb_derm_kernel(const float* __restrict__ rows, long long wm,
                   const int* __restrict__ desc,
                   const float* __restrict__ up, float* __restrict__ out) {
  const int* d = desc + static_cast<size_t>(blockIdx.x) * kDescWords;
  const int kp = __ldg(d + 3) + 4;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= 3 * kp) return;
  const int F = __ldg(d + 4), laps = __ldg(d + 5), L = __ldg(d + 6);
  const int rank = __ldg(static_cast<const int*>(address(__ldg(d + 10),
                                                         __ldg(d + 11))) + p);
  float v = 0.f;
  if (rank < L) {
    const long long off = __ldg(d + 1);
    const float* x = rows + __ldg(d + 0) * wm + off;
    const long long lim = min(static_cast<long long>(__ldg(d + 2)), wm - off);
    int j = rank - __ldg(d + 7);
    if (j < 0) j += L;
    v = j < lim ? __ldg(x + j) : 0.f;
    for (int l = 1; l < laps; ++l) {
      const long long e = j + static_cast<long long>(l) * L;
      v += e < lim ? __ldg(x + e) : 0.f;
    }
  }
  if (p < 2 * kp && p % kp < F) v = 1e4f;  // fillers: known zeros
  const int pup = __ldg(d + 9);
  const float* prior =
      pup >= 0 ? up + pup
               : static_cast<const float*>(address(__ldg(d + 12), __ldg(d + 13)));
  if (prior != nullptr) v = v + __ldg(prior + p);
  out[__ldg(d + 8) + static_cast<long long>(p)] = v;
}

}  // namespace

extern "C" int cb_derm_threads() { return kThreads; }
extern "C" int cb_derm_desc_words() { return kDescWords; }

// Plain C entry point, loaded with ctypes.  rows: (T, wm) f32; desc: the
// uploaded int32 buffer, whose code blocks first .. first + n - 1 this
// launch takes (it is also `up`, the base of the prior offsets); chunks:
// blocks of kThreads positions a code block (ceil(3 (Kmax + 4) /
// kThreads)); out: the f32 output buffer; stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cb_derm_launch(const void* rows, long long wm, const void* desc,
                              int first, int n, int chunks, void* out,
                              void* stream) {
  if (n <= 0 || first < 0 || chunks <= 0 || chunks > 65535 || wm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* base = static_cast<const int*>(desc);
  cb_derm_kernel<<<dim3(n, chunks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), wm,
      base + static_cast<size_t>(first) * kDescWords,
      reinterpret_cast<const float*>(base), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
