// The finish of the batched downlink PDSCH decode's transport blocks, for
// Hopper: each block's TB CRC24A and CB CRC24B flags and its payload bytes,
// from the turbo decode's fused rows, in one launch a dispatch.
//
// No TPU kernel corresponds to it: the JAX package reads the fused rows
// to the host, unpacks every bit and checks each block's CRC24A there
// (ltesniffer_tpu/sniffer/pdsch_rx.py finish_grants_batch / _assemble_tb).
// It was added to take that per-bit work off the port's host, which holds
// the card back: the host then reads only the status words and the bytes.
//
// tb_finish, for n_tb transport blocks and their n_cb code blocks:
//   input   fused: int64 words, each code block one row [CB CRC24B
//           remainder popcount | u32 words of its K decoded bits], bit i
//           in word i / 32 at bit i % 32 (pdsch_rx._crc_pack's layout);
//           desc: int32, (n_tb, 5) rows [tbs, C, F, payload byte offset,
//           first code block] then (n_cb, 2) rows [row's word offset in
//           fused, K]; tab: 256 u32 byte remainders b x^24 mod g(x), then
//           kPowTerms u32 powers x^(8 2^j) mod g(x) (g: LTE's CRC24A)
//   output  out: tbs / 8 payload bytes of each block at its offset, MSB
//           first (np.packbits of its bits); a u32 status word of block t
//           at byte stat_off + 4 t: bit 0 the TB CRC24A remainder is zero
//           and every CB CRC24B is, bits 1..C each code block's CB CRC24B
//           remainder is zero.  A block with C = 1 carries no CB CRC: its
//           bit 1 is set and bit 0 is the TB check, as the host's finish.
//   A block's stream is its code blocks' data in order: block 0 from bit
//   F, each to K - 24 (K for C = 1), tbs + 24 bits in all, the last 24
//   the TB CRC (checked, not written).  tbs, F and K are multiples of 8,
//   so every code block's data starts on a byte of its row.
//
// Design: one block of threads per transport block.  Warp 0 reads the
// code blocks' rows and CB remainders and scans their byte counts; each
// thread then takes a contiguous span of the stream's bytes, gathers
// them from the row words, writes the payload bytes and takes the CRC of
// its span by a byte table.  LTE's CRCs are linear over GF(2) (zero init,
// no final XOR, phy/crc.py): the stream's remainder is the XOR of each
// span's remainder times x^(8 n) mod g(x), n the bytes after the span, so
// each thread shifts its remainder by the powers of two of n and the
// block reduces by XOR.
//
// Bound on the card: a launch, not bytes.  A batch of 32 subframes of the
// E-TM 3.1 cell (128 blocks, 320 code blocks of K up to 5120) reads 0.37 MB
// of rows and writes 0.18 MB: ~0.17 us at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 31;      // code blocks a transport block (status bits)
constexpr int kPowTerms = 24;  // spans end < 2^24 bytes before the stream's
constexpr uint32_t kPolyFull = 0x1864CFBu;  // CRC24A with its x^24 term
constexpr int kTabWords = 256 + kPowTerms;

struct Params {
  const long long* fused;
  const int* tb;
  const int* cb;
  const uint32_t* tab;
  unsigned char* out;
  uint32_t* status;
};

// a b mod g(x) for a, b of degree < 24
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 23; i >= 0; --i) {
    r = (r << 1) ^ ((r & 0x800000u) ? kPolyFull : 0u);
    r ^= ((b >> i) & 1u) ? a : 0u;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) tb_finish_kernel(const Params p) {
  __shared__ uint32_t s_tab[kTabWords];
  __shared__ int s_pre[kMaxC + 1];  // stream byte where code block r starts
  __shared__ int s_row[kMaxC];
  __shared__ int s_skip[kMaxC];     // row byte where its data starts
  __shared__ uint32_t s_part[kThreads / 32];
  __shared__ uint32_t s_cbok;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* d = p.tb + 5 * t;
  const int tbs = d[0], C = d[1], F = d[2], off = d[3], cb0 = d[4];
  if (tbs <= 0 || C < 1 || C > kMaxC) {
    if (tid == 0) p.status[t] = 0u;
    return;
  }
  for (int i = tid; i < kTabWords; i += kThreads) s_tab[i] = __ldg(p.tab + i);
  if (warp == 0) {
    int nbytes = 0;
    bool fail = false;
    if (lane < C) {
      const int row = __ldg(p.cb + 2 * (cb0 + lane));
      const int K = __ldg(p.cb + 2 * (cb0 + lane) + 1);
      const int skip = lane == 0 ? F : 0;
      nbytes = (K - (C > 1 ? 24 : 0) - skip) >> 3;
      s_row[lane] = row;
      s_skip[lane] = skip >> 3;
      fail = C > 1 && __ldg(p.fused + row) != 0;
    }
    int incl = nbytes;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, k);
      if (lane >= k) incl += v;
    }
    if (lane < C) s_pre[lane + 1] = incl;
    if (lane == 0) s_pre[0] = 0;
    const uint32_t ok = __ballot_sync(0xFFFFFFFFu, lane < C && !fail);
    if (lane == 0) s_cbok = ok;
  }
  __syncthreads();
  const int nb = s_pre[C];
  if (8 * nb != tbs + 24) {  // descriptors that do not add up: no result
    if (tid == 0) p.status[t] = 0u;
    return;
  }
  const int pay = tbs >> 3;
  const int per = (nb + kThreads - 1) / kThreads;
  int j = tid * per;
  const int end = min(nb, j + per);
  uint32_t r = 0;
  if (j < end) {
    int c = 0;
    while (s_pre[c + 1] <= j) ++c;
    for (; j < end; ++j) {
      while (s_pre[c + 1] <= j) ++c;
      const int q = s_skip[c] + (j - s_pre[c]);
      const uint32_t w = static_cast<uint32_t>(
          __ldg(p.fused + s_row[c] + 1 + (q >> 2)));
      const uint32_t v = __brev((w >> ((q & 3) << 3)) & 0xFFu) >> 24;
      if (j < pay) p.out[off + j] = static_cast<unsigned char>(v);
      r = ((r << 8) & 0xFFFFFFu) ^ s_tab[((r >> 16) ^ v) & 0xFFu];
    }
    int n = nb - end;
    for (int k = 0; n; ++k, n >>= 1)
      if (n & 1) r = mulmod(r, s_tab[256 + k]);
  }
#pragma unroll
  for (int k = 16; k; k >>= 1) r ^= __shfl_xor_sync(0xFFFFFFFFu, r, k);
  if (lane == 0) s_part[warp] = r;
  __syncthreads();
  if (tid == 0) {
    uint32_t crc = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) crc ^= s_part[w];
    uint32_t st;
    if (C == 1) {
      st = 2u | (crc == 0u ? 1u : 0u);
    } else {
      st = s_cbok << 1;
      if (crc == 0u && s_cbok == (1u << C) - 1u) st |= 1u;
    }
    p.status[t] = st;
  }
}

bool aligned(const void* ptr, uintptr_t a) {
  return ptr && reinterpret_cast<uintptr_t>(ptr) % a == 0;
}

}  // namespace

extern "C" int tb_finish_threads() { return kThreads; }
extern "C" int tb_finish_max_c() { return kMaxC; }
extern "C" int tb_finish_pow_terms() { return kPowTerms; }

// fused 8-aligned, desc / tab 4-aligned, out with stat_off a multiple of
// 4 (device pointers); n_tb blocks of threads on `stream`.  Returns the
// launch's cudaError.
extern "C" int tb_finish_launch(const void* fused, const void* desc,
                                int n_tb, const void* tab, void* out,
                                long long stat_off, void* stream) {
  if (!aligned(fused, 8) || !aligned(desc, 4) || !aligned(tab, 4) ||
      !aligned(out, 1) || n_tb < 1 || stat_off < 0 || stat_off % 4 != 0 ||
      !aligned(static_cast<unsigned char*>(out) + stat_off, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.fused = static_cast<const long long*>(fused);
  p.tb = static_cast<const int*>(desc);
  p.cb = p.tb + 5LL * n_tb;
  p.tab = static_cast<const uint32_t*>(tab);
  p.out = static_cast<unsigned char*>(out);
  p.status = reinterpret_cast<uint32_t*>(p.out + stat_off);
  tb_finish_kernel<<<n_tb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
