// One trellis step of the 8-state max-log BCJR recurrence of the LTE turbo
// code, shared by the per-pass kernel (bcjr.cu) and the fused whole-decode
// kernel (turbo_decode.cu), so that both take the trellis from one table and
// form every sum in one order: the order of the plain twin
// (kernels/bcjr.py:bcjr_plain) and of the tail recursion
// (kernels/turbo.py:_beta_init_from_tail).  Build with --fmad=false, so that
// no multiply and add are contracted and the card's bits equal the host's.
#pragma once

// Forward: new state n is reached from predecessors P0[n] (input bit
// x0) and P1[n] (input x1); C0/C1 index the branch metric
// g[c] for c = 2*x + parity: {a+b, a-b, b-a, -(a+b)}.
// Backward: state s moves to N0[s] on input 0 (metric CB0[s]) and to
// N1[s] on input 1 (metric CB1[s]).  Derived from phy/turbo.py
// rsc_tables(); tests/test_torch_turbo.py checks them against it.
#define BCJR_FWD_TABLES                                              \
  const int P0[8] = {0, 2, 4, 6, 0, 2, 4, 6};                        \
  const int C0[8] = {0, 2, 1, 3, 3, 1, 2, 0};                        \
  const int P1[8] = {1, 3, 5, 7, 1, 3, 5, 7};                        \
  const int C1[8] = {3, 1, 2, 0, 0, 2, 1, 3};
#define BCJR_BWD_TABLES                                              \
  const int N0[8] = {0, 4, 5, 1, 2, 6, 7, 3};                        \
  const int CB0[8] = {0, 0, 1, 1, 1, 1, 0, 0};                       \
  const int N1[8] = {4, 0, 1, 5, 6, 2, 3, 7};                        \
  const int CB1[8] = {3, 3, 2, 2, 2, 2, 3, 3};

#define BCJR_NEG (-1e9f)

// alpha <- alpha_{k+1}, from alpha_k and step k's inputs, normalised to
// state 0.
__device__ __forceinline__ void bcjr_alpha_step(float alpha[8], float apr,
                                                float sys, float par) {
  BCJR_FWD_TABLES
  const float a = 0.5f * (apr + sys);
  const float b = 0.5f * par;
  const float g[4] = {a + b, a - b, b - a, -(a + b)};
  float an[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float c0 = alpha[P0[n]] + g[C0[n]];
    const float c1 = alpha[P1[n]] + g[C1[n]];
    an[n] = fmaxf(c0, c1);
  }
  const float ref = an[0];
#pragma unroll
  for (int n = 0; n < 8; ++n) alpha[n] = an[n] - ref;
}

// beta <- beta_k from beta_{k+1}, fused with step k's extrinsic output
// (returned): llr - (apr + sys), with alpha_k from the forward sweep.
__device__ __forceinline__ float bcjr_beta_step(float beta[8],
                                                const float alpha_k[8],
                                                float apr, float sys,
                                                float par) {
  BCJR_BWD_TABLES
  const float l_in = apr + sys;
  const float a = 0.5f * l_in;
  const float b = 0.5f * par;
  const float g[4] = {a + b, a - b, b - a, -(a + b)};
  float f0[8], f1[8], bn[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float t0 = g[CB0[s]] + beta[N0[s]];
    const float t1 = g[CB1[s]] + beta[N1[s]];
    f0[s] = alpha_k[s] + t0;
    f1[s] = alpha_k[s] + t1;
    bn[s] = fmaxf(t0, t1);
  }
  const float ref = bn[0];
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = bn[s] - ref;
  // max over the states as a tree (depth 3): fmax is exact, so the order
  // does not change the result
  const float m0 = fmaxf(fmaxf(fmaxf(f0[0], f0[1]), fmaxf(f0[2], f0[3])),
                         fmaxf(fmaxf(f0[4], f0[5]), fmaxf(f0[6], f0[7])));
  const float m1 = fmaxf(fmaxf(fmaxf(f1[0], f1[1]), fmaxf(f1[2], f1[3])),
                         fmaxf(fmaxf(f1[4], f1[5]), fmaxf(f1[6], f1[7])));
  return (m0 - m1) - l_in;
}

// One step of the termination tail, walked backward from beta = {0, NEG..}:
// beta_k(s) = max_x gamma_k(s, x) + beta_{k+1}(next(s, x)), not normalised,
// with gamma = 0.5 * (+-sys +- par) as kernels/turbo.py forms it.
__device__ __forceinline__ void bcjr_tail_step(float beta[8], float sys,
                                               float par) {
  BCJR_BWD_TABLES
  const float h[4] = {0.5f * (sys + par), 0.5f * (sys - par),
                      0.5f * (par - sys), -(0.5f * (sys + par))};
  float bn[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    bn[s] = fmaxf(h[CB0[s]] + beta[N0[s]], h[CB1[s]] + beta[N1[s]]);
#pragma unroll
  for (int s = 0; s < 8; ++s) beta[s] = bn[s];
}
