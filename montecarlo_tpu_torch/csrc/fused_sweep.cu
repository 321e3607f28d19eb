// Fused Metropolis sweep of a Gaussian displacement move over M 1-D chains.
//
// Replaces montecarlo_tpu/ops/fused_sweep.py:_sweep_kernel (the Pallas
// kernel behind fused_gaussian_sweep).  It runs n_steps Metropolis steps per
// chain in one launch and returns x', e' = U(x') and the per-chain accept
// count.
//
// What bounds it on Hopper: integer and transcendental ALU work per step
// (two murmur finalizer rounds per uniform, four uniforms, log/sin/cos/sqrt
// per pair of steps), not bytes: each chain reads 8 bytes (x, beta) and
// writes 12 (x', e', acc) per segment, however many steps the segment has.
// With one thread per chain, 10^4 chains are 313 warps on 132 SMs, and each
// thread runs one long dependent chain of hashes and transcendentals that
// nothing hides.
//
// The design splits a pair of steps in two.  The noise of pair p (the two
// displacements sigma*z1, sigma*z2 and the two log-uniforms of the accept
// tests) depends on (seed, p, chain) only, not on x: about nine tenths of
// the work.  The accept steps depend on x and are sequential.  So a group
// of T lanes of one warp serves one chain: in each round lane k computes
// the noise of pair p0 + round*T + k, then every lane of the group walks
// the T pairs in order, taking pair s's four values from lane s by
// __shfl_sync and applying the two accept steps (all lanes alike, so the
// warp never diverges and every lane holds the chain's x).  The threads in
// flight grow T-fold; the work per pair grows by the walk, ~20 operations
// times T.  T is a power of two in 1..32 that the wrapper picks from the
// number of chains and the card's size (ops/fused_sweep.py: group_lanes);
// at T = 1 there is no shuffle and the loop is the one-thread-per-chain
// loop.  A dead half-step (the segment starts or ends mid-pair, or the
// round's tail lies beyond the segment) carries +inf as its log-uniform,
// which no accept test passes.  U(x) is carried beside x where it costs a
// division, and evaluated again where it is one multiply.
// The CUDA block size and T do not touch the random stream or the order of
// a chain's steps, so every T gives the same bits.
//
// The random stream is the reference's counter hash (software_bits), so the
// kernel reproduces montecarlo_tpu_torch.ops.fused_sweep's plain version:
//   - two steps per pair p from one Box-Muller draw (u1..u4);
//   - pairs aligned to absolute micro-steps (2p, 2p+1), the first half
//     masked when the segment starts mid-pair (segmentation invariance);
//   - per-pair seed hash32(seed + p) + pid * 1000003, with the chain's
//     flat = index within its block of block_chains chains and pid = block
//     index (the reference's (block_rows, 128) Pallas blocks).
// Float arithmetic uses the _rn intrinsics so that nvcc does not contract
// a*b+c into an FMA the plain version does not make, and precise
// logf/sinf/cosf (no fast math).

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"

namespace {

using mc::draw_bits;
using mc::hash32;
using mc::uniform_from_bits;

// kCarry: whether the sweep carries U(x) beside x (worth a select a step
// where U costs a division) or evaluates it again (one multiply).
struct Harmonic {
  static constexpr bool kCarry = false;
  __device__ __forceinline__ float operator()(float x) const {
    return __fmul_rn(x, x);
  }
};

// U(x) = h (x^2 - a^2)^2 / a^4, evaluated as ((h * d) * d) / a^4.
struct DoubleWell {
  static constexpr bool kCarry = true;
  float a2, h, a4;
  __device__ __forceinline__ float operator()(float x) const {
    const float d = __fsub_rn(__fmul_rn(x, x), a2);
    return __fdiv_rn(__fmul_rn(__fmul_rn(h, d), d), a4);
  }
};

constexpr int kThreads = 256;

template <class Potential, int T>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ x_in,
                 const float* __restrict__ beta_in,
                 const float* __restrict__ sigma_in, float* __restrict__ x_out,
                 float* __restrict__ e_out, int32_t* __restrict__ acc_out,
                 int64_t m, int64_t block_chains, uint32_t seed, int32_t t0,
                 int32_t n_steps, Potential potential) {
  static_assert(T >= 1 && T <= 32 && (T & (T - 1)) == 0, "T: 1, 2, ..., 32");
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t chain = gid / T;
  const int k = static_cast<int>(threadIdx.x) % T;   // lane within the group
  const bool owns = chain < m;
  if (T == 1 && !owns) return;
  // a group beyond the last chain repeats the last chain and stores nothing:
  // its lanes share a warp with live groups and must reach the shuffles
  const int64_t i = owns ? chain : m - 1;
  const int64_t pid64 = i / block_chains;
  const uint32_t pid = static_cast<uint32_t>(pid64);
  const uint32_t flat = static_cast<uint32_t>(i - pid64 * block_chains);
  const uint32_t lane = flat * mc::kGolden + pid * 1000003u;
  const float two_pi = static_cast<float>(6.283185307179586);
  const float inf = __int_as_float(0x7F800000);
  const float sigma = *sigma_in;
  const float beta = beta_in[i];
  float x = x_in[i];
  float e = potential(x);
  int32_t acc = 0;

  const int32_t t_end = t0 + n_steps;
  const int32_t p0 = t0 >> 1;
  const int32_t p_end = n_steps > 0 ? ((t_end - 1) >> 1) + 1 : p0;
  for (int32_t p_round = p0; p_round < p_end; p_round += T) {
    // the noise of pair p_round + k, this lane's share of the round; a
    // lane beyond the last pair makes noise that no step uses
    const int32_t p = p_round + k;
    const bool in = T == 1 || p < p_end;
    const uint32_t h = lane + hash32(seed + static_cast<uint32_t>(p));
    const float u1 = uniform_from_bits(draw_bits(h, 0u));
    const float u2 = uniform_from_bits(draw_bits(h, 1u));
    const float u3 = uniform_from_bits(draw_bits(h, 2u));
    const float u4 = uniform_from_bits(draw_bits(h, 3u));
    const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
    const float theta = __fmul_rn(two_pi, u2);
    const float d1 = __fmul_rn(sigma, __fmul_rn(r, cosf(theta)));
    const float d2 = __fmul_rn(sigma, __fmul_rn(r, sinf(theta)));
    const bool live1 = in && (2 * p >= t0) && (2 * p < t_end);
    const bool live2 = in && (2 * p + 1 < t_end);
    // log u <= 0 is finite, so adding 0 keeps its bits and adding +inf
    // gives +inf, without a branch around logf; one lane per chain keeps
    // its own flags instead
    const float l1 =
        T == 1 ? logf(u3) : __fadd_rn(logf(u3), live1 ? 0.0f : inf);
    const float l2 =
        T == 1 ? logf(u4) : __fadd_rn(logf(u4), live2 ? 0.0f : inf);

    // the T pairs of the round in order, each from the lane that made it
#pragma unroll
    for (int s = 0; s < T; ++s) {
      const float sd1 = T == 1 ? d1 : __shfl_sync(0xFFFFFFFFu, d1, s, T);
      const float sl1 = T == 1 ? l1 : __shfl_sync(0xFFFFFFFFu, l1, s, T);
      const float sd2 = T == 1 ? d2 : __shfl_sync(0xFFFFFFFFu, d2, s, T);
      const float sl2 = T == 1 ? l2 : __shfl_sync(0xFFFFFFFFu, l2, s, T);

      float xn = __fadd_rn(x, sd1);
      float en = potential(xn);
      if (!Potential::kCarry) e = potential(x);
      bool accept = (T > 1 || live1) &&
                    sl1 < __fmul_rn(beta, __fsub_rn(e, en));
      x = accept ? xn : x;
      if (Potential::kCarry) e = accept ? en : e;
      acc += accept;

      xn = __fadd_rn(x, sd2);
      en = potential(xn);
      if (!Potential::kCarry) e = potential(x);
      accept = (T > 1 || live2) && sl2 < __fmul_rn(beta, __fsub_rn(e, en));
      x = accept ? xn : x;
      if (Potential::kCarry) e = accept ? en : e;
      acc += accept;
    }
  }
  if (owns && k == 0) {
    x_out[i] = x;
    e_out[i] = Potential::kCarry ? e : potential(x);
    acc_out[i] = acc;
  }
}

template <class Potential, int T>
cudaError_t launch_t(const float* x, const float* beta, const float* sigma,
                     float* x_out, float* e_out, int32_t* acc_out, int64_t m,
                     int64_t block_chains, uint32_t seed, int32_t t0,
                     int32_t n_steps, Potential potential,
                     cudaStream_t stream) {
  const int64_t blocks = (m * T + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  sweep_kernel<Potential, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(x, beta, sigma, x_out, e_out, acc_out,
                                         m, block_chains, seed, t0, n_steps,
                                         potential);
  return cudaGetLastError();
}

template <class Potential>
cudaError_t launch(const float* x, const float* beta, const float* sigma,
                   float* x_out, float* e_out, int32_t* acc_out, int64_t m,
                   int64_t block_chains, uint32_t seed, int32_t t0,
                   int32_t n_steps, int lanes, Potential potential,
                   cudaStream_t stream) {
#define MC_SWEEP_CASE(T)                                                      \
  case T:                                                                     \
    return launch_t<Potential, T>(x, beta, sigma, x_out, e_out, acc_out, m,   \
                                  block_chains, seed, t0, n_steps, potential, \
                                  stream);
  switch (lanes) {
    MC_SWEEP_CASE(1)
    MC_SWEEP_CASE(2)
    MC_SWEEP_CASE(4)
    MC_SWEEP_CASE(8)
    MC_SWEEP_CASE(16)
    MC_SWEEP_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef MC_SWEEP_CASE
}

}  // namespace

// potential_kind: 0 = harmonic, 1 = double well with (a^2, h, a^4).  lanes:
// the lanes T of a warp that serve one chain, a power of two in 1..32.
// Returns the launch's cudaError_t (0 on success).  Does not synchronise.
extern "C" int mc_fused_gaussian_sweep(
    const float* x, const float* beta, const float* sigma, float* x_out,
    float* e_out, int32_t* acc_out, int64_t m, int64_t block_chains,
    uint32_t seed, int32_t t0, int32_t n_steps, int lanes, int potential_kind,
    float a2, float h, float a4, void* stream) {
  if (m <= 0 || block_chains <= 0 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (potential_kind) {
    case 0:
      return static_cast<int>(launch(x, beta, sigma, x_out, e_out, acc_out, m,
                                     block_chains, seed, t0, n_steps, lanes,
                                     Harmonic{}, s));
    case 1:
      return static_cast<int>(launch(x, beta, sigma, x_out, e_out, acc_out, m,
                                     block_chains, seed, t0, n_steps, lanes,
                                     DoubleWell{a2, h, a4}, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
