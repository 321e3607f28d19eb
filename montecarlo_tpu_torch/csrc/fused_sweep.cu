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
// So the design keeps a chain's x, beta and accept count in registers for
// the whole segment, one thread per chain, with a loop over step pairs
// inside the thread.  Nothing is shared between threads; the CUDA block
// size does not touch the random stream.
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

struct Harmonic {
  __device__ __forceinline__ float operator()(float x) const {
    return __fmul_rn(x, x);
  }
};

// U(x) = h (x^2 - a^2)^2 / a^4, evaluated as ((h * d) * d) / a^4.
struct DoubleWell {
  float a2, h, a4;
  __device__ __forceinline__ float operator()(float x) const {
    const float d = __fsub_rn(__fmul_rn(x, x), a2);
    return __fdiv_rn(__fmul_rn(__fmul_rn(h, d), d), a4);
  }
};

template <class Potential>
__global__ void sweep_kernel(const float* __restrict__ x_in,
                             const float* __restrict__ beta_in,
                             const float* __restrict__ sigma_in,
                             float* __restrict__ x_out,
                             float* __restrict__ e_out,
                             int32_t* __restrict__ acc_out, int64_t m,
                             int64_t block_chains, uint32_t seed, int32_t t0,
                             int32_t n_steps, Potential potential) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t pid64 = i / block_chains;
  const uint32_t pid = static_cast<uint32_t>(pid64);
  const uint32_t flat = static_cast<uint32_t>(i - pid64 * block_chains);
  const uint32_t lane = flat * mc::kGolden;
  const float two_pi = static_cast<float>(6.283185307179586);
  const float sigma = *sigma_in;
  const float beta = beta_in[i];
  float x = x_in[i];
  int32_t acc = 0;

  const int32_t t_end = t0 + n_steps;
  const int32_t p0 = t0 >> 1;
  const int32_t n_pairs = n_steps > 0 ? ((t_end - 1) >> 1) - p0 + 1 : 0;
  for (int32_t j = 0; j < n_pairs; ++j) {
    const int32_t p = p0 + j;
    const uint32_t h =
        lane + hash32(seed + static_cast<uint32_t>(p)) + pid * 1000003u;
    const float u1 = uniform_from_bits(draw_bits(h, 0u));
    const float u2 = uniform_from_bits(draw_bits(h, 1u));
    const float u3 = uniform_from_bits(draw_bits(h, 2u));
    const float u4 = uniform_from_bits(draw_bits(h, 3u));
    const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
    const float theta = __fmul_rn(two_pi, u2);
    const float z1 = __fmul_rn(r, cosf(theta));
    const float z2 = __fmul_rn(r, sinf(theta));

    const bool live1 = (2 * p >= t0) && (2 * p < t_end);
    float xn = __fadd_rn(x, __fmul_rn(sigma, z1));
    bool accept = live1 && (logf(u3) < __fmul_rn(
        beta, __fsub_rn(potential(x), potential(xn))));
    x = accept ? xn : x;
    acc += accept;

    const bool live2 = 2 * p + 1 < t_end;
    xn = __fadd_rn(x, __fmul_rn(sigma, z2));
    accept = live2 && (logf(u4) < __fmul_rn(
        beta, __fsub_rn(potential(x), potential(xn))));
    x = accept ? xn : x;
    acc += accept;
  }
  x_out[i] = x;
  e_out[i] = potential(x);
  acc_out[i] = acc;
}

template <class Potential>
cudaError_t launch(const float* x, const float* beta, const float* sigma,
                   float* x_out, float* e_out, int32_t* acc_out, int64_t m,
                   int64_t block_chains, uint32_t seed, int32_t t0,
                   int32_t n_steps, Potential potential, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  sweep_kernel<Potential><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(x, beta, sigma, x_out, e_out, acc_out, m,
                                      block_chains, seed, t0, n_steps,
                                      potential);
  return cudaGetLastError();
}

}  // namespace

// potential_kind: 0 = harmonic, 1 = double well with (a^2, h, a^4).
// Returns the launch's cudaError_t (0 on success).  Does not synchronise.
extern "C" int mc_fused_gaussian_sweep(
    const float* x, const float* beta, const float* sigma, float* x_out,
    float* e_out, int32_t* acc_out, int64_t m, int64_t block_chains,
    uint32_t seed, int32_t t0, int32_t n_steps, int potential_kind, float a2,
    float h, float a4, void* stream) {
  if (m <= 0 || block_chains <= 0 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (potential_kind) {
    case 0:
      return static_cast<int>(launch(x, beta, sigma, x_out, e_out, acc_out, m,
                                     block_chains, seed, t0, n_steps,
                                     Harmonic{}, s));
    case 1:
      return static_cast<int>(launch(x, beta, sigma, x_out, e_out, acc_out, m,
                                     block_chains, seed, t0, n_steps,
                                     DoubleWell{a2, h, a4}, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
