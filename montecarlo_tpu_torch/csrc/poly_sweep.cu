// Fused Metropolis sweep of 2-D polydisperse soft-sphere chains: the
// displacement + diameter-swap pool of swap Monte Carlo.
//
// Replaces montecarlo_tpu/ops/poly_sweep.py:_poly_kernel (entry point
// mc_poly_mixed_sweep, behind fused_poly_mixed_sweep).  Each launch runs
// n_steps attempts on every chain and returns the positions, the diameters,
// the incrementally updated energy and the accept and attempt counts per
// move kind.
//
// What bounds it on Hopper: O(N) float32 work per step and chain, not bytes.
// A displacement evaluates two rows of N pair terms, a swap four; each term
// is a minimum image, the non-additive cross diameter, two exact
// reciprocals and ~20 flops.  The chain's state (12 bytes per particle: x,
// y, diameter) is read from device memory once per segment and written
// once.  The steps of a chain are sequential, so what a launch takes is the
// latency of one step times the steps: the design shortens the step, as
// lj_sweep.cu's does.
//
// One block of W warps serves one chain (W from N alone,
// ops/poly_sweep.py: poly_block_warps), the chain's particles in shared
// memory for the whole segment.
//   - Rows: thread t sums the pair terms of slots t, t + 32 W, ..., a
//     5-level butterfly closes each warp, the W warp sums go through shared
//     memory and every thread adds them in warp order (particle_rows.cuh:
//     block_row_energies).  One barrier a step.
//   - Every draw ahead of the loop: the kind, a displacement's pick,
//     r cos, r sin and log u, and a swap's i, j and log u depend on (seed,
//     step, chain) only, never on the state, so the block computes them for
//     kBatch steps at once, one step a thread, into shared memory.  The
//     serial loop runs no hash and no logf, sinf or cosf.
//   - An accepted move is written by thread 0 and followed by a barrier; a
//     rejected one changes nothing and needs none.  The reduction scratch
//     alternates between two buffers by the step's parity, so a thread that
//     runs ahead into the next step never writes what a slower one still
//     reads (every step has its row barrier).
// Every thread computes the accept test itself from the same values, so all
// branches around barriers are uniform.
//
// The random stream and the arithmetic are the plain version's
// (montecarlo_tpu_torch/ops/poly_sweep.py), which follows the reference:
//   - per-step seed hash32(seed + t0 + k) + pid * 1000003, with pid and the
//     row r the chain's block and row in the reference's Pallas grid of
//     block_chains chains (not this kernel's CUDA blocks);
//   - displacement when
//     float(hash32(step_seed ^ 0x7AB1E5) & 0x7FFFFFFF) * 2^-31 < w_disp;
//   - displacement draws: software_bits(step_seed, 0, (bc, 128)) at
//     flat = r * 128 + c, c = 0..3 (pick, radius, angle, accept);
//   - swap draws: software_bits(step_seed ^ 0x51AB, 0, (bc, 128)) at
//     flat = r * 128 + c, c = 0..2: i = min(int(u0 * N), N - 1), then j over
//     the other N - 1 slots, j' = min(int(u1 * (N - 1)), N - 2),
//     j = j' + (j' >= i), and the accept draw;
//   - swap dE = row(x_i, d_j) + row(x_j, d_i) - row(x_i, d_i) - row(x_j, d_j),
//     each row leaving out i and j (the i-j term is symmetric in the
//     exchange and cancels), so the stale diameters of i and j are never
//     read;
//   - row sums in the thread order: thread-strided partial sums, the
//     butterfly in each warp, then the warp sums in turn, which the plain
//     version writes out, so the two agree bit for bit on the card.
// The pair energy follows the reference term by term with _rn intrinsics
// and the exact __frcp_rn; logf, sinf, cosf are the precise ones (no fast
// math).

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "particle_rows.cuh"

namespace {

using mc::draw_bits;
using mc::hash32;
using mc::kGolden;
using mc::kWarp;
using mc::block_row_energies;
using mc::uniform_from_bits;
using mc::wrap;

constexpr uint32_t kLanes = 128u;        // columns of the reference's draw
constexpr uint32_t kStepPrime = 1000003u;
constexpr uint32_t kSwapTag = 0x51ABu;
constexpr uint32_t kKindTag = 0x7AB1E5u;

// C2-smoothed inverse-power-law 12 with the non-additive cross diameter
// sigma_ij = (d_i + d_j) / 2 * (1 - eps |d_i - d_j|), in units
// x2 = r^2 / sigma_ij^2: u = x^-12 + c0 + c2 x^2 + c4 x^4 below x_c^2, else
// 0 (the reference's row_energy, poly_sweep.py:48-61).
struct PolyIPL12 {
  float eps, xc2, c0, c2, c4;

  // Table entries 3..7 of the scalar table.
  __device__ static PolyIPL12 load(const float* t) {
    return PolyIPL12{t[0], t[1], t[2], t[3], t[4]};
  }

  __device__ __forceinline__ float operator()(float r2, float d_i,
                                              float d_j) const {
    const float sig =
        __fmul_rn(__fmul_rn(0.5f, __fadd_rn(d_i, d_j)),
                  __fsub_rn(1.0f, __fmul_rn(eps, fabsf(__fsub_rn(d_i, d_j)))));
    const float x2 = __fmul_rn(r2, __frcp_rn(fmaxf(__fmul_rn(sig, sig), 1e-12f)));
    const float inv2 = __frcp_rn(fmaxf(x2, 1e-12f));
    const float i6 = __fmul_rn(__fmul_rn(inv2, inv2), inv2);
    const float u = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(i6, i6), c0), __fmul_rn(c2, x2)),
        __fmul_rn(__fmul_rn(c4, x2), x2));
    return x2 < xc2 ? u : 0.0f;
  }
};

constexpr int kBatch = 128;     // steps whose draws are made at once
constexpr int kMaxWarps = 16;   // of a block: leaves a thread 128 registers
// shared memory besides the particles, in 4-byte words: two buffers of row
// sums (4 rows a warp) and the batch's five draws a step; the same 3 KB as
// the LJ block's scratch (ops/lj_sweep.py: MAX_PARTICLES)
constexpr int kRedWords = kMaxWarps * 4;
constexpr int kScratchWords = 2 * kRedWords + 5 * kBatch;
static_assert(kScratchWords * 4 == 3072, "MAX_PARTICLES assumes 3 KB");

// One block of blockDim.x / 32 warps per chain.
__global__ void __launch_bounds__(kMaxWarps * kWarp) poly_sweep_kernel(
    const float* __restrict__ pos, const float* __restrict__ diam,
    const float* __restrict__ beta_in, const float* __restrict__ energy_in,
    const float* __restrict__ scalars, float* __restrict__ pos_out,
    float* __restrict__ diam_out, float* __restrict__ energy_out,
    int32_t* __restrict__ acc_out, int32_t* __restrict__ tot_out, int n,
    int64_t block_chains, uint32_t seed, int32_t t0, int32_t n_steps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int64_t chain = blockIdx.x;
  float* xs = smem;
  float* ys = xs + n;
  float* ds = ys + n;
  float* red = ds + n;                      // [2][kRedWords]
  int* b_i = reinterpret_cast<int*>(red + 2 * kRedWords);   // [kBatch]
  int* b_j = b_i + kBatch;                  // -1 marks a displacement
  float* b_dx = reinterpret_cast<float*>(b_j + kBatch);
  float* b_dy = b_dx + kBatch;
  float* b_log = b_dy + kBatch;

  const int64_t pid64 = chain / block_chains;
  const uint32_t pid = static_cast<uint32_t>(pid64);
  const uint32_t row = static_cast<uint32_t>(chain - pid64 * block_chains);
  const float sigma = scalars[0];
  const float box = scalars[1];
  const float inv_box = scalars[2];
  const PolyIPL12 pair = PolyIPL12::load(scalars + 3);
  const float w_disp = scalars[8];
  const float two_pi = static_cast<float>(6.283185307179586);
  const float fn = static_cast<float>(n);
  const float fn1 = static_cast<float>(n - 1);

  const float* p_in = pos + chain * 2 * n;
  for (int j = tid; j < n; j += threads) {
    xs[j] = p_in[2 * j];
    ys[j] = p_in[2 * j + 1];
    ds[j] = diam[chain * n + j];
  }
  const float neg_beta = -beta_in[chain];
  float e = energy_in[chain];
  int32_t acc_d = 0, acc_s = 0, tot_d = 0, tot_s = 0;
  const uint32_t lane0 = row * kLanes * kGolden;   // flat = r * 128
  const uint32_t seed_t0 = seed + static_cast<uint32_t>(t0);

  for (int32_t k0 = 0; k0 < n_steps; k0 += kBatch) {
    const int32_t batch = min(kBatch, n_steps - k0);
    // the batch's draws, none of which reads the state, one step a thread
    for (int32_t s = tid; s < batch; s += threads) {
      const uint32_t step_seed =
          hash32(seed_t0 + static_cast<uint32_t>(k0 + s)) + pid * kStepPrime;
      const uint32_t kind_bits = hash32(step_seed ^ kKindTag) & 0x7FFFFFFFu;
      const float u_kind =
          __fmul_rn(__int2float_rn(static_cast<int>(kind_bits)), 0x1p-31f);
      if (u_kind < w_disp) {
        const uint32_t h = lane0 + step_seed;
        const float u_pick = uniform_from_bits(draw_bits(h, 0u));
        const float u1 = uniform_from_bits(draw_bits(h + kGolden, 0u));
        const float u2 = uniform_from_bits(draw_bits(h + 2u * kGolden, 0u));
        const float u_acc = uniform_from_bits(draw_bits(h + 3u * kGolden, 0u));
        const float r =
            __fmul_rn(sigma, __fsqrt_rn(__fmul_rn(-2.0f, logf(u1))));
        const float theta = __fmul_rn(two_pi, u2);
        b_i[s] = min(static_cast<int>(__fmul_rn(u_pick, fn)), n - 1);
        b_j[s] = -1;
        b_dx[s] = __fmul_rn(r, cosf(theta));
        b_dy[s] = __fmul_rn(r, sinf(theta));
        b_log[s] = logf(u_acc);
      } else {
        const uint32_t h = lane0 + (step_seed ^ kSwapTag);
        const float u_i = uniform_from_bits(draw_bits(h, 0u));
        const float u_j = uniform_from_bits(draw_bits(h + kGolden, 0u));
        const float u_acc = uniform_from_bits(draw_bits(h + 2u * kGolden, 0u));
        const int i = min(static_cast<int>(__fmul_rn(u_i, fn)), n - 1);
        const int j_raw = min(static_cast<int>(__fmul_rn(u_j, fn1)), n - 2);
        b_i[s] = i;
        b_j[s] = j_raw + (j_raw >= i ? 1 : 0);
        b_log[s] = logf(u_acc);
      }
    }
    // the batch, and before the first one the particles, are in place; every
    // thread has read the last batch's draws (it passed its last step's
    // row barrier)
    __syncthreads();

    for (int32_t s = 0; s < batch; ++s) {
      const int i = b_i[s];
      const int j = b_j[s];
      const float log_u = b_log[s];
      float* red_k = red + ((k0 + s) & 1) * kRedWords;
      const float xi = xs[i];
      const float yi = ys[i];
      const float di = ds[i];
      if (j < 0) {
        const float xn = __fadd_rn(xi, b_dx[s]);
        const float yn = __fadd_rn(yi, b_dy[s]);
        const float px[2] = {xi, xn};
        const float py[2] = {yi, yn};
        const float pa[2] = {di, di};
        float rows[2];
        block_row_energies<2>(pair, xs, ys, ds, n, px, py, pa, i, i, box,
                              inv_box, red_k, rows);
        const float d_e = __fsub_rn(rows[1], rows[0]);
        if (log_u < __fmul_rn(neg_beta, d_e)) {
          if (tid == 0) {
            xs[i] = wrap(xn, box, inv_box);
            ys[i] = wrap(yn, box, inv_box);
          }
          e = __fadd_rn(e, d_e);
          ++acc_d;
          __syncthreads();
        }
        ++tot_d;
      } else {
        const float xj = xs[j], yj = ys[j], dj = ds[j];
        // rows: i as itself, i with d_j, j as itself, j with d_i
        const float px[4] = {xi, xi, xj, xj};
        const float py[4] = {yi, yi, yj, yj};
        const float pa[4] = {di, dj, dj, di};
        float rows[4];
        block_row_energies<4>(pair, xs, ys, ds, n, px, py, pa, i, j, box,
                              inv_box, red_k, rows);
        const float e_old = __fadd_rn(rows[0], rows[2]);
        const float e_new = __fadd_rn(rows[1], rows[3]);
        const float d_e = __fsub_rn(e_new, e_old);
        if (log_u < __fmul_rn(neg_beta, d_e)) {
          if (tid == 0) {
            ds[i] = dj;
            ds[j] = di;
          }
          e = __fadd_rn(e, d_e);
          ++acc_s;
          __syncthreads();
        }
        ++tot_s;
      }
    }
  }
  __syncthreads();

  float* p_out = pos_out + chain * 2 * n;
  for (int j = tid; j < n; j += threads) {
    p_out[2 * j] = xs[j];
    p_out[2 * j + 1] = ys[j];
    diam_out[chain * n + j] = ds[j];
  }
  if (tid == 0) {
    energy_out[chain] = e;
    acc_out[2 * chain] = acc_d;
    acc_out[2 * chain + 1] = acc_s;
    tot_out[2 * chain] = tot_d;
    tot_out[2 * chain + 1] = tot_s;
  }
}

}  // namespace

// Displacement + diameter-swap pool (the reference's _poly_kernel).
// scalars: the reference's 9-float table (sigma, box, 1/box, eps, x_c^2, c0,
// c2, c4, w_disp).  Inputs pos (M, N, 2), diam (M, N), beta and energy
// (M,); outputs pos_out, diam_out, energy_out of the same shapes and
// acc_out, tot_out (M, 2): column 0 displacement, column 1 swap.  warps: the
// warps W of the block that serves a chain, 1 to 16; the row sums' order
// depends on it.  Needs N >= 2 (a swap needs two particles).  Returns the
// launch's cudaError_t (0 on success).  Does not synchronise.
extern "C" int mc_poly_mixed_sweep(const float* pos, const float* diam,
                                   const float* beta, const float* energy,
                                   const float* scalars, float* pos_out,
                                   float* diam_out, float* energy_out,
                                   int32_t* acc_out, int32_t* tot_out,
                                   int64_t m, int n, int warps,
                                   int64_t block_chains, uint32_t seed,
                                   int32_t t0, int32_t n_steps, void* stream) {
  if (m <= 0 || m > INT32_MAX || n < 2 || warps < 1 || warps > kMaxWarps ||
      block_chains <= 0 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the chain's x, y and diameters, and the block's scratch
  const size_t smem =
      (3 * static_cast<size_t>(n) + kScratchWords) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(poly_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  poly_sweep_kernel<<<static_cast<unsigned>(m), warps * kWarp, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pos, diam, beta, energy, scalars, pos_out, diam_out, energy_out, acc_out,
      tot_out, n, block_chains, seed, t0, n_steps);
  return static_cast<int>(cudaGetLastError());
}
