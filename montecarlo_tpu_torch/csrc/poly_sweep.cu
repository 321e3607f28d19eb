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
// once.  So the design is lj_sweep.cu's: one warp per chain with its
// particles in shared memory for the whole segment, lane-strided row sums
// closed by a warp butterfly (particle_rows.cuh), every lane computing the
// step's draws and accept test itself (equal in all lanes, so the warp never
// diverges), and lane 0 writing the slots an accepted move changes.
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
//   - row sums in the lane order, which the plain version writes out, so
//     the two agree bit for bit on the card.
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
using mc::row_energies;
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

// One block of one warp per chain.
__global__ void poly_sweep_kernel(
    const float* __restrict__ pos, const float* __restrict__ diam,
    const float* __restrict__ beta_in, const float* __restrict__ energy_in,
    const float* __restrict__ scalars, float* __restrict__ pos_out,
    float* __restrict__ diam_out, float* __restrict__ energy_out,
    int32_t* __restrict__ acc_out, int32_t* __restrict__ tot_out, int n,
    int64_t block_chains, uint32_t seed, int32_t t0, int32_t n_steps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int64_t chain = blockIdx.x;
  float* xs = smem;
  float* ys = xs + n;
  float* ds = ys + n;

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
  for (int j = lane; j < n; j += kWarp) {
    xs[j] = p_in[2 * j];
    ys[j] = p_in[2 * j + 1];
    ds[j] = diam[chain * n + j];
  }
  __syncwarp();
  const float neg_beta = -beta_in[chain];
  float e = energy_in[chain];
  int32_t acc_d = 0, acc_s = 0, tot_d = 0, tot_s = 0;
  const uint32_t lane0 = row * kLanes * kGolden;   // flat = r * 128

  for (int32_t k = 0; k < n_steps; ++k) {
    const uint32_t step_seed =
        hash32(seed + static_cast<uint32_t>(t0) + static_cast<uint32_t>(k)) +
        pid * kStepPrime;
    const uint32_t kind_bits = hash32(step_seed ^ kKindTag) & 0x7FFFFFFFu;
    const float u_kind =
        __fmul_rn(__int2float_rn(static_cast<int>(kind_bits)), 0x1p-31f);
    if (u_kind < w_disp) {
      const uint32_t h = lane0 + step_seed;
      const float u_pick = uniform_from_bits(draw_bits(h, 0u));
      const float u1 = uniform_from_bits(draw_bits(h + kGolden, 0u));
      const float u2 = uniform_from_bits(draw_bits(h + 2u * kGolden, 0u));
      const float u_acc = uniform_from_bits(draw_bits(h + 3u * kGolden, 0u));
      const int i = min(static_cast<int>(__fmul_rn(u_pick, fn)), n - 1);
      const float xi = xs[i];
      const float yi = ys[i];
      const float di = ds[i];
      const float r = __fmul_rn(sigma, __fsqrt_rn(__fmul_rn(-2.0f, logf(u1))));
      const float theta = __fmul_rn(two_pi, u2);
      const float xn = __fadd_rn(xi, __fmul_rn(r, cosf(theta)));
      const float yn = __fadd_rn(yi, __fmul_rn(r, sinf(theta)));
      const float px[2] = {xi, xn};
      const float py[2] = {yi, yn};
      const float pa[2] = {di, di};
      float rows[2];
      row_energies<2>(pair, xs, ys, ds, n, lane, px, py, pa, i, i, box,
                      inv_box, rows);
      const float d_e = __fsub_rn(rows[1], rows[0]);
      if (logf(u_acc) < __fmul_rn(neg_beta, d_e)) {
        if (lane == 0) {
          xs[i] = wrap(xn, box, inv_box);
          ys[i] = wrap(yn, box, inv_box);
        }
        e = __fadd_rn(e, d_e);
        ++acc_d;
      }
      ++tot_d;
    } else {
      const uint32_t h = lane0 + (step_seed ^ kSwapTag);
      const float u_i = uniform_from_bits(draw_bits(h, 0u));
      const float u_j = uniform_from_bits(draw_bits(h + kGolden, 0u));
      const float u_acc = uniform_from_bits(draw_bits(h + 2u * kGolden, 0u));
      const int i = min(static_cast<int>(__fmul_rn(u_i, fn)), n - 1);
      const int j_raw = min(static_cast<int>(__fmul_rn(u_j, fn1)), n - 2);
      const int j = j_raw + (j_raw >= i ? 1 : 0);
      const float xi = xs[i], yi = ys[i], di = ds[i];
      const float xj = xs[j], yj = ys[j], dj = ds[j];
      // rows: i as itself, i with d_j, j as itself, j with d_i
      const float px[4] = {xi, xi, xj, xj};
      const float py[4] = {yi, yi, yj, yj};
      const float pa[4] = {di, dj, dj, di};
      float rows[4];
      row_energies<4>(pair, xs, ys, ds, n, lane, px, py, pa, i, j, box,
                      inv_box, rows);
      const float e_old = __fadd_rn(rows[0], rows[2]);
      const float e_new = __fadd_rn(rows[1], rows[3]);
      const float d_e = __fsub_rn(e_new, e_old);
      if (logf(u_acc) < __fmul_rn(neg_beta, d_e)) {
        if (lane == 0) {
          ds[i] = dj;
          ds[j] = di;
        }
        e = __fadd_rn(e, d_e);
        ++acc_s;
      }
      ++tot_s;
    }
    __syncwarp();
  }

  float* p_out = pos_out + chain * 2 * n;
  for (int j = lane; j < n; j += kWarp) {
    p_out[2 * j] = xs[j];
    p_out[2 * j + 1] = ys[j];
    diam_out[chain * n + j] = ds[j];
  }
  if (lane == 0) {
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
// acc_out, tot_out (M, 2): column 0 displacement, column 1 swap.  Needs
// N >= 2 (a swap needs two particles).  Returns the launch's cudaError_t
// (0 on success).  Does not synchronise.
extern "C" int mc_poly_mixed_sweep(const float* pos, const float* diam,
                                   const float* beta, const float* energy,
                                   const float* scalars, float* pos_out,
                                   float* diam_out, float* energy_out,
                                   int32_t* acc_out, int32_t* tot_out,
                                   int64_t m, int n, int64_t block_chains,
                                   uint32_t seed, int32_t t0, int32_t n_steps,
                                   void* stream) {
  if (m <= 0 || m > INT32_MAX || n < 2 || block_chains <= 0 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the chain's x, y and diameters
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(poly_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  poly_sweep_kernel<<<static_cast<unsigned>(m), kWarp, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pos, diam, beta, energy, scalars, pos_out, diam_out, energy_out, acc_out,
      tot_out, n, block_chains, seed, t0, n_steps);
  return static_cast<int>(cudaGetLastError());
}
