// Fused Metropolis sweeps of 2-D Lennard-Jones chains: a pool of one
// particle displacement move, or the displacement + species-swap pool.
//
// Replaces montecarlo_tpu/ops/lj_sweep.py:_kernel (entry point
// mc_lj_sweep, behind fused_lj_sweep) and lj_sweep.py:_mixed_kernel (entry
// point mc_lj_mixed_sweep, behind fused_lj_mixed_sweep).  Each launch runs
// n_steps attempts on every chain and returns the positions, the species
// (mixed pool), the incrementally updated energy and the accept (and, mixed,
// attempt) counts per move kind.
//
// What bounds it on Hopper: O(N) float32 work per step and chain, not bytes.
// A displacement evaluates two rows of N pair terms, a swap four, each term
// a minimum image, an exact reciprocal and ~15 flops, so about 2N
// reciprocals per displacement step; the chain's state (12 bytes per
// particle: x, y, species) is read from device memory once per segment and
// written once.  So the design keeps each chain's particles in shared
// memory for the whole segment, one warp per chain: each lane takes the
// slots j = lane, lane + 32, ..., the row sums close with a 5-level warp
// butterfly, every lane computes the step's random draws and accept test
// itself (the values are equal in all lanes, so the warp never diverges),
// and lane 0 writes the one slot an accepted move changes.  At 256 chains
// this fills 256 warps of the card's 132 SMs; speed is a later concern.
//
// The random stream and the arithmetic are the plain version's
// (montecarlo_tpu_torch/ops/lj_sweep.py), which follows the reference:
//   - per-step seed hash32(seed + t0 + k) + pid * 1000003, with pid and the
//     row r the chain's block and row in the reference's Pallas grid of
//     block_chains chains (not this kernel's CUDA blocks);
//   - displacement draws: software_bits(step_seed, 0, (bc, 128)) at
//     flat = r * 128 + c, c = 0..3 (pick, radius, angle, accept);
//   - swap draws: software_bits(step_seed ^ 0x5CA1AB1E, 0|1, (bc, N)) at
//     flat = r * N + j (Gumbel-max A and B picks, lowest index on ties), and
//     software_bits(step_seed ^ 0x0ACCE97, 0, (bc, 128)) at flat = r * 128;
//   - mixed pool: displacement when
//     float(hash32(step_seed ^ 0x7AB1E5) & 0x7FFFFFFF) * 2^-31 < w_disp;
//   - row sums in the lane order: lane-strided partial sums, then the
//     butterfly, which the plain version writes out, so the two agree bit
//     for bit on the card.
// Float arithmetic uses the _rn intrinsics so that nvcc does not contract
// a*b+c into an FMA the plain version does not make; logf, sinf, cosf are
// the precise ones (no fast math), rintf rounds half to even as jnp.round.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_hash.cuh"
#include "particle_rows.cuh"

namespace {

using mc::draw_bits;
using mc::hash32;
using mc::kFullMask;
using mc::kGolden;
using mc::kWarp;
using mc::row_energies;
using mc::uniform_from_bits;
using mc::wrap;

constexpr uint32_t kLanes = 128u;        // columns of the reference's draw
constexpr uint32_t kStepPrime = 1000003u;
constexpr uint32_t kSwapTag = 0x5CA1AB1Eu;
constexpr uint32_t kAcceptTag = 0x0ACCE97u;
constexpr uint32_t kKindTag = 0x7AB1E5u;

// Truncated-and-shifted Kob-Andersen LJ on binary species labels (0 = A,
// 1 = B): the reference kernel's pair tables (_make_row_energy) with its
// exact reciprocal.  Returns 0 beyond the pair's cutoff.
struct SpeciesLJ {
  float e_aa, e_ab, e_bb, s2_aa, s2_ab, s2_bb, rc2_aa, rc2_ab, rc2_bb, sh_aa,
      sh_ab, sh_bb;

  // Table entries 3..14 of the scalar table.
  __device__ static SpeciesLJ load(const float* t) {
    return SpeciesLJ{t[0], t[1], t[2], t[3], t[4],  t[5],
                     t[6], t[7], t[8], t[9], t[10], t[11]};
  }

  __device__ __forceinline__ float operator()(float r2, float a_i,
                                              float a_j) const {
    const bool same = a_j == a_i;
    const bool is_a = a_i == 0.0f;
    const float eps = same ? (is_a ? e_aa : e_bb) : e_ab;
    const float s2 = same ? (is_a ? s2_aa : s2_bb) : s2_ab;
    const float rc2 = same ? (is_a ? rc2_aa : rc2_bb) : rc2_ab;
    const float sh = same ? (is_a ? sh_aa : sh_bb) : sh_ab;
    const float inv = __fmul_rn(s2, __frcp_rn(fmaxf(r2, 1e-12f)));
    const float i6 = __fmul_rn(__fmul_rn(inv, inv), inv);
    const float u = __fsub_rn(
        __fmul_rn(__fmul_rn(4.0f, eps), __fsub_rn(__fmul_rn(i6, i6), i6)), sh);
    return r2 < rc2 ? u : 0.0f;
  }
};

// Warp-wide arg-max of (score, index) with the lowest index on ties.
__device__ __forceinline__ void warp_argmax(float& score, int& index) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float s = __shfl_xor_sync(kFullMask, score, o);
    const int i = __shfl_xor_sync(kFullMask, index, o);
    if (s > score || (s == score && i < index)) {
      score = s;
      index = i;
    }
  }
}

// One block of one warp per chain; kMixed selects the displacement + swap
// pool.
template <bool kMixed, class Pair>
__global__ void lj_sweep_kernel(
    const float* __restrict__ pos, const int32_t* __restrict__ species,
    const float* __restrict__ beta_in, const float* __restrict__ energy_in,
    const float* __restrict__ scalars, float* __restrict__ pos_out,
    int32_t* __restrict__ species_out, float* __restrict__ energy_out,
    int32_t* __restrict__ acc_out, int32_t* __restrict__ tot_out, int n,
    int64_t block_chains, uint32_t seed, int32_t t0, int32_t n_steps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int64_t chain = blockIdx.x;
  float* xs = smem;
  float* ys = xs + n;
  float* as = ys + n;

  const int64_t pid64 = chain / block_chains;
  const uint32_t pid = static_cast<uint32_t>(pid64);
  const uint32_t row = static_cast<uint32_t>(chain - pid64 * block_chains);
  const float sigma = scalars[0];
  const float box = scalars[1];
  const float inv_box = scalars[2];
  const Pair pair = Pair::load(scalars + 3);
  const float w_disp = scalars[15];
  const float two_pi = static_cast<float>(6.283185307179586);
  const float fn = static_cast<float>(n);

  const float* p_in = pos + chain * 2 * n;
  for (int j = lane; j < n; j += kWarp) {
    xs[j] = p_in[2 * j];
    ys[j] = p_in[2 * j + 1];
    as[j] = static_cast<float>(species[chain * n + j]);
  }
  __syncwarp();
  const float neg_beta = -beta_in[chain];
  float e = energy_in[chain];
  int32_t acc_d = 0, acc_s = 0, tot_d = 0, tot_s = 0;
  const uint32_t lane0 = row * kLanes * kGolden;   // flat = r * 128
  const uint32_t plane0 = row * static_cast<uint32_t>(n);  // flat = r * N + j

  for (int32_t k = 0; k < n_steps; ++k) {
    const uint32_t step_seed =
        hash32(seed + static_cast<uint32_t>(t0) + static_cast<uint32_t>(k)) +
        pid * kStepPrime;
    bool is_disp = true;
    if (kMixed) {
      const uint32_t kind_bits = hash32(step_seed ^ kKindTag) & 0x7FFFFFFFu;
      const float u_kind =
          __fmul_rn(__int2float_rn(static_cast<int>(kind_bits)), 0x1p-31f);
      is_disp = u_kind < w_disp;
    }
    if (is_disp) {
      const uint32_t h = lane0 + step_seed;
      const float u_pick = uniform_from_bits(draw_bits(h, 0u));
      const float u1 = uniform_from_bits(draw_bits(h + kGolden, 0u));
      const float u2 = uniform_from_bits(draw_bits(h + 2u * kGolden, 0u));
      const float u_acc = uniform_from_bits(draw_bits(h + 3u * kGolden, 0u));
      const int i = min(static_cast<int>(__fmul_rn(u_pick, fn)), n - 1);
      const float xi = xs[i];
      const float yi = ys[i];
      const float ai = as[i];
      const float r = __fmul_rn(sigma, __fsqrt_rn(__fmul_rn(-2.0f, logf(u1))));
      const float theta = __fmul_rn(two_pi, u2);
      const float xn = __fadd_rn(xi, __fmul_rn(r, cosf(theta)));
      const float yn = __fadd_rn(yi, __fmul_rn(r, sinf(theta)));
      const float px[2] = {xi, xn};
      const float py[2] = {yi, yn};
      const float pa[2] = {ai, ai};
      float rows[2];
      row_energies<2>(pair, xs, ys, as, n, lane, px, py, pa, i, i, box,
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
      // an A slot by the largest ua, a B slot by the largest ub
      const uint32_t swap_seed = step_seed ^ kSwapTag;
      float best_a = -1.0f, best_b = -1.0f;
      int ia = n, ib = n;
      for (int j = lane; j < n; j += kWarp) {
        const uint32_t hj =
            (plane0 + static_cast<uint32_t>(j)) * kGolden + swap_seed;
        if (as[j] > 0.5f) {
          const float u = uniform_from_bits(draw_bits(hj, 1u));
          if (u > best_b) {
            best_b = u;
            ib = j;
          }
        } else {
          const float u = uniform_from_bits(draw_bits(hj, 0u));
          if (u > best_a) {
            best_a = u;
            ia = j;
          }
        }
      }
      warp_argmax(best_a, ia);
      warp_argmax(best_b, ib);
      // a mono-species chain has no partner: the attempt is rejected
      if (ia < n && ib < n) {
        const float u_acc =
            uniform_from_bits(draw_bits(lane0 + (step_seed ^ kAcceptTag), 0u));
        const float xa = xs[ia], ya = ys[ia], xb = xs[ib], yb = ys[ib];
        // i (A -> B) and j (B -> A); the i-j pair term cancels in dE
        const float px[4] = {xa, xa, xb, xb};
        const float py[4] = {ya, ya, yb, yb};
        const float pa[4] = {0.0f, 1.0f, 1.0f, 0.0f};
        float rows[4];
        row_energies<4>(pair, xs, ys, as, n, lane, px, py, pa, ia, ib, box,
                        inv_box, rows);
        const float e_old = __fadd_rn(rows[0], rows[2]);
        const float e_new = __fadd_rn(rows[1], rows[3]);
        const float d_e = __fsub_rn(e_new, e_old);
        if (logf(u_acc) < __fmul_rn(neg_beta, d_e)) {
          if (lane == 0) {
            as[ia] = 1.0f;
            as[ib] = 0.0f;
          }
          e = __fadd_rn(e, d_e);
          ++acc_s;
        }
      }
      ++tot_s;
    }
    __syncwarp();
  }

  float* p_out = pos_out + chain * 2 * n;
  for (int j = lane; j < n; j += kWarp) {
    p_out[2 * j] = xs[j];
    p_out[2 * j + 1] = ys[j];
    if (kMixed) species_out[chain * n + j] = static_cast<int32_t>(as[j]);
  }
  if (lane == 0) {
    energy_out[chain] = e;
    if (kMixed) {
      acc_out[2 * chain] = acc_d;
      acc_out[2 * chain + 1] = acc_s;
      tot_out[2 * chain] = tot_d;
      tot_out[2 * chain + 1] = tot_s;
    } else {
      acc_out[chain] = acc_d;
    }
  }
}

template <bool kMixed>
cudaError_t launch(const float* pos, const int32_t* species, const float* beta,
                   const float* energy, const float* scalars, float* pos_out,
                   int32_t* species_out, float* energy_out, int32_t* acc_out,
                   int32_t* tot_out, int64_t m, int n, int64_t block_chains,
                   uint32_t seed, int32_t t0, int32_t n_steps,
                   cudaStream_t stream) {
  if (m <= 0 || m > INT32_MAX || n <= 0 || block_chains <= 0 || n_steps < 0) {
    return cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // the chain's x, y and species
  const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  auto kernel = lj_sweep_kernel<kMixed, SpeciesLJ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(m), kWarp, smem, stream>>>(
      pos, species, beta, energy, scalars, pos_out, species_out, energy_out,
      acc_out, tot_out, n, block_chains, seed, t0, n_steps);
  return cudaGetLastError();
}

}  // namespace

// Displacement pool (the reference's _kernel).  scalars: the reference's
// 16-float table (sigma, box, 1/box, 12 pair constants, w_disp; w_disp
// unused here).  Outputs pos_out (M, N, 2), energy_out (M,), acc_out (M,).
// Returns the launch's cudaError_t (0 on success).  Does not synchronise.
extern "C" int mc_lj_sweep(const float* pos, const int32_t* species,
                           const float* beta, const float* energy,
                           const float* scalars, float* pos_out,
                           float* energy_out, int32_t* acc_out, int64_t m,
                           int n, int64_t block_chains, uint32_t seed,
                           int32_t t0, int32_t n_steps, void* stream) {
  return static_cast<int>(launch<false>(
      pos, species, beta, energy, scalars, pos_out, nullptr, energy_out,
      acc_out, nullptr, m, n, block_chains, seed, t0, n_steps,
      static_cast<cudaStream_t>(stream)));
}

// Displacement + swap pool (the reference's _mixed_kernel).  Also writes
// species_out (M, N) and acc_out, tot_out (M, 2): column 0 displacement,
// column 1 swap.
extern "C" int mc_lj_mixed_sweep(const float* pos, const int32_t* species,
                                 const float* beta, const float* energy,
                                 const float* scalars, float* pos_out,
                                 int32_t* species_out, float* energy_out,
                                 int32_t* acc_out, int32_t* tot_out, int64_t m,
                                 int n, int64_t block_chains, uint32_t seed,
                                 int32_t t0, int32_t n_steps, void* stream) {
  return static_cast<int>(launch<true>(
      pos, species, beta, energy, scalars, pos_out, species_out, energy_out,
      acc_out, tot_out, m, n, block_chains, seed, t0, n_steps,
      static_cast<cudaStream_t>(stream)));
}
