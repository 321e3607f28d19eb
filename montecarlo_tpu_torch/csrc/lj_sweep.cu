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
// written once.  The steps of a chain are sequential, so what a launch
// takes is the latency of one step times the steps: the design shortens the
// step.
//
// One block of W warps serves one chain (W from N alone,
// ops/lj_sweep.py: block_warps), the chain's particles in shared memory for
// the whole segment.
//   - Rows: thread t sums the pair terms of slots t, t + 32 W, ... (a
//     handful, where one warp per chain walked N / 32), a 5-level butterfly
//     closes each warp, the W warp sums go through shared memory and every
//     thread adds them in warp order (particle_rows.cuh:
//     block_row_energies).  One barrier.
//   - Draws ahead of the loop: a displacement step's draws (kind, pick,
//     r cos, r sin, log u) and a swap's log u depend on (seed, step, chain)
//     only, so the block computes them for kBatch steps at once, one step a
//     thread, into shared memory; the serial loop reads them.  That takes
//     nine hashes, two logf and a sincos off every step's critical path.
//   - The swap's Gumbel picks read the species, so they stay in the loop,
//     the slots spread over the threads, the arg-max closed per warp and
//     then across the warps through shared memory (lowest index on ties).
//     One more barrier.
//   - An accepted move is written by thread 0 and followed by a barrier;
//     a rejected one changes nothing and needs none.  The reduction
//     scratch alternates between two buffers by the step's parity, so a
//     thread that runs ahead into the next step never writes what a slower
//     one still reads (every step has at least one barrier).
// Every thread computes the accept test itself from the same values, so all
// branches around barriers are uniform.  A displacement step costs one or
// two barriers, a swap two or three.  At 64 chains this fills 64 of the
// card's 132 SMs: the gain is per step, not in occupancy.
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
//   - row sums in the thread order: thread-strided partial sums, the
//     butterfly in each warp, then the warp sums in turn, which the plain
//     version writes out, so the two agree bit for bit on the card.
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
using mc::block_row_energies;
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

// Keep the better of two (score, index) candidates: the larger score, the
// lower index on ties.
__device__ __forceinline__ void take_better(float& score, int& index, float s,
                                            int i) {
  if (s > score || (s == score && i < index)) {
    score = s;
    index = i;
  }
}

// Warp-wide arg-max of (score, index) with the lowest index on ties.
__device__ __forceinline__ void warp_argmax(float& score, int& index) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    take_better(score, index, __shfl_xor_sync(kFullMask, score, o),
                __shfl_xor_sync(kFullMask, index, o));
  }
}

constexpr int kBatch = 128;     // steps whose draws are made at once
constexpr int kMaxWarps = 16;   // of a block: leaves a thread 128 registers
// shared memory besides the particles, in 4-byte words: two buffers of row
// sums (4 rows a warp), two of arg-max scores and indices (A and B picks a
// warp), and the batch's four draws a step
constexpr int kRedWords = kMaxWarps * 4;
constexpr int kArgWords = kMaxWarps * 2;
constexpr int kScratchWords = 2 * kRedWords + 4 * kArgWords + 4 * kBatch;

// One block of blockDim.x / 32 warps per chain; kMixed selects the
// displacement + swap pool.
template <bool kMixed, class Pair>
__global__ void __launch_bounds__(kMaxWarps * kWarp) lj_sweep_kernel(
    const float* __restrict__ pos, const int32_t* __restrict__ species,
    const float* __restrict__ beta_in, const float* __restrict__ energy_in,
    const float* __restrict__ scalars, float* __restrict__ pos_out,
    int32_t* __restrict__ species_out, float* __restrict__ energy_out,
    int32_t* __restrict__ acc_out, int32_t* __restrict__ tot_out, int n,
    int64_t block_chains, uint32_t seed, int32_t t0, int32_t n_steps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int warps = threads / kWarp;
  const int64_t chain = blockIdx.x;
  float* xs = smem;
  float* ys = xs + n;
  float* as = ys + n;
  float* red = as + n;                      // [2][kRedWords]
  float* arg_s = red + 2 * kRedWords;       // [2][kArgWords]
  int* arg_i = reinterpret_cast<int*>(arg_s + 2 * kArgWords);
  int* b_pick = arg_i + 2 * kArgWords;      // [kBatch]; -1 marks a swap
  float* b_dx = reinterpret_cast<float*>(b_pick + kBatch);
  float* b_dy = b_dx + kBatch;
  float* b_log = b_dy + kBatch;

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
  for (int j = tid; j < n; j += threads) {
    xs[j] = p_in[2 * j];
    ys[j] = p_in[2 * j + 1];
    as[j] = static_cast<float>(species[chain * n + j]);
  }
  const float neg_beta = -beta_in[chain];
  float e = energy_in[chain];
  int32_t acc_d = 0, acc_s = 0, tot_d = 0, tot_s = 0;
  const uint32_t lane0 = row * kLanes * kGolden;   // flat = r * 128
  const uint32_t plane0 = row * static_cast<uint32_t>(n);  // flat = r * N + j
  const uint32_t seed_t0 = seed + static_cast<uint32_t>(t0);

  for (int32_t k0 = 0; k0 < n_steps; k0 += kBatch) {
    const int32_t batch = min(kBatch, n_steps - k0);
    // the draws of the batch's steps that do not depend on the state, one
    // step a thread
    for (int32_t s = tid; s < batch; s += threads) {
      const uint32_t step_seed =
          hash32(seed_t0 + static_cast<uint32_t>(k0 + s)) + pid * kStepPrime;
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
        const float r =
            __fmul_rn(sigma, __fsqrt_rn(__fmul_rn(-2.0f, logf(u1))));
        const float theta = __fmul_rn(two_pi, u2);
        b_pick[s] = min(static_cast<int>(__fmul_rn(u_pick, fn)), n - 1);
        b_dx[s] = __fmul_rn(r, cosf(theta));
        b_dy[s] = __fmul_rn(r, sinf(theta));
        b_log[s] = logf(u_acc);
      } else {
        const float u_acc =
            uniform_from_bits(draw_bits(lane0 + (step_seed ^ kAcceptTag), 0u));
        b_pick[s] = -1;
        b_log[s] = logf(u_acc);
      }
    }
    // the batch, and before the first one the particles, are in place; every
    // thread has read the last batch's draws (it passed its last step's
    // first barrier)
    __syncthreads();

    for (int32_t s = 0; s < batch; ++s) {
      const int i = b_pick[s];
      const float log_u = b_log[s];
      const int parity = (k0 + s) & 1;
      float* red_k = red + parity * kRedWords;
      if (i >= 0) {
        const float xi = xs[i];
        const float yi = ys[i];
        const float ai = as[i];
        const float xn = __fadd_rn(xi, b_dx[s]);
        const float yn = __fadd_rn(yi, b_dy[s]);
        const float px[2] = {xi, xn};
        const float py[2] = {yi, yn};
        const float pa[2] = {ai, ai};
        float rows[2];
        block_row_energies<2>(pair, xs, ys, as, n, px, py, pa, i, i, box,
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
        // an A slot by the largest ua, a B slot by the largest ub
        const uint32_t swap_seed =
            (hash32(seed_t0 + static_cast<uint32_t>(k0 + s)) +
             pid * kStepPrime) ^ kSwapTag;
        float best_a = -1.0f, best_b = -1.0f;
        int ia = n, ib = n;
#pragma unroll 4
        for (int j = tid; j < n; j += threads) {
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
        float* arg_sk = arg_s + parity * kArgWords;
        int* arg_ik = arg_i + parity * kArgWords;
        if (lane == 0) {
          arg_sk[2 * warp] = best_a;
          arg_ik[2 * warp] = ia;
          arg_sk[2 * warp + 1] = best_b;
          arg_ik[2 * warp + 1] = ib;
        }
        __syncthreads();
        best_a = arg_sk[0];
        ia = arg_ik[0];
        best_b = arg_sk[1];
        ib = arg_ik[1];
#pragma unroll 4
        for (int w = 1; w < warps; ++w) {
          take_better(best_a, ia, arg_sk[2 * w], arg_ik[2 * w]);
          take_better(best_b, ib, arg_sk[2 * w + 1], arg_ik[2 * w + 1]);
        }
        // a mono-species chain has no partner: the attempt is rejected
        if (ia < n && ib < n) {
          const float xa = xs[ia], ya = ys[ia], xb = xs[ib], yb = ys[ib];
          // i (A -> B) and j (B -> A); the i-j pair term cancels in dE
          const float px[4] = {xa, xa, xb, xb};
          const float py[4] = {ya, ya, yb, yb};
          const float pa[4] = {0.0f, 1.0f, 1.0f, 0.0f};
          float rows[4];
          block_row_energies<4>(pair, xs, ys, as, n, px, py, pa, ia, ib, box,
                                inv_box, red_k, rows);
          const float e_old = __fadd_rn(rows[0], rows[2]);
          const float e_new = __fadd_rn(rows[1], rows[3]);
          const float d_e = __fsub_rn(e_new, e_old);
          if (log_u < __fmul_rn(neg_beta, d_e)) {
            if (tid == 0) {
              as[ia] = 1.0f;
              as[ib] = 0.0f;
            }
            e = __fadd_rn(e, d_e);
            ++acc_s;
            __syncthreads();
          }
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
    if (kMixed) species_out[chain * n + j] = static_cast<int32_t>(as[j]);
  }
  if (tid == 0) {
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
                   int32_t* tot_out, int64_t m, int n, int warps,
                   int64_t block_chains, uint32_t seed, int32_t t0,
                   int32_t n_steps, cudaStream_t stream) {
  if (m <= 0 || m > INT32_MAX || n <= 0 || warps < 1 || warps > kMaxWarps ||
      block_chains <= 0 || n_steps < 0) {
    return cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // the chain's x, y and species, and the block's scratch
  const size_t smem =
      (3 * static_cast<size_t>(n) + kScratchWords) * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  auto kernel = lj_sweep_kernel<kMixed, SpeciesLJ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(m), warps * kWarp, smem, stream>>>(
      pos, species, beta, energy, scalars, pos_out, species_out, energy_out,
      acc_out, tot_out, n, block_chains, seed, t0, n_steps);
  return cudaGetLastError();
}

}  // namespace

// Displacement pool (the reference's _kernel).  scalars: the reference's
// 16-float table (sigma, box, 1/box, 12 pair constants, w_disp; w_disp
// unused here).  warps: the warps W of the block that serves a chain, 1 to
// 16; the row sums' order depends on it.  Outputs pos_out (M, N, 2),
// energy_out (M,), acc_out (M,).
// Returns the launch's cudaError_t (0 on success).  Does not synchronise.
extern "C" int mc_lj_sweep(const float* pos, const int32_t* species,
                           const float* beta, const float* energy,
                           const float* scalars, float* pos_out,
                           float* energy_out, int32_t* acc_out, int64_t m,
                           int n, int warps, int64_t block_chains,
                           uint32_t seed, int32_t t0, int32_t n_steps,
                           void* stream) {
  return static_cast<int>(launch<false>(
      pos, species, beta, energy, scalars, pos_out, nullptr, energy_out,
      acc_out, nullptr, m, n, warps, block_chains, seed, t0, n_steps,
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
                                 int n, int warps, int64_t block_chains,
                                 uint32_t seed, int32_t t0, int32_t n_steps,
                                 void* stream) {
  return static_cast<int>(launch<true>(
      pos, species, beta, energy, scalars, pos_out, species_out, energy_out,
      acc_out, tot_out, m, n, warps, block_chains, seed, t0, n_steps,
      static_cast<cudaStream_t>(stream)));
}
