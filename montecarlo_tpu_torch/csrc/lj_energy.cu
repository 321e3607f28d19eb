// The O(N^2) total energy of 2-D Lennard-Jones chains: every chain of a
// batch in one call, two launches.
//
// Replaces no Pallas kernel: the JAX package computes the total energy with
// jnp ops (montecarlo_tpu/models/lennard_jones.py: total_energy), which XLA
// fuses.  Here the plain-torch version (montecarlo_tpu_torch/models/
// lennard_jones.py: total_energy, the twin) runs as ~40 elementwise and
// reduce kernels per batch of 64 rows and writes gigabytes of pair tensors
// for one float a chain.  This kernel stands behind
// lennard_jones._lj_energies for 2-D float32 states on the card: the cache
// refresh at every record, init_chains and the LJ volume move.
//
// What bounds it on Hopper: float32 operations, not bytes.  A chain's
// state is 12 bytes a particle, read once per block from L2; the work is
// N (N - 1) pair terms, each 15 operations (two differences, two minimum
// images of a multiply, a rounding, a multiply and a subtraction, r2, the
// species compare and the cutoff test), and the ~2 % inside the cutoff
// (rho 1.2, r_c 2.5 sigma) 9 more (a max, a division, four multiplies,
// two subtractions and the add).  At 64 x N 1024 that bound is ~0.03 ms at
// the H100's 3.35e13 float32 operations a second; it takes ~0.09 ms.
//
// Design:
//   - Grid: one block per (chain, tile of rows), one thread a row, 128
//     rows a tile (N rounded up to whole warps below that); at 64 x N 1024
//     that is 512 blocks over 132 SMs, all resident at once.  The tiling
//     depends on N alone, so a chain's energy does not depend on the other
//     chains of the call or on the card.
//   - Shared memory: the chain's particles as (x, y, species) float4
//     columns, kCols at a time (32 KB), which the block loops over, so any
//     N runs; every thread of a warp reads the same column, one broadcast
//     load a pair.
//   - Per thread: the row's pair terms in column order, slot i skipped,
//     terms beyond the pair's cutoff skipped (they add 0.0 in the twin), in
//     the twin's float32 arithmetic: r2 = dx^2 + dy^2, (eps, sig) by the
//     species pair as LJParams.coeffs selects them, s2 / max(r2, 1e-12),
//     the shift at r_c = rcut sig.  The minimum image d - box round(d / box)
//     (half to even) takes d / box as d * (1 / box), where the twin
//     divides: the two can pick the other image only at |d| = box / 2,
//     where both have the same length.  The _rn intrinsics keep nvcc from
//     contracting a*b+c into an FMA the twin does not make.
//   - Reduction in a fixed tree: each warp's rows by a butterfly, the
//     block's warps in order into one partial a tile, then (second launch)
//     each chain's tiles in order, times 0.5.  No atomics: two calls give
//     the same bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lj_pair_table.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kRows = 128;      // the most rows (threads) of a block
constexpr int kCols = 2048;     // columns staged in shared memory a pass
constexpr int kSumThreads = 128;

// Round to the nearest integer, half to even, for |v| < 2^22 (as
// particle_rows.cuh: round_small).
__device__ __forceinline__ float round_small(float v) {
  return __fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f);
}

// d is a difference of two coordinates in [0, box), so |d / box| < 1.
__device__ __forceinline__ float min_image(float d, float box, float inv_box) {
  return __fsub_rn(d, __fmul_rn(box, round_small(__fmul_rn(d, inv_box))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return v;
}

// One partial a (chain, tile): the sum of the tile's row energies.
__global__ void __launch_bounds__(kRows) lj_energy_rows(
    const float* __restrict__ pos, const int32_t* __restrict__ species,
    const float* __restrict__ box_in, PairTable tab, int n, int tiles,
    float* __restrict__ partial) {
  __shared__ float4 cols[kCols];
  __shared__ float red[kRows / kWarp];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t chain = b / tiles;
  const int i = static_cast<int>(b - chain * tiles) * blockDim.x + tid;
  const bool live = i < n;
  const float* p = pos + chain * 2 * n;
  const int32_t* s = species + chain * n;
  const float box = box_in[chain];
  const float inv_box = __fdiv_rn(1.0f, box);

  float xi = 0.0f, yi = 0.0f;
  int32_t si = 0;
  if (live) {
    xi = p[2 * i];
    yi = p[2 * i + 1];
    si = s[i];
  }
  // LJParams.coeffs: the same species takes AA or BB by the row's label
  // (label 0 is A), a different one AB (selects: an index into the table
  // would put it on the stack)
  const bool is_a = si == 0;
  const float e4_same = is_a ? tab.e4[0] : tab.e4[2], e4_diff = tab.e4[1];
  const float s2_same = is_a ? tab.s2[0] : tab.s2[2], s2_diff = tab.s2[1];
  const float rc2_same = is_a ? tab.rc2[0] : tab.rc2[2], rc2_diff = tab.rc2[1];
  const float sh_same = is_a ? tab.sh[0] : tab.sh[2], sh_diff = tab.sh[1];
  const float fsi = static_cast<float>(si);

  float acc = 0.0f;
  for (int c0 = 0; c0 < n; c0 += kCols) {
    const int cn = min(kCols, n - c0);
    __syncthreads();  // the previous pass's columns are read
    for (int j = tid; j < cn; j += blockDim.x) {
      const int c = c0 + j;
      cols[j] = make_float4(p[2 * c], p[2 * c + 1],
                            static_cast<float>(s[c]), 0.0f);
    }
    __syncthreads();
    if (live) {
      const int self = i - c0;  // out of [0, cn) unless i is in this pass
#pragma unroll 4
      for (int j = 0; j < cn; ++j) {
        const float4 cj = cols[j];
        const float dx = min_image(__fsub_rn(cj.x, xi), box, inv_box);
        const float dy = min_image(__fsub_rn(cj.y, yi), box, inv_box);
        const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const bool same = cj.z == fsi;
        if (r2 < (same ? rc2_same : rc2_diff) && j != self) {
          const float e4 = same ? e4_same : e4_diff;
          const float s2 = same ? s2_same : s2_diff;
          const float sh = same ? sh_same : sh_diff;
          const float inv = __fdiv_rn(s2, fmaxf(r2, 1e-12f));
          const float i6 = __fmul_rn(__fmul_rn(inv, inv), inv);
          const float u = __fsub_rn(
              __fmul_rn(e4, __fsub_rn(__fmul_rn(i6, i6), i6)), sh);
          acc = __fadd_rn(acc, u);
        }
      }
    }
  }

  const float w = warp_sum(acc);
  if (tid % kWarp == 0) red[tid / kWarp] = w;
  __syncthreads();
  if (tid == 0) {
    float t = red[0];
    for (int k = 1; k < static_cast<int>(blockDim.x) / kWarp; ++k) {
      t = __fadd_rn(t, red[k]);
    }
    partial[b] = t;
  }
}

// One thread a chain: its tiles' partials in order, times 0.5.
__global__ void __launch_bounds__(kSumThreads) lj_energy_sum(
    const float* __restrict__ partial, int tiles, int64_t m,
    float* __restrict__ out) {
  const int64_t chain = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (chain >= m) return;
  const float* q = partial + chain * tiles;
  float t = q[0];
  for (int k = 1; k < tiles; ++k) t = __fadd_rn(t, q[k]);
  out[chain] = __fmul_rn(0.5f, t);
}

}  // namespace

// pos (m, n, 2) float32, species (m, n) int32, box (m,) float32; tab the
// pair constants; rows the threads of a block, a multiple of 32 up to
// kRows (ops/lj_energy.py: block_rows, from n alone); partial
// (m, ceil(n / rows)) float32 scratch; out (m,) float32 total energies.
// Returns the first launch error (0 on success).  Does not synchronise.
extern "C" int mc_lj_energy(const float* pos, const int32_t* species,
                            const float* box, PairTable tab, float* partial,
                            float* out, int64_t m, int n, int rows,
                            void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (rows < kWarp || rows > kRows || rows % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + rows - 1) / rows;
  lj_energy_rows<<<static_cast<unsigned>(m * tiles), rows, 0, s>>>(
      pos, species, box, tab, n, tiles, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (m + kSumThreads - 1) / kSumThreads;
  lj_energy_sum<<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
      partial, tiles, m, out);
  return static_cast<int>(cudaGetLastError());
}
