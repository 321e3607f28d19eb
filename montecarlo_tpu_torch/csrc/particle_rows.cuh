// Row energies of 2-D particle chains for the sweep kernels (lj_sweep.cu,
// poly_sweep.cu): the minimum image, the wrap into the box, the warp
// butterfly sum, and the row sums of a pair functor over the chain's
// particles in shared memory, for one block of W warps per chain.
//
// The float arithmetic uses the _rn intrinsics so that nvcc does not
// contract a*b+c into an FMA the plain versions do not make; rintf rounds
// half to even as jnp.round and torch.round do.

#pragma once

#include <cstdint>

namespace mc {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Round to the nearest integer, half to even, for |v| < 2^22: adding and
// taking away 1.5 * 2^23 rounds in the adder, at the full float32 rate where
// rintf runs at a quarter of it.  (A zero comes out positive where rintf
// keeps the sign, which no difference d - box * 0 sees.)
__device__ __forceinline__ float round_small(float v) {
  return __fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f);
}

// d is a difference of two coordinates in [0, box), so |d / box| < 1.
__device__ __forceinline__ float min_image(float d, float box, float inv_box) {
  return __fsub_rn(d, __fmul_rn(box, round_small(__fmul_rn(d, inv_box))));
}

__device__ __forceinline__ float wrap(float v, float box, float inv_box) {
  return __fsub_rn(v, __fmul_rn(box, floorf(__fmul_rn(v, inv_box))));
}

// Sum over the 32 lanes: lane l adds lane l ^ o for o = 16, 8, 4, 2, 1, so
// every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return v;
}

// Partial row sums of one thread: the pair energies of K probe particles
// (px[q], py[q], attribute pa[q]: a species label or a diameter) with the
// chain's slots first, first + stride, ... in turn (xs, ys, as), slots excl0
// and excl1 counting 0.0.  pair(r2, a_probe, a_slot) is the pair energy.
template <int K, class Pair>
__device__ __forceinline__ void partial_rows(
    const Pair& pair, const float* xs, const float* ys, const float* as,
    int n, int first, int stride, const float (&px)[K], const float (&py)[K],
    const float (&pa)[K], int excl0, int excl1, float box, float inv_box,
    float (&part)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) part[q] = 0.0f;
  // four slots side by side: their terms are independent, only the adds
  // into part[] are in turn
#pragma unroll 4
  for (int j = first; j < n; j += stride) {
    const float xj = xs[j];
    const float yj = ys[j];
    const float aj = as[j];
    const bool skip = j == excl0 || j == excl1;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const float dx = min_image(__fsub_rn(xj, px[q]), box, inv_box);
      const float dy = min_image(__fsub_rn(yj, py[q]), box, inv_box);
      const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float u = pair(r2, pa[q], aj);
      part[q] = __fadd_rn(part[q], skip ? 0.0f : u);
    }
  }
}

// The K row sums of the reference's row_energy for one block of
// W = blockDim.x / 32 warps per chain, in the thread order: thread t sums
// slots t, t + 32 W, ... in turn, warp_sum closes each warp, the W warp sums
// go to red (shared, at least K W floats), and after one __syncthreads
// every thread adds them in warp order (at W = 1: the warp's sum).  Returned in all threads.  Every thread of the block must call it;
// red must not be written again before the block's next barrier.
template <int K, class Pair>
__device__ __forceinline__ void block_row_energies(
    const Pair& pair, const float* xs, const float* ys, const float* as,
    int n, const float (&px)[K], const float (&py)[K], const float (&pa)[K],
    int excl0, int excl1, float box, float inv_box, float* red,
    float (&out)[K]) {
  const int tid = threadIdx.x;
  const int warps = blockDim.x / kWarp;
  float part[K];
  partial_rows<K>(pair, xs, ys, as, n, tid, blockDim.x, px, py, pa, excl0,
                  excl1, box, inv_box, part);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float v = warp_sum(part[q]);
    if (tid % kWarp == 0) red[(tid / kWarp) * K + q] = v;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = red[q];
#pragma unroll 4
  for (int w = 1; w < warps; ++w) {
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = __fadd_rn(out[q], red[w * K + q]);
  }
}

}  // namespace mc
