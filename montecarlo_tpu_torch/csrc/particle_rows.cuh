// Row energies of 2-D particle chains for the one-warp-per-chain sweep
// kernels (lj_sweep.cu, poly_sweep.cu): the minimum image, the wrap into the
// box, the warp butterfly sum, and the row sums of a pair functor over the
// chain's particles in shared memory.
//
// The float arithmetic uses the _rn intrinsics so that nvcc does not
// contract a*b+c into an FMA the plain versions do not make; rintf rounds
// half to even as jnp.round and torch.round do.

#pragma once

#include <cstdint>

namespace mc {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ float min_image(float d, float box, float inv_box) {
  return __fsub_rn(d, __fmul_rn(box, rintf(__fmul_rn(d, inv_box))));
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

// Interaction energies of K probe particles (px[q], py[q], attribute pa[q]:
// a species label or a diameter) with the chain's particles (xs, ys, as),
// slots excl0 and excl1 left out: the row sums of the reference's
// row_energy, in the lane order (lane l sums slots l, l + 32, ... in turn,
// then warp_sum).  pair(r2, a_probe, a_slot) is the pair energy.  Returned
// in all lanes.
template <int K, class Pair>
__device__ __forceinline__ void row_energies(
    const Pair& pair, const float* xs, const float* ys, const float* as,
    int n, int lane, const float (&px)[K], const float (&py)[K],
    const float (&pa)[K], int excl0, int excl1, float box, float inv_box,
    float (&out)[K]) {
  float part[K];
#pragma unroll
  for (int q = 0; q < K; ++q) part[q] = 0.0f;
  for (int j = lane; j < n; j += kWarp) {
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
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = warp_sum(part[q]);
}

}  // namespace mc
