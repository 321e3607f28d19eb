// The reference's counter-hash random stream (montecarlo_tpu/ops/
// fused_sweep.py: _hash32, software_bits, _uniform_from_bits), shared by the
// package's kernels.  uint32 arithmetic wraps as the reference's int32 does,
// and its logical shifts are uint32 shifts.

#pragma once

#include <cstdint>

namespace mc {

constexpr uint32_t kGolden = 0x9E3779B9u;   // lane multiplier of software_bits
constexpr uint32_t kDrawTag = 0x3243F6A9u;  // per-draw tag of software_bits

__device__ __forceinline__ uint32_t hash32(uint32_t s) {
  s *= 0x85EBCA6Bu;
  s ^= s >> 13;
  s *= 0xC2B2AE35u;
  s ^= s >> 16;
  return s;
}

// software_bits for one lane: h = flat * kGolden + step_seed.
__device__ __forceinline__ uint32_t draw_bits(uint32_t h, uint32_t draw) {
  return hash32(hash32(h ^ (draw * kDrawTag)) + draw);
}

// uint32 bits -> float32 uniform in (0, 1].
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fsub_rn(2.0f, __uint_as_float((bits >> 9) | 0x3F800000u));
}

}  // namespace mc
