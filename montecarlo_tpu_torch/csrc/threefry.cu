// The threefry2x32 block function of jax.random, over a batch of keys.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses threefry into the
// ops that consume its bits (jax/_src/prng.py: _threefry2x32_lowering).
// Here it is the stream of the generic Metropolis path, the PGMC estimator
// and the models' initial chains (montecarlo_tpu_torch/utils/prng.py), and
// one launch makes one draw: the block function and the draw's finish
// (bits, uniform, normal, randint, or the two words of a split or fold_in)
// for B keys at n counts each.  One more mode, split_uniform, is a step of
// the soft-potential event chains' loop (montecarlo_tpu/models/
// lennard_jones.py:605, :626-627): k, kthr = split(k) and n uniforms from
// kthr, the successor key and the values from one launch.  Its plain twin is
// montecarlo_tpu_torch/ops/threefry.py: _plain.
//
// What bounds it on Hopper: 32-bit integer operations.  A block is 20
// rounds of add, rotate (one funnel shift) and xor on two words plus five
// key injections, ~75 operations for 8 bytes of output at most; a normal
// adds log1pf, a sqrt and a degree-8 polynomial.  One thread makes one
// value, in a grid-stride loop over the B * n values, and loads its key's
// two words (8 bytes, shared by the n threads of a key through L1); the
// output is written once, 4 or 8 bytes a value.  On an H100 at 10^7 values
// it runs at about half the rate of its operation bound.  At the generic
// path's sizes (10^4 chains, one value each) a launch is 40 blocks and its
// cost is the host's launch, so the design keeps every draw to one launch
// and takes the keys' rows strided (a split's keys, unbound) as they are.
//
// Bits follow jax.random exactly:
//   - count j of a key (the row-major flat index over the draw's shape)
//     enters as the words (j >> 32, j & 0xffffffff), iota_2x32_shape's;
//     fold_in's data d enters as (0, d);
//   - uniform: (bits >> 9) | 0x3f800000 as a float, minus 1, then
//     max(lo, fma(f, hi - lo, lo)): XLA contracts the scale and shift into
//     one fused multiply-add, so the kernel does too, and the plain twin
//     rounds once as well;
//   - normal: sqrt(2) * erf_inv(u), u uniform in [nextafter(-1, 0), 1),
//     with XLA's float32 erf_inv (w = -log1p(-x*x); a Horner polynomial in
//     w - 2.5 or sqrt(w) - 3 of fused multiply-adds);
//   - randint: the key split into two (counts 0 and 1), a word of bits at
//     count j from each, and jax.random._randint's multiply-and-modulo in
//     uint32.
// Other float arithmetic uses the _rn intrinsics, so that nvcc contracts
// nothing the twin does not, and precise log1pf and sqrt (no fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode {
  kWords = 0,
  kBits = 1,
  kUniform = 2,
  kNormal = 3,
  kRandint = 4,
  kSplitUniform = 5
};

constexpr int kThreads = 256;

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ Words block(uint32_t k0, uint32_t k1, uint32_t x0,
                                       uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define MC_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  MC_ROUND(13) MC_ROUND(15) MC_ROUND(26) MC_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  MC_ROUND(17) MC_ROUND(29) MC_ROUND(16) MC_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  MC_ROUND(13) MC_ROUND(15) MC_ROUND(26) MC_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  MC_ROUND(17) MC_ROUND(29) MC_ROUND(16) MC_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  MC_ROUND(13) MC_ROUND(15) MC_ROUND(26) MC_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef MC_ROUND
  return {x0, x1};
}

__device__ __forceinline__ float uniform_from(uint32_t bits, float lo,
                                              float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, __fsub_rn(hi, lo), lo));
}

__constant__ float kErfInvLt5[9] = {
    2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
    -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
    -0.00417768164f, 0.246640727f, 1.50140941f};
__constant__ float kErfInvGe5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f,
    -0.00367342844f, 0.00573950773f, -0.0076224613f,
    0.00943887047f, 1.00167406f, 2.83297682f};

__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float* c = lt ? kErfInvLt5 : kErfInvGe5;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, c[i]);
  return __fmul_rn(p, x);
}

// How a thread finds its counts and bounds: per_key iota counts, or the
// fold_in count (0, data[b]) or (0, fold); randint's bounds per key or
// one for all.
struct Args {
  const uint32_t* keys;
  int64_t key_stride;  // elements from one key's words to the next's
  int64_t per_key, total;
  const int64_t* data;  // a fold_in's data, taken mod 2^32
  int64_t fold;  // >= 0: the count (0, fold) for every key
  float lo, hi;
  const int32_t* ilo;
  const int32_t* ihi;
  int32_t ilo_v, ihi_v;
  void* out;
  uint2* next;  // kSplitUniform: each key's successor, (n_keys) uint2
};

template <int M>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
  const uint32_t* __restrict__ keys = a.keys;
  const int64_t per_key = a.per_key, total = a.total;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const int64_t b = i / per_key;
    const uint64_t j = uint64_t(i - b * per_key);
    const uint32_t k0 = keys[b * a.key_stride];
    const uint32_t k1 = keys[b * a.key_stride + 1];
    const bool folded = a.data != nullptr || a.fold >= 0;
    const uint32_t x0 = folded ? 0u : uint32_t(j >> 32);
    const uint32_t x1 = a.data   ? uint32_t(a.data[b])
                        : folded ? uint32_t(a.fold)
                                 : uint32_t(j);
    if (M == kSplitUniform) {
      // k, kthr = split(key): the successor at count 0, the draw's key at
      // count 1; the value at count j of kthr (each thread recomputes kthr,
      // one block, rather than share it through memory)
      const Words kthr = block(k0, k1, 0u, 1u);
      const Words w = block(kthr.a, kthr.b, x0, x1);
      static_cast<float*>(a.out)[i] = uniform_from(w.a ^ w.b, a.lo, a.hi);
      if (j == 0) {
        const Words nk = block(k0, k1, 0u, 0u);
        a.next[b] = make_uint2(nk.a, nk.b);
      }
      continue;
    }
    if (M == kRandint) {
      const Words ka = block(k0, k1, 0u, 0u), kb = block(k0, k1, 0u, 1u);
      const Words h = block(ka.a, ka.b, x0, x1), l = block(kb.a, kb.b, x0, x1);
      const uint32_t higher = h.a ^ h.b, lower = l.a ^ l.b;
      const int32_t lo_i = a.ilo ? a.ilo[b] : a.ilo_v;
      const int32_t hi_i = a.ihi ? a.ihi[b] : a.ihi_v;
      const uint32_t span =
          hi_i <= lo_i ? 1u : uint32_t(hi_i) - uint32_t(lo_i);
      uint32_t mult = 65536u % span;
      mult = (mult * mult) % span;
      const uint32_t off = ((higher % span) * mult + lower % span) % span;
      static_cast<int32_t*>(a.out)[i] = int32_t(uint32_t(lo_i) + off);
      continue;
    }
    const Words w = block(k0, k1, x0, x1);
    if (M == kWords) {
      static_cast<uint2*>(a.out)[i] = make_uint2(w.a, w.b);
    } else if (M == kBits) {
      static_cast<uint32_t*>(a.out)[i] = w.a ^ w.b;
    } else if (M == kUniform) {
      static_cast<float*>(a.out)[i] = uniform_from(w.a ^ w.b, a.lo, a.hi);
    } else {
      // float32 nextafter(-1, 0) and sqrt(2), jax.random._normal_real's
      const float u = uniform_from(w.a ^ w.b, -0.99999994f, 1.0f);
      static_cast<float*>(a.out)[i] = __fmul_rn(1.41421354f, erf_inv(u));
    }
  }
}

// SMs of each device, read once (a launch is a few microseconds of host
// time; the attribute query would be a tenth of it)
int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (sms[dev] <= 0) sms[dev] = 132;
  }
  return sms[dev];
}

template <int M>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t total = a.total;
  // enough blocks for every value, at most 16 resident blocks' worth an SM
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sm_count()) * 16;
  const int grid = int(want < cap ? want : cap);
  threefry_kernel<M><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// keys: (n_keys, 2) uint32, key b's words at keys[b * key_stride + 0/1];
// per_key >= 1 counts each (iota), or, with data
// (n_keys int64, taken mod 2^32) or fold >= 0 (and per_key 1), the count
// (0, data[b]) or (0, fold); mode as Mode above; lo/hi the float bounds of
// kUniform and kSplitUniform; ilo/ihi (n_keys int32, or null for
// ilo_v/ihi_v) those of kRandint.  out: (n_keys, per_key[, 2]) of the
// mode's type; next: kSplitUniform's (n_keys, 2) uint32 successor keys
// (null otherwise).  Returns the launch's cudaError_t.
extern "C" int mc_threefry(const uint32_t* keys, int64_t key_stride,
                           int64_t n_keys, int64_t per_key,
                           const int64_t* data, int64_t fold, int mode,
                           float lo, float hi, const int32_t* ilo,
                           const int32_t* ihi, int32_t ilo_v, int32_t ihi_v,
                           void* out, void* next, void* stream) {
  if (n_keys <= 0 || per_key <= 0) return 0;
  if (mode == kSplitUniform && next == nullptr)
    return int(cudaErrorInvalidValue);
  const Args a{keys, key_stride, per_key, n_keys * per_key, data, fold,
               lo, hi, ilo, ihi, ilo_v, ihi_v, out,
               static_cast<uint2*>(next)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kWords:
      return launch<kWords>(a, s);
    case kBits:
      return launch<kBits>(a, s);
    case kUniform:
      return launch<kUniform>(a, s);
    case kNormal:
      return launch<kNormal>(a, s);
    case kRandint:
      return launch<kRandint>(a, s);
    case kSplitUniform:
      return launch<kSplitUniform>(a, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
