// One substep of the checkerboard cell path on 2-D Lennard-Jones chains:
// a displacement or an A-B species swap in every active cell of one colour
// of every chain, in one call (two launches: the cells, then the chains'
// sums).
//
// Replaces no Pallas kernel: the JAX package's cell path is jnp ops
// (montecarlo_tpu/ops/cell_mc.py: _make_substep), which XLA fuses.  Its
// plain twin is montecarlo_tpu_torch/ops/cell_mc.py: _make_substep, ~110
// eager elementwise launches a substep that write the (rows, M, h, h, 9 C)
// pair tensors to device memory; ops/cell_mc.py: cell_mc_segment takes this
// kernel for the kind-0 and kind-1 substeps of 2-D LJ float32 chains on the
// card, and the twin everywhere else.
//
// What bounds it on Hopper: by the algorithm, bytes.  A substep reads
// every chain's packed cells once (x, y, label, occupancy: 16 bytes a slot,
// 37.7 MB at 32 x nc 48 x cap 32, within the 50 MB L2), and a move's work
// is the pair terms of two (displacement) or four (swap) rows against its
// 3 x 3 neighbourhood's ~9 N / nc^2 occupants, ~20 float32 operations a
// term; h100_bench/counts/cell_substep.py puts a substep at ~3.8 us.  As
// built it takes ~50 us (displacement) and ~60 us (swap) at that shape on
// an H100 (700 W), most of it the neighbourhood's loads: with those cut
// out, the call is bound by its host launch; the pair energies cost ~9 us,
// the chains' sums ~3 us; an IEEE division, the float64 sums, rintf and
// listing only the occupied slots (~14 of 32) cost nothing measurable.
//
// Design:
//   - One warp an active cell, eight cells a block: 32 chains x 576 cells
//     at nc 48 is 18,432 warps over the 132 SMs.  Active cells of one
//     colour are never adjacent (nc is even), so a warp writes only its own
//     cell, which no other warp of the launch reads.
//   - The pick: lane s scores slots s, s + 32, ... (the uniform where
//     occupied, -1 where not, as the twin's where(occ, u, -1)), then a
//     butterfly argmax across the warp with the lower slot winning ties, as
//     torch.argmax's first maximum does, carrying the slot's fields.  A
//     cell with nothing to pick (no occupant, a swap without an A or a B)
//     attempts nothing.
//   - The neighbourhood: the nine cells in the twin's offset order, lane s
//     taking slot s (and s + 32, ... for a cap above 32).  A warp's time is
//     its loads' latency, not its arithmetic, so each phase issues all its
//     loads before their first use: the pick's fields and draws, then the
//     nine cells' 36 fields of a lane's slot, straight from the packed
//     cells through L1 (a warp reads no slot twice: nothing is staged in
//     shared memory).  The mover's slot (the two swappers' slots) is
//     skipped in the centre cell, and empty slots add nothing.
//   - Each pair term in the twin's float32 arithmetic, with the _rn
//     intrinsics so nvcc contracts nothing into an FMA: the fractional
//     difference less its rintf (half to even, as torch.round), the
//     squares added x then y, times box^2; the cutoff r2 < (rcut sig)^2;
//     s2 / max(r2, 1e-12), i6 = inv^2 inv, e4 (i6^2 - i6) - shift, the
//     constants of ops/lj_energy.py: _pair_table (AA or BB by the probe's
//     label for equal labels, else AB, as LJParams.coeffs selects them).
//   - Every row's terms accumulate in float64 per lane, then across the
//     warp, and round to float32 once (ops/cell_mc.py, "Sum order"), so the
//     row's bits do not depend on the order; lane 0 takes the decision,
//     logf(u_acc) < -beta dE with the precise logf torch's log uses, and
//     writes the moved coordinates or the exchanged labels in place.
//   - The chains' sums (second launch, a block a chain): the accepted dE of
//     the chain's active cells in float64, rounded once and added to the
//     chain's float32 energy, and the attempts and accepts as int32, into
//     the segment's accumulators.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "lj_pair_table.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kCellWarps = 8;   // active cells (warps) a block
constexpr int kSumThreads = 256;  // a chain's block of the sums
// the packed cells' fields after x (fractions of the box): y, the label,
// the occupancy (1.0 or 0.0)
constexpr int kY = 1, kLabel = 2, kOcc = 3, kFields = 4;

// The constants of a probe of one label against an occupant: of the same
// label (AA where the probe's label is 0, else BB) or of the other (AB).
struct Row {
  float label;
  float e4_same, s2_same, rc2_same, sh_same;
  float e4_diff, s2_diff, rc2_diff, sh_diff;
};

__device__ __forceinline__ Row make_row(const PairTable& t, float label) {
  const bool is_a = label == 0.0f;
  Row r;
  r.label = label;
  r.e4_same = is_a ? t.e4[0] : t.e4[2];
  r.s2_same = is_a ? t.s2[0] : t.s2[2];
  r.rc2_same = is_a ? t.rc2[0] : t.rc2[2];
  r.sh_same = is_a ? t.sh[0] : t.sh[2];
  r.e4_diff = t.e4[1];
  r.s2_diff = t.s2[1];
  r.rc2_diff = t.rc2[1];
  r.sh_diff = t.sh[1];
  return r;
}

// The squared fractional minimum-image difference along one axis.
__device__ __forceinline__ float frac_sq(float a, float b) {
  float d = __fsub_rn(a, b);
  d = __fsub_rn(d, rintf(d));
  return __fmul_rn(d, d);
}

// Squared distance in real units from the probe (px, py) to an occupant
// (x, y), as the twin's dist2: the axes summed, then times box^2.
__device__ __forceinline__ float dist2(float x, float y, float px, float py,
                                       float box2) {
  return __fmul_rn(__fadd_rn(frac_sq(x, px), frac_sq(y, py)), box2);
}

// Adds the pair term of a probe of row r against an occupant of label b at
// squared distance r2 to sum, where it lies inside the pair's cutoff.
__device__ __forceinline__ void add_pair(double& sum, const Row& r, float r2,
                                         float b) {
  const bool same = b == r.label;
  if (r2 < (same ? r.rc2_same : r.rc2_diff)) {
    const float e4 = same ? r.e4_same : r.e4_diff;
    const float s2 = same ? r.s2_same : r.s2_diff;
    const float sh = same ? r.sh_same : r.sh_diff;
    const float inv = __fdiv_rn(s2, fmaxf(r2, 1e-12f));
    const float i6 = __fmul_rn(__fmul_rn(inv, inv), inv);
    const float u =
        __fsub_rn(__fmul_rn(e4, __fsub_rn(__fmul_rn(i6, i6), i6)), sh);
    sum = __dadd_rn(sum, static_cast<double>(u));
  }
}

// The warp's float64 sum, rounded to float32 once; every lane gets lane 0's.
__device__ __forceinline__ float warp_sum32(double v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = __dadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return __double2float_rn(__shfl_sync(kFullMask, v, 0));
}

// A slot's score and fields, carried through the warp's argmax.
struct Pick {
  float score;
  int slot;
  float x, y, label;
};

// Keeps the better of a and b: the larger score, the lower slot on ties.
__device__ __forceinline__ void keep_better(Pick& a, const Pick& b) {
  if (b.score > a.score || (b.score == a.score && b.slot < a.slot)) a = b;
}

// The warp's pick: every lane gets the slot of the largest score, the
// lower slot on ties (torch.argmax's first maximum), with its fields.
__device__ __forceinline__ Pick warp_argmax(Pick p) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    Pick q;
    q.score = __shfl_xor_sync(kFullMask, p.score, o);
    q.slot = __shfl_xor_sync(kFullMask, p.slot, o);
    q.x = __shfl_xor_sync(kFullMask, p.x, o);
    q.y = __shfl_xor_sync(kFullMask, p.y, o);
    q.label = __shfl_xor_sync(kFullMask, p.label, o);
    keep_better(p, q);
  }
  return p;
}

// A neighbour index one step off i on the torus of nc cells.
__device__ __forceinline__ int wrap(int i, int nc) {
  return i < 0 ? i + nc : (i >= nc ? i - nc : i);
}

// One warp an active cell.  kSwap false: the displacement, draws (first,
// second, u_acc) = (u_pick (M, h, h, cap), the normal step (M, h, h, 2),
// (M, h, h)); true: the species swap, (u_i, u_j (M, h, h, cap), u_acc).
// args (4, M): sigma / box, the halo as a fraction of the box, -beta, box^2.
// Every load of a phase is issued before its first use: the slots' fields
// of the pick, then those of the nine cells, a lane's slot of each at once.
template <bool kSwap>
__global__ void __launch_bounds__(kCellWarps * kWarp) cell_moves(
    float* P, const float* __restrict__ first,
    const float* __restrict__ second, const float* __restrict__ u_acc,
    const float* __restrict__ args, PairTable tab, int m, int nc, int cap,
    int px, int py, float* __restrict__ cell_de,
    uint8_t* __restrict__ cell_flags) {
  const int lane = threadIdx.x % kWarp;
  const int h = nc / 2;
  const int per_chain = h * h;
  const int64_t g = int64_t(blockIdx.x) * kCellWarps + threadIdx.x / kWarp;
  if (g >= int64_t(m) * per_chain) return;  // the whole warp
  const int64_t chain = g / per_chain;
  const int c = static_cast<int>(g - chain * per_chain);
  const int gi = 2 * (c / h) + px, gj = 2 * (c % h) + py;
  const int64_t field = int64_t(nc) * nc * cap;
  float* const xs = P + chain * kFields * field;
  float* const ys = xs + kY * field;
  float* const labels = xs + kLabel * field;
  const float* const occs = xs + kOcc * field;
  const int own = (gi * nc + gj) * cap;
  const float* const u_first = first + g * cap;
  const float* const u_second = second + g * (kSwap ? cap : 2);
  const float u_a = u_acc[g];
  const float box2 = args[3 * m + chain];

  // the pick(s): lane s scores slots s, s + 32, ...
  Pick pi{-INFINITY, INT_MAX, 0.0f, 0.0f, 0.0f};
  Pick pj = pi;
  bool any_i = false, any_j = false;
  for (int s = lane; s < cap; s += kWarp) {
    const bool occ = occs[own + s] > 0.5f;
    const float x = xs[own + s], y = ys[own + s], lab = labels[own + s];
    const float ui = u_first[s];
    if (kSwap) {
      const float uj = u_second[s];
      const bool is_b = lab > 0.5f;
      any_i |= occ && !is_b;
      any_j |= occ && is_b;
      keep_better(pi, Pick{(occ && !is_b) ? ui : -1.0f, s, x, y, lab});
      keep_better(pj, Pick{(occ && is_b) ? uj : -1.0f, s, x, y, lab});
    } else {
      any_i |= occ;
      keep_better(pi, Pick{occ ? ui : -1.0f, s, x, y, lab});
    }
  }
  const bool valid = __any_sync(kFullMask, any_i) &&
                     (!kSwap || __any_sync(kFullMask, any_j));
  if (!valid) {
    if (lane == 0) {
      cell_de[g] = 0.0f;
      cell_flags[g] = 0;
    }
    return;
  }
  pi = warp_argmax(pi);
  if (kSwap) pj = warp_argmax(pj);

  // the second probe: the displacement's new position, the swap's j
  float qx, qy;
  bool inbox = true;
  if (kSwap) {
    qx = pj.x;
    qy = pj.y;
  } else {
    const float sb = args[chain], halo = args[m + chain];
    qx = __fadd_rn(pi.x, __fmul_rn(sb, u_second[0]));
    qy = __fadd_rn(pi.y, __fmul_rn(sb, u_second[1]));
    // the anchor halo: the storage cell's origin (its index over nc) and
    // far edge (origin + 1 / nc), each widened by the halo
    const float w = static_cast<float>(1.0 / nc);
    const float ox = __fdiv_rn(static_cast<float>(gi), static_cast<float>(nc));
    const float oy = __fdiv_rn(static_cast<float>(gj), static_cast<float>(nc));
    inbox = qx >= __fsub_rn(ox, halo) &&
            qx < __fadd_rn(__fadd_rn(ox, w), halo) &&
            qy >= __fsub_rn(oy, halo) &&
            qy < __fadd_rn(__fadd_rn(oy, w), halo);
  }
  const float a_i = pi.label, a_j = kSwap ? pj.label : pi.label;
  const Row row_i = make_row(tab, a_i), row_j = make_row(tab, a_j);

  // the nine cells in the twin's offset order (-1, -1), (-1, 0), ...
  int nb[9];
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    nb[o] = (wrap(gi + o / 3 - 1, nc) * nc + wrap(gj + o % 3 - 1, nc)) * cap;
  }
  // rows: a displacement's (q, a_i), (p_i, a_i); a swap's (p_i, a_i),
  // (q, a_j), (p_i, a_j), (q, a_i)
  double e0 = 0.0, e1 = 0.0, e2 = 0.0, e3 = 0.0;
  for (int s = lane; s < cap; s += kWarp) {
    bool ok[9];
    float x[9], y[9], b[9];
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      ok[o] = occs[nb[o] + s] > 0.5f;
      x[o] = xs[nb[o] + s];
      y[o] = ys[nb[o] + s];
      b[o] = labels[nb[o] + s];
    }
    ok[4] = ok[4] && s != pi.slot && (!kSwap || s != pj.slot);
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      if (!ok[o]) continue;
      const float r2_p = dist2(x[o], y[o], pi.x, pi.y, box2);
      const float r2_q = dist2(x[o], y[o], qx, qy, box2);
      if (kSwap) {
        add_pair(e0, row_i, r2_p, b[o]);
        add_pair(e1, row_j, r2_q, b[o]);
        add_pair(e2, row_j, r2_p, b[o]);
        add_pair(e3, row_i, r2_q, b[o]);
      } else {
        add_pair(e0, row_i, r2_q, b[o]);
        add_pair(e1, row_i, r2_p, b[o]);
      }
    }
  }
  float d_e;
  if (kSwap) {
    const float f0 = warp_sum32(e0), f1 = warp_sum32(e1);
    const float f2 = warp_sum32(e2), f3 = warp_sum32(e3);
    d_e = __fsub_rn(__fadd_rn(f2, f3), __fadd_rn(f0, f1));
  } else {
    d_e = __fsub_rn(warp_sum32(e0), warp_sum32(e1));
  }
  if (lane != 0) return;
  const float neg_beta = args[2 * m + chain];
  const bool accept = inbox && logf(u_a) < __fmul_rn(neg_beta, d_e);
  if (accept) {
    if (kSwap) {
      labels[own + pi.slot] = a_j;
      labels[own + pj.slot] = a_i;
    } else {
      xs[own + pi.slot] = qx;
      ys[own + pi.slot] = qy;
    }
  }
  cell_de[g] = accept ? d_e : 0.0f;
  cell_flags[g] = accept ? 3 : 1;  // bit 0 attempted, bit 1 accepted
}

// A block a chain: its cells' accepted dE in float64, rounded once and
// added to its energy; its attempts and accepts added to column kind.
__global__ void __launch_bounds__(kSumThreads) chain_sums(
    const float* __restrict__ cell_de, const uint8_t* __restrict__ cell_flags,
    int per_chain, int kind, float* __restrict__ e,
    int32_t* __restrict__ att, int32_t* __restrict__ acc) {
  __shared__ double part_e[kSumThreads / kWarp];
  __shared__ int part_att[kSumThreads / kWarp], part_acc[kSumThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t chain = blockIdx.x;
  const float* de = cell_de + chain * per_chain;
  const uint8_t* fl = cell_flags + chain * per_chain;
  double sum = 0.0;
  int n_att = 0, n_acc = 0;
  for (int c = threadIdx.x; c < per_chain; c += kSumThreads) {
    sum = __dadd_rn(sum, static_cast<double>(de[c]));
    n_att += fl[c] & 1;
    n_acc += fl[c] >> 1;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    sum = __dadd_rn(sum, __shfl_xor_sync(kFullMask, sum, o));
    n_att += __shfl_xor_sync(kFullMask, n_att, o);
    n_acc += __shfl_xor_sync(kFullMask, n_acc, o);
  }
  if (lane == 0) {
    part_e[warp] = sum;
    part_att[warp] = n_att;
    part_acc[warp] = n_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / kWarp; ++w) {
      sum = __dadd_rn(sum, part_e[w]);
      n_att += part_att[w];
      n_acc += part_acc[w];
    }
    e[chain] = __fadd_rn(e[chain], __double2float_rn(sum));
    att[chain * 3 + kind] += n_att;
    acc[chain * 3 + kind] += n_acc;
  }
}

}  // namespace

// P (m, 4, nc, nc, cap) float32 packed cells, updated in place; first,
// second, u_acc the substep's draws (cell_moves); args (4, m) float32;
// tab the pair constants; e (m,) float32 energies and att, acc (m, 3) int32
// counters, added to in place; cell_de (m nc^2 / 4) float32 and cell_flags
// (m nc^2 / 4) uint8 scratch.  kind 0 displaces, 1 swaps; (px, py) is the
// colour's parity.  Returns the first launch error (0 on success).  Does
// not synchronise.
extern "C" int mc_cell_substep(float* P, const float* first,
                               const float* second, const float* u_acc,
                               const float* args, PairTable tab, float* e,
                               int32_t* att, int32_t* acc, float* cell_de,
                               uint8_t* cell_flags, int m, int nc, int cap,
                               int kind, int px, int py, void* stream) {
  if (m <= 0) return 0;
  if (nc < 4 || nc % 2 != 0 || cap < 1 || int64_t(nc) * nc * cap > INT_MAX ||
      (kind != 0 && kind != 1) || (px != 0 && px != 1) ||
      (py != 0 && py != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_chain = (nc / 2) * (nc / 2);
  const int64_t cells = int64_t(m) * per_chain;
  const unsigned blocks =
      static_cast<unsigned>((cells + kCellWarps - 1) / kCellWarps);
  if (kind == 0) {
    cell_moves<false><<<blocks, kCellWarps * kWarp, 0, s>>>(
        P, first, second, u_acc, args, tab, m, nc, cap, px, py, cell_de,
        cell_flags);
  } else {
    cell_moves<true><<<blocks, kCellWarps * kWarp, 0, s>>>(
        P, first, second, u_acc, args, tab, m, nc, cap, px, py, cell_de,
        cell_flags);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_sums<<<static_cast<unsigned>(m), kSumThreads, 0, s>>>(
      cell_de, cell_flags, per_chain, kind, e, att, acc);
  return static_cast<int>(cudaGetLastError());
}
