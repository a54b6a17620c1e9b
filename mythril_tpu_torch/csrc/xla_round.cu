// K2, the XLA-semantics ragged round, for Hopper (sm_90a).
//
// Replaces mythril_tpu/tpu/circuit.py `run_round_ragged` (:557, with
// `_walk_ragged` :517 and `_simulate` :398), an XLA program, and computes
// what gpu/xla_kernel.run_round_xla_plain computes, bit for bit: for each
// restart lane, `steps` iterations of (1) x[0] = 0 and simulate the
// stream's padded [levels, width] gate tables level by level, (2) per
// cone, found |= no violated root, (3) pick the violated root of maximal
// counter-hash key (lowest index on ties; a found cone parks on var 0),
// (4) walk the justification path back up to `walk_depth` gates, taking
// a hashed coin at ties, (5) flip the input reached; then a final reset,
// simulate and check. The hash, its salts and its keys are K1's
// (csrc/ragged_round.cu), keyed on the global lane and cone index.
//
// K2 has no capacities: it takes the windows K1 cannot (the fallback of
// the pallas mode) and every stream of the xla mode. This first design is
// the simple one:
//  - one block of kThreads threads per restart lane (grid = lanes);
//  - the lane's x row lives in global memory (x_out), where it stays
//    resident in L2; every row offset is a 64-bit product;
//  - the simulate strides the block's threads over a level's first
//    level_rows[l] columns, skips padding cells (out_idx == 0) and puts
//    __syncthreads() between levels (a level of padding alone is
//    skipped with no barrier: it writes nothing);
//  - the check, the pick and the walk stride the threads over the cones;
//    each walk's end is written to a scratch row, and every walk of the
//    lane completes (a barrier) before any flip is written, so no walk
//    reads a value another cone's flip changed. Cones are
//    variable-disjoint pages except var 0, and a flip of var 0 is never
//    written: every simulate resets it before anything reads it.
// x in shared memory where V1 fits, bit-sliced lanes (as K3 does) and more
// than one block a lane are the open items (ROADMAP.md, section 2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // xla_kernel.THREADS

constexpr uint32_t kStep = 0x9E3779B9u, kLane = 0x85EBCA6Bu,
                   kCone = 0xC2B2AE35u, kRoot = 0x27D4EB2Fu,
                   kCoin = 0x94D049BBu, kDepth = 0x165667B1u;

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  v = (v ^ (v >> 16)) * 0x7FEB352Du;
  v = (v ^ (v >> 15)) * 0x846CA68Bu;
  return v ^ (v >> 16);
}

__device__ void simulate(int* x, const int* __restrict__ out_idx,
                         const int* __restrict__ a_var,
                         const int* __restrict__ a_neg,
                         const int* __restrict__ b_var,
                         const int* __restrict__ b_neg,
                         const int* __restrict__ level_rows, int levels,
                         int width) {
  if (threadIdx.x == 0) x[0] = 0;
  __syncthreads();
  for (int l = 0; l < levels; ++l) {
    const int rows = min(__ldg(level_rows + l), width);
    if (rows <= 0) continue;  // the same for every thread of the block
    const size_t row = static_cast<size_t>(l) * width;
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int out = __ldg(out_idx + row + i);
      if (out == 0) continue;
      const int a = x[__ldg(a_var + row + i)] ^ __ldg(a_neg + row + i);
      const int b = x[__ldg(b_var + row + i)] ^ __ldg(b_neg + row + i);
      x[out] = a & b;
    }
    __syncthreads();
  }
}

// True when no root of cone c is violated; otherwise `choice` is the
// violated root of maximal key (hash >> 1), the lowest index on ties.
__device__ bool check(const int* x, const int* __restrict__ root_var,
                      const int* __restrict__ root_neg,
                      const int* __restrict__ root_mask, int c, int roots,
                      uint32_t key_base, int& choice) {
  const size_t base = static_cast<size_t>(c) * roots;
  int best_key = -1;
  int best = 0;
  for (int r = 0; r < roots; ++r) {
    if (__ldg(root_mask + base + r) != 1) continue;
    if ((x[__ldg(root_var + base + r)] ^ __ldg(root_neg + base + r)) != 0)
      continue;
    const int key = static_cast<int>(
        hash32(key_base ^ (static_cast<uint32_t>(r) * kRoot)) >> 1);
    if (key > best_key) {
      best_key = key;
      best = r;
    }
  }
  choice = best;
  return best_key < 0;
}

__global__ void __launch_bounds__(kThreads) xla_round_kernel(
    const int* __restrict__ out_idx, const int* __restrict__ a_var,
    const int* __restrict__ a_neg, const int* __restrict__ b_var,
    const int* __restrict__ b_neg, const int* __restrict__ level_rows,
    const int* __restrict__ ga_var, const int* __restrict__ ga_neg,
    const int* __restrict__ gb_var, const int* __restrict__ gb_neg,
    const int* __restrict__ is_gate, const int* __restrict__ root_var,
    const int* __restrict__ root_neg, const int* __restrict__ root_mask,
    const int* __restrict__ x_in, int* __restrict__ x_out,
    uint8_t* __restrict__ found_out, int2* __restrict__ flips, int v1,
    int levels, int width, int cones, int roots, int steps, int walk_depth,
    uint32_t seed) {
  const int lane = blockIdx.x;
  int* x = x_out + static_cast<size_t>(lane) * v1;
  const int* row_in = x_in + static_cast<size_t>(lane) * v1;
  uint8_t* found = found_out + static_cast<size_t>(lane) * cones;
  int2* flip = flips + static_cast<size_t>(lane) * cones;
  for (int j = threadIdx.x; j < v1; j += kThreads) x[j] = row_in[j];
  for (int c = threadIdx.x; c < cones; c += kThreads) found[c] = 0;
  const uint32_t lane_salt = static_cast<uint32_t>(lane) * kLane;

  for (int step = 0; step < steps; ++step) {
    simulate(x, out_idx, a_var, a_neg, b_var, b_neg, level_rows, levels,
             width);
    const uint32_t step_key =
        hash32(seed ^ (static_cast<uint32_t>(step) * kStep));
    for (int c = threadIdx.x; c < cones; c += kThreads) {
      const uint32_t salt = lane_salt ^ static_cast<uint32_t>(c) * kCone;
      int choice;
      const bool done = found[c] ||
                        check(x, root_var, root_neg, root_mask, c, roots,
                              step_key ^ salt, choice);
      int2 end = make_int2(0, 0);  // a found cone flips nothing
      if (done) {
        found[c] = 1;
      } else {
        const size_t r = static_cast<size_t>(c) * roots + choice;
        int cur = __ldg(root_var + r);
        int want = 1 ^ __ldg(root_neg + r);
        const uint32_t coin_base = step_key ^ kCoin ^ salt;
        for (int depth = 0; depth < walk_depth; ++depth) {
          if (__ldg(is_gate + cur) != 1) break;
          const int ai = __ldg(ga_var + cur), an = __ldg(ga_neg + cur);
          const int bi = __ldg(gb_var + cur), bn = __ldg(gb_neg + cur);
          const int av = x[ai] ^ an;
          const int bv = x[bi] ^ bn;
          if ((av & bv) == want) break;  // justified
          const bool coin =
              hash32(coin_base ^ (static_cast<uint32_t>(depth) * kDepth)) &
              1u;
          const bool take_b =
              want == 1 ? ((av == 1 && bv == 0) || (av == 0 && bv == 0 && coin))
                        : ((av == 0 && bv == 1) || (av == 1 && bv == 1 && coin));
          cur = take_b ? bi : ai;
          want ^= take_b ? bn : an;
        }
        end = make_int2(cur, want);
      }
      flip[c] = end;
    }
    __syncthreads();  // every walk of the lane has read x
    for (int c = threadIdx.x; c < cones; c += kThreads) {
      const int2 end = flip[c];
      if (end.x > 0) x[end.x] = end.y;
    }
    __syncthreads();
  }
  simulate(x, out_idx, a_var, a_neg, b_var, b_neg, level_rows, levels,
           width);
  for (int c = threadIdx.x; c < cones; c += kThreads) {
    int choice;
    if (found[c] || check(x, root_var, root_neg, root_mask, c, roots, 0u,
                          choice))
      found[c] = 1;
  }
}

}  // namespace

extern "C" {

// Launch one round on `stream` (a cudaStream_t passed as a pointer).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int xla_round_launch(
    const int* out_idx, const int* a_var, const int* a_neg, const int* b_var,
    const int* b_neg, const int* level_rows, const int* ga_var,
    const int* ga_neg, const int* gb_var, const int* gb_neg,
    const int* is_gate, const int* root_var, const int* root_neg,
    const int* root_mask, const int* x_in, int* x_out, uint8_t* found,
    int* flips, int lanes, int v1, int levels, int width, int cones,
    int roots, int steps, int walk_depth, unsigned int seed, void* stream) {
  if (lanes < 1 || v1 < 2 || levels < 1 || width < 1 || cones < 1 ||
      roots < 1 || steps < 0 || walk_depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  xla_round_kernel<<<lanes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out_idx, a_var, a_neg, b_var, b_neg, level_rows, ga_var, ga_neg,
      gb_var, gb_neg, is_gate, root_var, root_neg, root_mask, x_in, x_out,
      found, reinterpret_cast<int2*>(flips), v1, levels, width, cones, roots,
      steps, walk_depth, seed);
  return static_cast<int>(cudaGetLastError());
}

const char* xla_round_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
