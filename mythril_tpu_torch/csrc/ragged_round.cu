// The ragged circuit-SLS round for Hopper (sm_90a).
//
// Replaces mythril_tpu/tpu/pallas_kernel.py `_round_fn` (the Pallas
// kernel launched at :466) and computes what it computes, bit for bit:
// for each restart lane, `steps` iterations of (1) simulate the combined
// AIG level by level over the real-gate stream, (2) per cone, found |= no
// violated root, (3) pick one violated root per (lane, cone) by the
// maximal counter-hash key, lowest index on ties, (4) walk the
// justification path back up to `walk_depth` gates, taking a hashed coin
// at ties, (5) flip the input reached; then a final simulate and check.
// Every random draw is keyed on the global lane and cone index, so the
// result does not depend on how lanes or cones are split over blocks.
//
// What bounds it on this card: neither bytes nor operations. One (lane,
// cone) pair is a chain of dependent steps: per step of the round, a
// simulate whose every level reads what the level before wrote, then a
// walk of up to `walk_depth` dependent gate visits (each visit's next gate
// depends on the x values it read). At the slice's sizes that is 65
// simulates of 516 levels plus 64 walks, each link a shared-memory round
// trip (some 30 cycles of load latency, plus the logic and the store),
// against about 0.01 ms of bytes.
//
// What the design does about it:
//  - Work item = (lane, cone). Cones are variable-disjoint pages and
//    every draw is keyed on (lane, cone), so the round splits exactly into
//    lanes x cones independent chains. A block serves one cone and
//    kLanesPerBlock (4) lanes, one warp per lane: the grid is
//    cones x ceil(lanes / 4) blocks, simulate steps are separated by
//    __syncwarp() alone, and the check runs over the roots warp-wide.
//  - The cone's tables (a record per local variable, the gates cut into
//    the warp's steps, the roots; cone-local 16-bit indices, built by
//    gpu/ragged_kernel.cone_layout) are copied into shared memory once per
//    launch by one TMA bulk copy completing on an mbarrier. No simulate
//    step and no walk depth reads global memory.
//  - The simulate takes two levels per step: a gate on the second level
//    of a pair reads a first-level child's inputs in its place, which
//    halves the chain. The next step's descriptors are read before this
//    step's x reads, stores are not masked (see simulate), and a walk
//    reads both children's records before it knows which it takes, so
//    only the x reads, the logic and the store stay on the chain.
//  - Each lane's x holds only its cone's page, one byte per variable in
//    shared memory; local var 0 is the constant FALSE, private to the
//    (lane, cone) pair and reset at every simulate. (The plain round
//    runs every walk before any flip and resets var 0 at every simulate,
//    so every read of var 0 sees 0; a flip of var 0 is undone unseen.)
//  - A pair whose cone is found stops: no later step flips it, so its
//    page is already what the remaining steps would give.
//  - A cone whose section plus one page per lane exceeds kSmemCap (about
//    8,000 variables at 4 lanes per block: 8 bytes of record, 16 of gate
//    and 4 of pages per variable) takes the global-table path in the same
//    kernel, over the 32-bit flat tables read through the read-only path.
//    A level of such a cone holds a few hundred gates, too many for one
//    warp to issue quickly. So there the block's 4 lanes are bit slices of
//    one shared page (a byte per variable, bit w for warp w's lane; 64 KiB
//    at most, so it always fits). All 128 threads simulate each gate once
//    for the 4 lanes, in passes of up to 512 gates of one level separated
//    by the block's barrier. The next 3 passes' descriptors are in flight
//    meanwhile (16-byte cp.async into a ring in shared memory), so the L2
//    is off the chain. Check, walk and flip stay per (lane, cone), in the
//    lane's warp.

// Merge rule of the returned x: columns owned by a cone get the evolved
// values, all other columns (var 0 and the padding past the last page)
// the INPUT x — what the TPU kernel's per-tile merge-write produces. The
// grid copies those columns, and sets found for padding cone slots.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 4;     // ragged_kernel.LANES_PER_BLOCK
constexpr int kPassGates = 512;       // ragged_kernel.GLOBAL_PASS
constexpr int kRing = 4;              // ragged_kernel.GLOBAL_RING
// a ring stage: 5 descriptor fields of kPassGates ints, then the pass's
// {begin, end} (padded to 16 bytes)
constexpr int kStageInts = 5 * kPassGates + 4;
static_assert(kPassGates == 4 * 32 * kLanesPerBlock,
              "a thread takes one 16-byte chunk of each descriptor field");
constexpr int kSmemCap = 224 * 1024;  // ragged_kernel.SMEM_CAP
constexpr int kHeaderWords = 16;      // ragged_kernel.HEADER_WORDS
// ragged_kernel.H_* header columns
enum {
  kBase, kSize, kLevels, kPath, kSection, kSectionBytes, kStepOff,
  kGateOff, kRootOff, kPageBytes, kSteps
};
constexpr int kPathShared = 0;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

constexpr uint32_t kStep = 0x9E3779B9u, kLane = 0x85EBCA6Bu,
                   kCone = 0xC2B2AE35u, kRoot = 0x27D4EB2Fu,
                   kCoin = 0x94D049BBu, kDepth = 0x165667B1u;

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  v = (v ^ (v >> 16)) * 0x7FEB352Du;
  v = (v ^ (v >> 15)) * 0x846CA68Bu;
  return v ^ (v >> 16);
}

struct Node {
  int is_gate, a, an, b, bn;
};

// The 32-bit flat tables (ragged_kernel.GLOBAL_PATH_KEYS), combined
// variable indices.
struct Flat {
  const int* g_out;
  const int* g_a;
  const int* g_an;
  const int* g_b;
  const int* g_bn;
  const int* ga_var;
  const int* ga_neg;
  const int* gb_var;
  const int* gb_neg;
  const int* is_gate;
  const int* root_var;
  const int* root_neg;
  const int* root_mask;
};

// A cone whose section sits in this block's shared memory; indices are
// cone-local (combined - base + 1, 0 = the constant).
struct SharedCone {
  uint8_t* xs;            // this lane's page, [size + 1]
  const uint2* records;   // [size + 1] {a | b << 16, an | bn << 1 | gate << 2}
  const uint16_t* steps;  // [num_steps + 1] offsets into gates
  const uint4* gates;     // level order, then GATE_PAD (32) zero gates:
                          // {out | a0 << 16, a1 | b0 << 16, b1 | bits, 0}
  const uint32_t* roots;  // [num_roots] local << 2 | neg << 1 | live

  __device__ Node node(int v) const {
    const uint2 r = records[v];
    return {static_cast<int>((r.y >> 2) & 1u),
            static_cast<int>(r.x & 0xFFFFu), static_cast<int>(r.y & 1u),
            static_cast<int>(r.x >> 16), static_cast<int>((r.y >> 1) & 1u)};
  }
  __device__ void root(int r, int& var, int& neg, int& live) const {
    const uint32_t w = roots[r];
    var = static_cast<int>(w >> 2);
    neg = static_cast<int>((w >> 1) & 1u);
    live = static_cast<int>(w & 1u);
  }
  __device__ int x(int v) const { return xs[v]; }
  __device__ void set_x(int v, int value) {
    xs[v] = static_cast<uint8_t>(value);
  }
};

// A cone too large for shared memory: the flat tables through the
// read-only path (combined indices), and the block's lanes bit-sliced in
// one shared page: byte l is local variable l = combined - shift, bit
// `bit` of it this warp's lane. Var 0 is read as 0 and never written (the
// merge rule returns the input there).
struct SlicedCone {
  uint8_t* page;          // [size + 1], 4-byte aligned
  int* ring;              // [kRing][kStageInts] gate descriptors
  const int2* passes;     // {begin, end} in the flat gate stream, then {0, 0}
  Flat f;
  int shift;              // base - 1
  int root_row;           // cone * root_cap
  int bit;                // the warp's lane within the block

  __device__ int local(int v) const { return v ? v - shift : 0; }
  __device__ Node node(int v) const {
    return {__ldg(f.is_gate + v), __ldg(f.ga_var + v), __ldg(f.ga_neg + v),
            __ldg(f.gb_var + v), __ldg(f.gb_neg + v)};
  }
  __device__ void root(int r, int& var, int& neg, int& live) const {
    var = __ldg(f.root_var + root_row + r);
    neg = __ldg(f.root_neg + root_row + r);
    live = __ldg(f.root_mask + root_row + r) == 1;
  }
  __device__ int x(int v) const { return (page[local(v)] >> bit) & 1; }
  // the walk's flip: other warps may flip bits of the same word
  __device__ void set_x(int v, int value) {
    if (!v) return;
    const int l = local(v);
    uint32_t* word = reinterpret_cast<uint32_t*>(page) + (l >> 2);
    const uint32_t mask = 1u << (8 * (l & 3) + bit);
    if (value)
      atomicOr(word, mask);
    else
      atomicAnd(word, ~mask);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously: the first `bytes` of them
// from src, zeros for the rest
__device__ __forceinline__ void copy_async16(int* dst, const int* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Fetch a pass's descriptors into a ring stage as one cp.async group:
// the 16-byte-aligned span from the pass's begin rounded down, thread i
// taking its chunk i of each field (cone_layout keeps the span within
// kPassGates). Thread i later reads that chunk alone; the pass's bounds,
// stored by thread 0, are read by all after later barriers.
__device__ __forceinline__ void fetch_pass(const SlicedCone& cone, int2 run,
                                           int* stage, int i) {
  const int first = (run.x & ~3) + 4 * i;
  const int bytes = 4 * max(0, min(4, run.y - first));
  const int from = bytes ? first : 0;
  copy_async16(stage + 4 * i, cone.f.g_out + from, bytes);
  copy_async16(stage + kPassGates + 4 * i, cone.f.g_a + from, bytes);
  copy_async16(stage + 2 * kPassGates + 4 * i, cone.f.g_an + from, bytes);
  copy_async16(stage + 3 * kPassGates + 4 * i, cone.f.g_b + from, bytes);
  copy_async16(stage + 4 * kPassGates + 4 * i, cone.f.g_bn + from, bytes);
  if (i == 0) *reinterpret_cast<int2*>(stage + 5 * kPassGates) = run;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The global-table path's pass (ragged_kernel.cone_layout), block-wide:
// the cone's gates in passes of at most kPassGates gates, each inside one
// level, so a pass reads only what earlier passes wrote; each gate is
// evaluated once for the block's 4 lanes (their bits of the page). The
// ring holds the next kRing - 1 passes' descriptors in flight, and the
// bounds of the pass after those are loaded a pass early.
__device__ void simulate(SlicedCone& cone, int num_passes, int /*t*/) {
  __syncthreads();  // the flips (or the page's copy-in) are done
  if (num_passes <= 0) return;
  const int i = threadIdx.x;
  uint8_t* page = cone.page;
  // passes[num_passes] is {0, 0}: a stage of zero gates
  for (int d = 0; d < kRing - 1; ++d)
    fetch_pass(cone, __ldg(cone.passes + min(d, num_passes)),
               cone.ring + d * kStageInts, i);
  int2 ahead = __ldg(cone.passes + min(kRing - 1, num_passes));
  for (int s = 0; s < num_passes; ++s) {
    const int2 run = ahead;
    ahead = __ldg(cone.passes + min(s + kRing, num_passes));
    fetch_pass(cone, run, cone.ring + (s + kRing - 1) % kRing * kStageInts,
               i);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    const int* stage = cone.ring + s % kRing * kStageInts;
    const int2 own = *reinterpret_cast<const int2*>(stage + 5 * kPassGates);
    const int first = (own.x & ~3) + 4 * i;
    const int4 out = *reinterpret_cast<const int4*>(stage + 4 * i);
    const int4 a = *reinterpret_cast<const int4*>(stage + kPassGates + 4 * i);
    const int4 an =
        *reinterpret_cast<const int4*>(stage + 2 * kPassGates + 4 * i);
    const int4 b =
        *reinterpret_cast<const int4*>(stage + 3 * kPassGates + 4 * i);
    const int4 bn =
        *reinterpret_cast<const int4*>(stage + 4 * kPassGates + 4 * i);
    const int gate_out[4] = {out.x, out.y, out.z, out.w};
    const int gate_a[4] = {a.x, a.y, a.z, a.w};
    const int gate_an[4] = {an.x, an.y, an.z, an.w};
    const int gate_b[4] = {b.x, b.y, b.z, b.w};
    const int gate_bn[4] = {bn.x, bn.y, bn.z, bn.w};
    int dst[4];
    uint32_t value[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      // the span's leading gates before the pass belong to other runs:
      // they become the zero gate. Selects, not a branch: a guarded read
      // compiles to a branch per slot that serializes the slots' reads.
      const bool live = first + m >= own.x;
      dst[m] = live ? cone.local(gate_out[m]) : 0;
      const int in_a = live ? cone.local(gate_a[m]) : 0;
      const int in_b = live ? cone.local(gate_b[m]) : 0;
      const uint32_t neg_a = live ? 0u - gate_an[m] : 0u;
      const uint32_t neg_b = live ? 0u - gate_bn[m] : 0u;
      value[m] = (page[in_a] ^ neg_a) & (page[in_b] ^ neg_b) & 0xFu;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) page[dst[m]] = static_cast<uint8_t>(value[m]);
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // ring free for reuse
}

// The shared-memory path's pass (ragged_kernel.cone_layout): the warp
// takes the cone in steps of at most 32 gates, two levels per step; a gate
// on the second level of a pair reads a first-level child's two inputs in
// its place, so a step reads only what earlier steps wrote and the chain
// is half the cone's depth. Descriptors do not depend on x: the next
// step's are read before this step's x reads. Stores are not masked:
// thread t always takes gate first + t, and past the step's end that is a
// later gate (its early value is never read: its readers come in later
// steps than its own, which rewrites it) or a zero gate of the padding
// (var 0 := 0). No branch, no reconvergence: per step the chain is the x
// reads, a few logic ops, the store and the __syncwarp().
__device__ __forceinline__ uint32_t paired_gate_value(const uint8_t* xs,
                                                      uint4 g) {
  const uint32_t ca = (xs[g.x >> 16] ^ ((g.z >> 16) & 1u)) &
                      (xs[g.y & 0xFFFFu] ^ ((g.z >> 17) & 1u));
  const uint32_t cb = (xs[g.y >> 16] ^ ((g.z >> 18) & 1u)) &
                      (xs[g.z & 0xFFFFu] ^ ((g.z >> 19) & 1u));
  return (ca ^ ((g.z >> 20) & 1u)) & (cb ^ ((g.z >> 21) & 1u));
}

__device__ __forceinline__ void simulate(SharedCone& cone, int num_steps,
                                         int t) {
  uint8_t* xs = cone.xs;
  if (t == 0) xs[0] = 0;
  __syncwarp();
  if (num_steps <= 0) return;
  const uint16_t* steps = cone.steps;
  int next_first = steps[1];
  int after = steps[num_steps > 1 ? 2 : 1];
  uint4 g = cone.gates[steps[0] + t];
  for (int s = 0; s < num_steps; ++s) {
    const uint4 next = cone.gates[next_first + t];
    const int later = steps[s + 3 < num_steps ? s + 3 : num_steps];
    xs[g.x & 0xFFFFu] = static_cast<uint8_t>(paired_gate_value(xs, g));
    __syncwarp();
    next_first = after;
    after = later;
    g = next;
  }
}

// True when no root of the cone is violated; otherwise `choice` is the
// violated root of maximal key (hash >> 1), the lowest index on ties. The
// warp splits the roots and reduces; every thread gets the answer.
template <class Cone>
__device__ bool check(const Cone& cone, int num_roots, uint32_t key_base,
                      int t, int& choice) {
  int best_key = -1;
  int best = 0;
  for (int r = t; r < num_roots; r += 32) {
    int var, neg, live;
    cone.root(r, var, neg, live);
    if (!live || (cone.x(var) ^ neg) != 0) continue;
    const int key = static_cast<int>(
        hash32(key_base ^ (static_cast<uint32_t>(r) * kRoot)) >> 1);
    if (key > best_key) {
      best_key = key;
      best = r;
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const int other_key = __shfl_xor_sync(kFullWarp, best_key, offset);
    const int other = __shfl_xor_sync(kFullWarp, best, offset);
    if (other_key > best_key || (other_key == best_key && other < best)) {
      best_key = other_key;
      best = other;
    }
  }
  choice = best;
  return best_key < 0;
}

// The justification walk from (cur, want), run alike by every thread of
// the warp (the same shared addresses: broadcasts), then one flip.
template <class Cone>
__device__ void walk_and_flip(Cone& cone, int cur, int want, int walk_depth,
                              uint32_t coin_base, int t) {
  Node n = cone.node(cur);
  for (int depth = 0; depth < walk_depth && n.is_gate == 1; ++depth) {
    const int av = cone.x(n.a) ^ n.an;
    const int bv = cone.x(n.b) ^ n.bn;
    // both children's records before the choice is known: one round of
    // loads per depth
    const Node na = cone.node(n.a);
    const Node nb = cone.node(n.b);
    if ((av & bv) == want) break;  // justified: nothing to repair
    const int coin = static_cast<int>(
        hash32(coin_base ^ (static_cast<uint32_t>(depth) * kDepth)) & 1u);
    // want 1: descend into a false child; want 0: into a true one
    const bool choose_b =
        want == 1 ? ((av == 1 && bv == 0) || (av == 0 && bv == 0 && coin))
                  : ((av == 0 && bv == 1) || (av == 1 && bv == 1 && coin));
    cur = choose_b ? n.b : n.a;
    want ^= choose_b ? n.bn : n.an;
    n = choose_b ? nb : na;
  }
  __syncwarp();  // every thread's x reads are done before the flip
  if (t == 0) cone.set_x(cur, want);
}

// One (lane, cone) pair through the round; returns found. `passes` is
// the length of the cone's simulate loop (steps or passes).
template <class Cone>
__device__ bool run_pair(Cone& cone, int passes, int num_roots,
                         uint32_t salt, int steps, int walk_depth,
                         uint32_t seed, int t) {
  for (int step = 0; step < steps; ++step) {
    simulate(cone, passes, t);
    const uint32_t step_key =
        hash32(seed ^ (static_cast<uint32_t>(step) * kStep));
    int choice;
    // found is final: a found cone never flips, so later steps and the
    // final simulate leave its page as it is now
    if (check(cone, num_roots, step_key ^ salt, t, choice)) return true;
    int var, neg, live;
    cone.root(choice, var, neg, live);
    walk_and_flip(cone, var, 1 ^ neg, walk_depth, step_key ^ kCoin ^ salt,
                  t);
  }
  // final simulate: returned assignments must be gate-consistent
  simulate(cone, passes, t);
  int choice;
  return check(cone, num_roots, 0u, t, choice);
}

// The block's lanes through the round on the global-table path: each
// step simulates the 4 lanes together, then each unfound lane checks,
// walks and flips in its warp. `found` starts true for a warp past the
// last lane. When every lane is found the pages are final (a found lane
// never flips), as in run_pair.
__device__ bool run_lanes(SlicedCone& cone, int passes, int num_roots,
                          uint32_t salt, int steps, int walk_depth,
                          uint32_t seed, int t, bool found) {
  int choice;
  for (int step = 0; step < steps; ++step) {
    simulate(cone, passes, t);
    if (!found) {  // warp-uniform
      const uint32_t step_key =
          hash32(seed ^ (static_cast<uint32_t>(step) * kStep));
      found = check(cone, num_roots, step_key ^ salt, t, choice);
      if (!found) {
        int var, neg, live;
        cone.root(choice, var, neg, live);
        walk_and_flip(cone, var, 1 ^ neg, walk_depth,
                      step_key ^ kCoin ^ salt, t);
      }
    }
    if (__syncthreads_and(found)) return true;
  }
  simulate(cone, passes, t);
  return found || check(cone, num_roots, 0u, t, choice);
}

// Wait for the first phase of the mbarrier (the table copy) to complete.
__device__ __forceinline__ void wait_tables(uint32_t bar) {
  const uint32_t parity = 0;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Columns no cone owns (var 0 and [v1, var_cap)) get the input's values;
// padding cone slots are found. Grid-stride over every thread.
__device__ void copy_unowned(const int* __restrict__ x_in, int* x_out,
                             uint8_t* __restrict__ found_out, int lanes,
                             int var_cap, int cone_cap, int num_cones,
                             int v1) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_lane = 1 + var_cap - v1;
#pragma unroll 4
  for (int e = first; e < lanes * per_lane; e += stride) {
    const int lane = e / per_lane;
    const int j = e - lane * per_lane;
    const size_t idx = static_cast<size_t>(lane) * var_cap +
                       (j == 0 ? 0 : v1 + j - 1);
    x_out[idx] = x_in[idx];
  }
  const int pad = cone_cap - num_cones;
  for (int e = first; e < lanes * pad; e += stride) {
    const int lane = e / pad;
    found_out[static_cast<size_t>(lane) * cone_cap + num_cones +
              (e - lane * pad)] = 1;
  }
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
ragged_round_kernel(Flat f, const int* __restrict__ header,
                    const uint8_t* __restrict__ blob,
                    const int* __restrict__ x_in, int* x_out,
                    uint8_t* __restrict__ found_out, int lanes, int var_cap,
                    int cone_cap, int root_cap, int num_cones, int num_roots,
                    int v1, int steps, int walk_depth, uint32_t seed,
                    int groups) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t tables_ready;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int c = blockIdx.x / groups;
  const int lane = (blockIdx.x % groups) * (blockDim.x >> 5) + warp;
  if (c >= num_cones) {  // a stream of no cones: the merge copy only
    copy_unowned(x_in, x_out, found_out, lanes, var_cap, cone_cap,
                 num_cones, v1);
    return;
  }
  const int* h = header + c * kHeaderWords;
  const int base = __ldg(h + kBase);
  const int size = __ldg(h + kSize);
  const int section = __ldg(h + kSection);
  const int section_bytes = __ldg(h + kSectionBytes);
  const int passes = __ldg(h + kSteps);
  const bool in_smem = __ldg(h + kPath) == kPathShared;
  const uint32_t bar = smem_u32(&tables_ready);
  if (in_smem) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(section_bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
          "l"(reinterpret_cast<uint64_t>(blob + section)),
          "r"(section_bytes), "r"(bar)
          : "memory");
    }
  }
  // the merge copy overlaps the table copy
  copy_unowned(x_in, x_out, found_out, lanes, var_cap, cone_cap, num_cones,
               v1);
  const uint32_t salt = static_cast<uint32_t>(lane) * kLane ^
                        static_cast<uint32_t>(c) * kCone;
  bool found;
  if (in_smem) {
    if (lane >= lanes) return;  // no block-wide barrier follows
    const int* row_in = x_in + static_cast<size_t>(lane) * var_cap + base;
    int* row_out = x_out + static_cast<size_t>(lane) * var_cap + base;
    uint8_t* xs = smem + section_bytes + warp * __ldg(h + kPageBytes);
#pragma unroll 8
    for (int j = t; j < size; j += 32)
      xs[j + 1] = static_cast<uint8_t>(row_in[j]);
    wait_tables(bar);
    SharedCone cone{
        xs, reinterpret_cast<const uint2*>(smem),
        reinterpret_cast<const uint16_t*>(smem + __ldg(h + kStepOff)),
        reinterpret_cast<const uint4*>(smem + __ldg(h + kGateOff)),
        reinterpret_cast<const uint32_t*>(smem + __ldg(h + kRootOff))};
    found = run_pair(cone, passes, num_roots, salt, steps, walk_depth,
                     seed, t);
#pragma unroll 8
    for (int j = t; j < size; j += 32) row_out[j] = xs[j + 1];
  } else {
    // the block's lanes as bits of one byte per local variable
    const int lane0 = lane - warp;
    const int here = min(lanes - lane0, kLanesPerBlock);
    const size_t first = static_cast<size_t>(lane0) * var_cap + base;
    if (threadIdx.x == 0) smem[0] = 0;
    for (int j = threadIdx.x; j < size; j += blockDim.x) {
      uint32_t byte = 0;
      for (int w = 0; w < here; ++w)
        byte |= static_cast<uint32_t>(
                    x_in[first + static_cast<size_t>(w) * var_cap + j] != 0)
                << w;
      smem[j + 1] = static_cast<uint8_t>(byte);
    }
    SlicedCone cone{smem,
                    reinterpret_cast<int*>(smem + __ldg(h + kPageBytes)),
                    reinterpret_cast<const int2*>(blob + section), f,
                    base - 1, c * root_cap, warp};
    found = run_lanes(cone, passes, num_roots, salt, steps, walk_depth, seed,
                      t, lane >= lanes);
    __syncthreads();
    for (int j = threadIdx.x; j < size; j += blockDim.x) {
      const uint32_t byte = smem[j + 1];
      for (int w = 0; w < here; ++w)
        x_out[first + static_cast<size_t>(w) * var_cap + j] = (byte >> w) & 1;
    }
    if (lane >= lanes) return;
  }
  if (t == 0)
    found_out[static_cast<size_t>(lane) * cone_cap + c] = found ? 1 : 0;
}

}  // namespace

extern "C" {

// Launch one round on `stream` (a cudaStream_t passed as a pointer).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int ragged_round_launch(
    const int* g_out, const int* g_a, const int* g_an, const int* g_b,
    const int* g_bn, const int* ga_var, const int* ga_neg, const int* gb_var,
    const int* gb_neg, const int* is_gate, const int* root_var,
    const int* root_neg, const int* root_mask, const int* header,
    const uint8_t* blob, const int* x_in, int* x_out, uint8_t* found,
    int lanes, int var_cap, int cone_cap, int root_cap, int num_cones,
    int num_roots, int v1, int steps, int walk_depth, unsigned int seed,
    int smem_bytes, void* stream) {
  if (smem_bytes < 0 || smem_bytes > kSmemCap || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in shared-memory cap, once per process and device
  static std::atomic<unsigned long long> configured{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(configured.load() & bit)) {
    err = cudaFuncSetAttribute(ragged_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemCap);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured.fetch_or(bit);
  }
  const Flat f{g_out,   g_a,     g_an,     g_b,      g_bn,
               ga_var,  ga_neg,  gb_var,   gb_neg,   is_gate,
               root_var, root_neg, root_mask};
  const int groups = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  const int blocks = (num_cones > 0 ? num_cones : 1) * groups;
  ragged_round_kernel<<<blocks, 32 * kLanesPerBlock, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      f, header, blob, x_in, x_out, found, lanes, var_cap, cone_cap,
      root_cap, num_cones, num_roots, v1, steps, walk_depth, seed, groups);
  return static_cast<int>(cudaGetLastError());
}

const char* ragged_round_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
