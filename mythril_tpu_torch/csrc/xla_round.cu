// K2, the XLA-semantics ragged round, for Hopper (sm_90a).
//
// Replaces mythril_tpu/tpu/circuit.py `run_round_ragged` (:557, with
// `_walk_ragged` :517 and `_simulate` :398), an XLA program, and computes
// what gpu/xla_kernel.run_round_xla_plain computes, bit for bit: for each
// restart lane, `steps` iterations of (1) x[0] = 0 and simulate the
// stream's gates level by level, (2) per cone, found |= no violated root,
// (3) pick the violated root of maximal counter-hash key (lowest index on
// ties; a found cone flips nothing), (4) walk the justification path back
// up to `walk_depth` gates, taking a hashed coin at ties, (5) flip the
// input reached; then a final reset, simulate and check. The hash, its
// salts and its keys are K1's (csrc/ragged_round.cu), keyed on the global
// lane and the cone slot.
//
// K2 has no capacities: it takes the windows K1 cannot (the fallback of
// the pallas mode) and every stream of the xla mode.
//
// What bounds it. A step is a serial chain: each level of the simulate
// reads what the levels before it wrote, the root check reads the last,
// and the walk is a chain of dependent reads one gate long each. The
// bytes are few, so the length of one link of the chain, and the
// instructions issued per link, bound the round. K2's first design made
// every link a chain of L2 round trips: a block of 256 threads a
// lane with x in global memory, each level a strided sweep of the
// combined level's width ending in a block barrier, and the walks of 1 to
// 4 cones run by as many threads while the rest of the block waited.
//
// This design: the cones of a stream are variable-disjoint pages that
// share only var 0 (which every simulate resets before anything reads
// it), so one combined round is exactly one round per cone over its own
// page, and each cone runs as K3 (csrc/circuit_round.cu) runs a query,
// with K3's warp-level pieces (csrc/sliced_round.cuh):
//  - A block a (cone, group of restart lanes), lanes bit-sliced: lane k of
//    the group is bit k of one word per local variable, in shared memory.
//    Warp 0 runs the round; a gate is one AND of two XOR-masked words for
//    every lane at once, the warp's 32 threads take 32 gates at a time,
//    and steps are separated by __syncwarp(), not by a block barrier. No
//    block waits on another cone, so the round takes as long as its
//    longest cone's chain.
//  - The per-cone layout (gpu/xla_kernel.xla_layout, built on the device
//    once per stream): the cone's variables renumbered to its page, its
//    real-gate stream in K3's slots (its levels with a live cell paired
//    two a step, a second-level cell reading a first-level child's own
//    inputs, so a step reads only what earlier steps wrote), its records
//    (is_gate folded in) and its roots, at offsets in a header row
//    (struct Cone). The bucket's padding and the other cones' cells are
//    never read.
//  - One TMA bulk copy on an mbarrier brings the records (and a stream
//    that fits) into shared memory while the block's 16 warps pack the
//    page of x from the group's [lanes, V1] rows; a stream that does not
//    fit streams through a ring of kRing cp.async chunks. Thread k checks
//    lane k's roots, walks lane k's chain in lockstep with the warp,
//    reading both children's records before it knows which one it takes,
//    and flips with atomicOr / atomicAnd on the word, after every walk of
//    the warp has read x. A group whose lanes have all found a model
//    stops: no later step would change its x.
//  - Tiers by the cone's own page (xla_kernel.cone_shape, K3's
//    launch_shape), chosen per block, so cones of different tiers share
//    one launch:
//      shared32  page V1 <= 16,384: 32 lanes a word, records and x in
//                shared memory;
//      shared16  <= 32,768: 16 lanes a word;
//      xshared   x alone in shared memory at 32, 16 or 8 lanes a word
//                (the widest that fits beside the ring), the records in
//                global memory;
//      global    past that: x's words in global memory (x_work).
//  - A second kernel copies the variables past the last page through,
//    writes var 0 = 0 and marks the padding cone slots (no live root)
//    found; the blocks write back only their pages.
//
// The launch's shape: a 4-cone stream at 64 lanes is 8 warps at 32 lanes
// a word, on 8 of the card's 132 SMs. Narrower words give more warps, but
// every warp of a cone runs the same simulate, so they cannot shorten its
// chain; they shorten only the walks (a warp walks until its longest lane
// ends) and the early stop. The chain's length decides the time: on an
// H100 80GB HBM3 at 700 W, a 37,381-variable cone at 64 lanes took 20%
// longer at 16 lanes a word and 4% longer at 8 than at 32 (PERF.md), so
// each cone keeps K3's widest word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_round.cuh"

namespace {

constexpr int kThreads = 512;       // xla_kernel.THREADS
constexpr int kCopyThreads = 256;   // xla_kernel.COPY_THREADS

// A cone's header row: xla_kernel.CONE_FIELDS, in order.
struct Cone {
  int base;            // combined index of local var 1
  int v1;              // local variables: var 0 and the page
  int v1p;             // v1 rounded up to a multiple of 4
  int tier;            // circuit_kernel.TIERS
  int lanes_per_word;
  int resident;        // the whole stream in shared memory (else a ring)
  int rec_off;         // int32 words into records
  int stream_off;      // steps into the stream table
  int stream_steps;
  int chunks;          // stream steps / kChunkSteps, rounded up
  int root_off;        // into roots
  int root_count;
};

struct Params {
  const Cone* cones;        // [num_cones]
  const int* records;       // narrow: u32 [v1p]; wide: uint2 [v1] a cone
  const uint4* stream;      // [steps][2][32] (xla_layout)
  const uint32_t* roots;    // var << 2 | neg << 1 | live
  const int* x_in;          // [lanes][v1]
  int* x_out;
  uint8_t* found;           // [lanes][cone_slots]
  uint32_t* x_work;         // global tier: v1p words a block
  int lanes, v1, num_cones, cone_slots, page_end, steps, walk_depth;
  uint32_t seed;
};

// The group's rows of the cone's page into bit-sliced words, every warp
// of the block on its own columns of 32 local variables: thread t reads
// local variable v0 + t of each lane's row (coalesced), one __ballot_sync
// a lane gives that lane's bits of the 32 variables, and thread t gathers
// bit t of each into its variable's word. `row0` is the group's first
// row at the page's combined base - 1, so local var v >= 1 is row0[v];
// local var 0 and lanes past the group's `nl` are 0.
template <class Word>
__device__ void pack_x(Word* x, const int* __restrict__ row0, int stride,
                       int v1, int nl) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  const int t = threadIdx.x & 31;
  for (int v0 = (threadIdx.x >> 5) * 32; v0 < v1; v0 += kThreads) {
    const int v = v0 + t;
    int bits[kLaneBits];
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      bits[r] = r < nl && v >= 1 && v < v1
                    ? __ldg(row0 + static_cast<size_t>(r) * stride + v)
                    : 0;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      word |= ((__ballot_sync(kFull, bits[r] != 0) >> t) & 1u) << r;
    if (v < v1) x[v] = static_cast<Word>(word);
  }
}

// The words of the page back into x_out's rows, coalesced: thread t
// writes local variable v0 + t (v >= 1) of each of the group's lanes.
template <class Word>
__device__ void unpack_x(const Word* x, int* row0, int stride, int v1,
                         int nl) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  for (int v = threadIdx.x; v < v1; v += kThreads) {
    if (v == 0) continue;
    const uint32_t word = x[v];
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      if (r < nl) row0[static_cast<size_t>(r) * stride + v] = (word >> r) & 1u;
  }
}

// One block's round: cone `c`, the lanes from lane0 a word holds; x_work
// (global tier) its words.
template <class Word, bool kSharedRecords, bool kXInShared>
__device__ __forceinline__ void cone_round(const Params& p, const Cone& cone,
                                           int c, int lane0,
                                           uint32_t* x_work, uint8_t* smem,
                                           uint64_t* tables_ready) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  const int nl = min(kLaneBits, p.lanes - lane0);
  const int t = threadIdx.x & 31;

  // shared memory: [records (narrow)] [stream: resident or ring] [x]
  size_t off = 0;
  const uint32_t* recs_shared = reinterpret_cast<const uint32_t*>(smem);
  if (kSharedRecords) off += static_cast<size_t>(cone.v1p) * 4;
  uint4* stream_shared = reinterpret_cast<uint4*>(smem + off);
  off += cone.resident ? static_cast<size_t>(cone.chunks) * kChunkBytes
                       : static_cast<size_t>(kRing) * kChunkBytes;
  Word* x = kXInShared ? reinterpret_cast<Word*>(smem + off)
                       : reinterpret_cast<Word*>(x_work);
  const uint4* stream_global =
      p.stream + static_cast<size_t>(cone.stream_off) * kStepQuads;

  // the tables into shared memory by one TMA bulk copy, under the packing
  const uint32_t rec_bytes = kSharedRecords ? cone.v1p * 4u : 0u;
  const uint32_t stream_bytes =
      cone.resident ? static_cast<uint32_t>(cone.chunks) * kChunkBytes : 0u;
  const uint32_t bar = smem_u32(tables_ready);
  if (rec_bytes + stream_bytes) {
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
          "r"(rec_bytes + stream_bytes)
          : "memory");
      if (rec_bytes)
        bulk_copy(smem, p.records + cone.rec_off, rec_bytes, bar);
      if (stream_bytes)
        bulk_copy(stream_shared, stream_global, stream_bytes, bar);
    }
  }
  const size_t row0 = static_cast<size_t>(lane0) * p.v1 + (cone.base - 1);
  pack_x(x, p.x_in + row0, p.v1, cone.v1, nl);
  __syncthreads();

  if (threadIdx.x < 32) {  // warp 0 runs the round
    if (rec_bytes + stream_bytes) wait_tables(bar);
    Records<kSharedRecords> rec_of;
    if constexpr (kSharedRecords) {
      rec_of.recs = recs_shared;
    } else {
      rec_of.recs = reinterpret_cast<const uint2*>(p.records + cone.rec_off);
    }
    Stream st{stream_global, stream_shared, cone.resident != 0, cone.chunks,
              static_cast<uint32_t>(cone.chunks) * (p.steps + 1), 0};
    st.start(t);
    const uint32_t* roots = p.roots + cone.root_off;
    const uint32_t salt = static_cast<uint32_t>(lane0 + t) * kLane ^
                          static_cast<uint32_t>(c) * kCone;
    bool found = t >= nl;  // no lane: nothing to find
    bool final_pass = true;
    for (int step = 0; step < p.steps; ++step) {
      simulate(x, st, cone.stream_steps, t);
      const uint32_t step_key =
          hash32(p.seed ^ (static_cast<uint32_t>(step) * kStep));
      int choice = 0;
      const bool violated = !found && check(x, roots, cone.root_count,
                                            step_key ^ salt, t, choice);
      found = found || !violated;
      // a lane that found a model never flips: when all have, x is final
      if (__all_sync(kFull, found)) {
        final_pass = false;
        break;
      }
      walk_and_flip(x, rec_of, violated, __ldg(roots + choice),
                    p.walk_depth, step_key ^ kCoin ^ salt, t);
      __syncwarp();
    }
    if (final_pass) {
      simulate(x, st, cone.stream_steps, t);
      int choice;
      found = found || !check(x, roots, cone.root_count, salt, t, choice);
    }
    if (t < nl)
      p.found[static_cast<size_t>(lane0 + t) * p.cone_slots + c] =
          found ? 1 : 0;
    st.finish();
  }
  __syncthreads();
  unpack_x(x, p.x_out + row0, p.v1, cone.v1, nl);
}

__global__ void __launch_bounds__(kThreads) xla_round_kernel(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t tables_ready;
  __shared__ int item[2];
  __shared__ long long work;
  // block -> (cone, group): the cones' groups in cone order, and the
  // global tier's x words in the same order (xla_kernel.launch_blocks)
  if (threadIdx.x == 0) {
    int b = blockIdx.x, c = 0;
    long long w = 0;
    for (; c < p.num_cones; ++c) {
      const int lpw = p.cones[c].lanes_per_word;
      const int groups = (p.lanes + lpw - 1) / lpw;
      if (b < groups) break;
      b -= groups;
      if (p.cones[c].tier == kGlobal)
        w += static_cast<long long>(groups) * p.cones[c].v1p;
    }
    item[0] = c;
    item[1] = b;
    work = c < p.num_cones && p.cones[c].tier == kGlobal
               ? w + static_cast<long long>(b) * p.cones[c].v1p
               : 0;
  }
  __syncthreads();
  const int c = item[0];
  if (c >= p.num_cones) return;  // past the last group: the same for all
  const Cone cone = p.cones[c];
  const int lane0 = item[1] * cone.lanes_per_word;
  uint32_t* x_work = p.x_work ? p.x_work + work : nullptr;
  switch (cone.tier) {
    case kShared32:
      cone_round<uint32_t, true, true>(p, cone, c, lane0, x_work, smem,
                                       &tables_ready);
      break;
    case kShared16:
      cone_round<uint16_t, true, true>(p, cone, c, lane0, x_work, smem,
                                       &tables_ready);
      break;
    case kXShared:
      if (cone.lanes_per_word == 32)
        cone_round<uint32_t, false, true>(p, cone, c, lane0, x_work, smem,
                                          &tables_ready);
      else if (cone.lanes_per_word == 16)
        cone_round<uint16_t, false, true>(p, cone, c, lane0, x_work, smem,
                                          &tables_ready);
      else
        cone_round<uint8_t, false, true>(p, cone, c, lane0, x_work, smem,
                                         &tables_ready);
      break;
    default:
      cone_round<uint32_t, false, false>(p, cone, c, lane0, x_work, smem,
                                         &tables_ready);
  }
}

// The variables past the last page copied through, var 0 reset and the
// padding cone slots found, for every lane.
__global__ void __launch_bounds__(kCopyThreads) xla_copy_kernel(Params p) {
  const int tail = p.v1 - p.page_end;
  const int spare = p.cone_slots - p.num_cones;
  const int stride = gridDim.x * kCopyThreads;
  const int first = blockIdx.x * kCopyThreads + threadIdx.x;
  for (int i = first; i < p.lanes * tail; i += stride) {
    const size_t at = static_cast<size_t>(i / tail) * p.v1 + p.page_end +
                      i % tail;
    p.x_out[at] = __ldg(p.x_in + at);
  }
  for (int i = first; i < p.lanes; i += stride)
    p.x_out[static_cast<size_t>(i) * p.v1] = 0;
  for (int i = first; i < p.lanes * spare; i += stride)
    p.found[static_cast<size_t>(i / spare) * p.cone_slots + p.num_cones +
            i % spare] = 1;
}

}  // namespace

extern "C" {

// Launch one round on `stream` (a cudaStream_t passed as a pointer): the
// copy kernel, then one block a (cone, group) of the round. Returns
// cudaGetLastError() after the launches: 0 when they were accepted.
int xla_round_launch(const void* cones, const void* records,
                     const void* stream_table, const void* roots,
                     const void* x_in, void* x_out, void* found,
                     void* x_work, int lanes, int v1, int num_cones,
                     int cone_slots, int page_end, int blocks,
                     int smem_bytes, int steps, int walk_depth,
                     unsigned int seed, void* stream) {
  if (lanes < 1 || v1 < 2 || num_cones < 1 || cone_slots < num_cones ||
      page_end < 1 || page_end > v1 || blocks < 1 || smem_bytes < 0 ||
      smem_bytes > 227 * 1024 || steps < 0 || walk_depth < 0 ||
      static_cast<long long>(lanes) * v1 >= (1LL << 31) ||
      static_cast<long long>(lanes) * cone_slots >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const Cone*>(cones),
           static_cast<const int*>(records),
           static_cast<const uint4*>(stream_table),
           static_cast<const uint32_t*>(roots),
           static_cast<const int*>(x_in),
           static_cast<int*>(x_out),
           static_cast<uint8_t*>(found),
           static_cast<uint32_t*>(x_work),
           lanes, v1, num_cones, cone_slots, page_end, steps, walk_depth,
           seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long copies =
      static_cast<long long>(lanes) *
      (1 + (v1 - page_end) + (cone_slots - num_cones));
  const long long wanted = (copies + kCopyThreads - 1) / kCopyThreads;
  const int copy_blocks = static_cast<int>(wanted < 264 ? wanted : 264);
  xla_copy_kernel<<<copy_blocks, kCopyThreads, 0, s>>>(p);
  cudaError_t err = cudaFuncSetAttribute(
      xla_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  xla_round_kernel<<<blocks, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* xla_round_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
