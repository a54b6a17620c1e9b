// K3, the per-query circuit-SLS round of the bucketed path, for Hopper
// (sm_90a).
//
// Replaces mythril_tpu/tpu/circuit.py run_round_circuit (:460, with
// _simulate :398 and _walk :415), vmapped over queries by
// run_round_circuit_batch (:507): an XLA program, not a Pallas kernel. Its
// plain PyTorch version, and the semantics both keep, are in
// gpu/circuit_kernel.py; the two agree bit for bit (the randomness is K1's
// counter hash, keyed by seed, query slot, restart lane, step and walk
// depth).
//
// What bounds it. A step is a serial chain: each level of the simulate
// reads what the levels before it wrote, the root check reads the last,
// and the walk is a chain of dependent reads one gate long each (up to
// walk_depth). The bytes are few (each query's tables read once, x in and
// out): on the analyze path's batches the bound by bytes is far below the
// chain's latency, so the length of one link of the chain, and the
// instructions the warp issues per link, bound it.
//
// What the design does about it: every link is a shared-memory round trip
// and a handful of instructions.
//  - Bit-sliced lanes. One warp serves (query, up to 32 restart lanes):
//    lane k of the group is bit k of one word per variable, in shared
//    memory. A gate is one AND of two XOR-masked words for every lane at
//    once, so the warp's 32 threads take 32 gates at a time, and the steps
//    are separated by __syncwarp(), not by a block barrier.
//  - Two levels a step (K1's trick). The query's tables come from
//    gpu/circuit_kernel.circuit_layout, built on the device once per
//    batch: the real-gate stream, the levels that hold a live cell paired
//    in order and each pair's cells in steps of 32 (the bucket's padding
//    is never read), each slot a whole gate in 32 bytes. A gate on the
//    second level of a pair reads a first-level child's own two inputs in
//    its place, so a step reads only what earlier steps wrote and the
//    chain is half the depth; the simulate reads one slot a step and
//    nothing else but x. Beside it, a record per variable (its two child
//    literals; a variable that is not a gate points at itself) for the
//    walk: 16-bit literals in shared memory up to V1 = 32,768, 32-bit ones
//    in global memory past it.
//  - One TMA bulk copy on an mbarrier brings the records (and a stream
//    that fits) into shared memory while the block's 16 warps pack x
//    (coalesced reads of 32 variables of each lane's row, one
//    __ballot_sync a lane). A stream that does not fit is staged through
//    a ring of kRing chunks of 8 steps (16-byte cp.async, kRing - 1
//    chunks in flight), as K1's global-table path does.
//  - The simulate runs a chunk's steps unrolled and reads the next step's
//    slot before this step's x reads, so only the x reads, the logic, the
//    store and the __syncwarp() stay on the chain. Thread k checks lane
//    k's roots on its own bit and walks lane k's chain over shared memory
//    alone, every thread of the warp in step and without branches until
//    the last walk ends, reading both children's records before it knows
//    which one it takes (K1's trick again). The flips are atomicOr /
//    atomicAnd on the word, since two lanes may flip one variable. A
//    group whose lanes have all found a model stops: no later step would
//    change its x.
//  - The warp-level pieces (the stream and its ring, a gate, the
//    simulate, the check, the walk, the flip, the bulk copy) are in
//    csrc/sliced_round.cuh, which K2 (csrc/xla_round.cu) shares.
//  - Tiers (circuit_kernel.launch_shape), each with the same code:
//      shared32  V1 <= 16,384: 32 lanes a word, records and x in shared
//                memory;
//      shared16  V1 <= 32,768: 16 lanes a word (x as 16-bit words);
//      xshared   x alone in shared memory at 32, 16 or 8 lanes a word
//                (the widest that fits), the walk's records in global
//                memory;
//      global    x too large for shared memory even at 8 lanes a word:
//                x's words in global memory (x_work).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sliced_round.cuh"

namespace {

constexpr int kThreads = 512;       // circuit_kernel.THREADS
constexpr uint32_t kQuery = kCone;  // a query slot salts as K1's cone slot

struct Params {
  const void* records;      // narrow: u32 [Q][v1p]; wide: uint2 [Q][v1]
  const uint4* stream;      // [Q][stride][2][32] (circuit_layout)
  const int* stream_steps;  // [Q] steps of each query's stream
  const uint32_t* roots;    // [Q][nr] var << 2 | neg << 1 | live
  const int* x_in;          // [Q][lanes][v1]
  int* x_out;
  uint8_t* found;           // [Q][lanes]
  uint32_t* x_work;         // global tier: [Q][groups][v1p] words
  int lanes, v1, v1p, stride, nr, steps, walk_depth;
  uint32_t seed;
  int resident;             // the whole stream in shared memory
};

// x_in's rows of the group's lanes into bit-sliced words, every warp of
// the block on its own columns of 32 variables: thread t reads variable
// v0 + t of each lane's row (coalesced, the group's loads all in flight),
// one __ballot_sync a lane gives that lane's bits of the 32 variables,
// and thread t gathers bit t of each into its variable's word. Lanes past
// the group's `nl` are 0.
template <class Word>
__device__ void pack_x(Word* x, const int* __restrict__ row0, int v1,
                       int nl) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  const int t = threadIdx.x & 31;
  for (int v0 = (threadIdx.x >> 5) * 32; v0 < v1; v0 += kThreads) {
    const int v = v0 + t;
    int bits[kLaneBits];
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      bits[r] = r < nl && v < v1
                    ? __ldg(row0 + static_cast<size_t>(r) * v1 + v)
                    : 0;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      word |= ((__ballot_sync(kFull, bits[r] != 0) >> t) & 1u) << r;
    if (v < v1) x[v] = static_cast<Word>(word);
  }
}

// The words back into x_out's rows, coalesced: thread t writes variable
// v0 + t of each of the group's lanes.
template <class Word>
__device__ void unpack_x(const Word* x, int* row0, int v1, int nl) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  for (int v = threadIdx.x; v < v1; v += kThreads) {
    const uint32_t word = x[v];
#pragma unroll
    for (int r = 0; r < kLaneBits; ++r)
      if (r < nl) row0[static_cast<size_t>(r) * v1 + v] = (word >> r) & 1u;
  }
}

template <class Word, bool kSharedRecords, bool kXInShared>
__global__ void __launch_bounds__(kThreads)
    circuit_round_kernel(Params p) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t tables_ready;
  const int q = blockIdx.y;
  const int lane0 = blockIdx.x * kLaneBits;
  const int nl = min(kLaneBits, p.lanes - lane0);
  const int t = threadIdx.x & 31;
  const int num_steps = p.stream_steps[q];
  const int chunks = (num_steps + kChunkSteps - 1) / kChunkSteps;

  // shared memory: [records (narrow)] [stream: resident or ring] [x]
  size_t off = 0;
  const uint32_t* recs_shared = reinterpret_cast<const uint32_t*>(smem);
  if (kSharedRecords) off += static_cast<size_t>(p.v1p) * 4;
  uint4* stream_shared = reinterpret_cast<uint4*>(smem + off);
  off += p.resident
             ? static_cast<size_t>(p.stride) * kStepQuads * sizeof(uint4)
             : static_cast<size_t>(kRing) * kChunkBytes;
  Word* x = kXInShared
                ? reinterpret_cast<Word*>(smem + off)
                : reinterpret_cast<Word*>(
                      p.x_work + (static_cast<size_t>(q) * gridDim.x +
                                  blockIdx.x) * p.v1p);
  const uint4* stream_global =
      p.stream + static_cast<size_t>(q) * p.stride * kStepQuads;

  // the tables into shared memory by one TMA bulk copy, under the packing
  const uint32_t rec_bytes = kSharedRecords ? p.v1p * 4u : 0u;
  const uint32_t stream_bytes =
      p.resident ? static_cast<uint32_t>(chunks) * kChunkBytes : 0u;
  const uint32_t bar = smem_u32(&tables_ready);
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
        bulk_copy(smem,
                  reinterpret_cast<const uint8_t*>(p.records) +
                      static_cast<size_t>(q) * rec_bytes,
                  rec_bytes, bar);
      if (stream_bytes)
        bulk_copy(stream_shared, stream_global, stream_bytes, bar);
    }
  }
  const size_t row0 =
      (static_cast<size_t>(q) * p.lanes + lane0) * static_cast<size_t>(p.v1);
  pack_x(x, p.x_in + row0, p.v1, nl);
  __syncthreads();

  if (threadIdx.x < 32) {  // warp 0 runs the round
    if (rec_bytes + stream_bytes) wait_tables(bar);
    Records<kSharedRecords> rec_of;
    if constexpr (kSharedRecords) {
      rec_of.recs = recs_shared;
    } else {
      rec_of.recs = reinterpret_cast<const uint2*>(p.records) +
                    static_cast<size_t>(q) * p.v1;
    }
    Stream st{stream_global, stream_shared, p.resident != 0, chunks,
              static_cast<uint32_t>(chunks) * (p.steps + 1), 0};
    st.start(t);
    const uint32_t* roots = p.roots + static_cast<size_t>(q) * p.nr;
    const uint32_t salt = static_cast<uint32_t>(q) * kQuery ^
                          static_cast<uint32_t>(lane0 + t) * kLane;
    bool found = t >= nl;  // no lane: nothing to find
    bool final_pass = true;
    for (int step = 0; step < p.steps; ++step) {
      simulate(x, st, num_steps, t);
      const uint32_t step_key =
          hash32(p.seed ^ (static_cast<uint32_t>(step) * kStep));
      int choice = 0;
      const bool violated =
          !found && check(x, roots, p.nr, step_key ^ salt, t, choice);
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
      simulate(x, st, num_steps, t);
      int choice;
      found = found || !check(x, roots, p.nr, salt, t, choice);
    }
    if (t < nl)
      p.found[static_cast<size_t>(q) * p.lanes + lane0 + t] = found ? 1 : 0;
    st.finish();
  }
  __syncthreads();
  unpack_x(x, p.x_out + row0, p.v1, nl);
}

template <class Word, bool kSharedRecords, bool kXInShared>
int launch(const Params& p, int queries, int smem_bytes,
           cudaStream_t stream) {
  constexpr int kLaneBits = 8 * sizeof(Word);
  auto kernel = circuit_round_kernel<Word, kSharedRecords, kXInShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lanes + kLaneBits - 1) / kLaneBits, queries);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one round on `stream` (a cudaStream_t passed as a pointer); the
// tier and the lanes a word come from circuit_kernel.launch_shape.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int circuit_round_launch(
    const void* records, const void* stream_table, const void* stream_steps,
    const void* roots, const void* x_in, void* x_out, void* found,
    void* x_work, int queries, int lanes, int v1, int v1p, int stride,
    int nr, int steps, int walk_depth, unsigned seed, int tier,
    int lanes_per_word, int resident, int smem_bytes, void* stream) {
  if (queries < 1 || lanes < 1 || v1 < 1 || smem_bytes < 0 ||
      smem_bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{records,
           static_cast<const uint4*>(stream_table),
           static_cast<const int*>(stream_steps),
           static_cast<const uint32_t*>(roots),
           static_cast<const int*>(x_in),
           static_cast<int*>(x_out),
           static_cast<uint8_t*>(found),
           static_cast<uint32_t*>(x_work),
           lanes, v1, v1p, stride, nr, steps, walk_depth, seed, resident};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case kShared32:
      return launch<uint32_t, true, true>(p, queries, smem_bytes, s);
    case kShared16:
      return launch<uint16_t, true, true>(p, queries, smem_bytes, s);
    case kXShared:
      if (lanes_per_word == 32)
        return launch<uint32_t, false, true>(p, queries, smem_bytes, s);
      if (lanes_per_word == 16)
        return launch<uint16_t, false, true>(p, queries, smem_bytes, s);
      if (lanes_per_word == 8)
        return launch<uint8_t, false, true>(p, queries, smem_bytes, s);
      break;
    case kGlobal:
      if (!x_work) break;
      return launch<uint32_t, false, false>(p, queries, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* circuit_round_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
