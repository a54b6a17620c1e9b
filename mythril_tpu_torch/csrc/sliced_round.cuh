// The bit-sliced round's warp-level pieces, shared by K3
// (csrc/circuit_round.cu, a query a block) and K2 (csrc/xla_round.cu, a
// cone a block): the stream's chunks and ring, a gate of the simulate, the
// simulate, the root check, the walk and the flip on the word, and the
// TMA bulk copy of the tables. Each kernel's header note says why they
// are built so. The constants mirror gpu/circuit_kernel.py; the hash and
// its salts are K1's (csrc/ragged_round.cu). Included once, inside no
// namespace, by each of the two sources.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkBytes = 8192;   // circuit_kernel.CHUNK_BYTES
constexpr int kRing = 4;            // circuit_kernel.RING
constexpr int kSlotQuads = 2;       // circuit_kernel.ENTRY_BYTES / 16
constexpr int kStepQuads = 32 * kSlotQuads;
constexpr int kChunkSteps = kChunkBytes / (16 * kStepQuads);
constexpr unsigned kFull = 0xFFFFFFFFu;
// circuit_kernel.TIERS
enum { kShared32 = 0, kShared16 = 1, kXShared = 2, kGlobal = 3 };

constexpr uint32_t kStep = 0x9E3779B9u, kLane = 0x85EBCA6Bu,
                   kCone = 0xC2B2AE35u, kRoot = 0x27D4EB2Fu,
                   kCoin = 0x94D049BBu, kDepth = 0x165667B1u;

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  v = (v ^ (v >> 16)) * 0x7FEB352Du;
  v = (v ^ (v >> 15)) * 0x846CA68Bu;
  return v ^ (v >> 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A variable's record, its two child literals (var << 1 | neg): 16-bit
// each in one word in shared memory (narrow), or a pair in global memory.
template <bool kSharedRecords>
struct Records;

template <>
struct Records<true> {
  const uint32_t* recs;
  __device__ __forceinline__ uint2 operator()(uint32_t v) const {
    const uint32_t r = recs[v];
    return make_uint2(r & 0xFFFFu, r >> 16);
  }
};

template <>
struct Records<false> {
  const uint2* recs;
  __device__ __forceinline__ uint2 operator()(uint32_t v) const {
    return __ldg(recs + v);
  }
};

// 16 bytes global -> shared, asynchronously.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// A query's (K3) or cone's (K2) real-gate stream, as the warp reads it,
// in chunks of kChunkSteps steps: resident in shared memory, or a ring of
// kRing chunks. The ring runs over every simulate of the launch as one
// sequence of chunks (each simulate reads all of the stream's chunks in
// order);
// chunk n is one cp.async group per thread, and kRing - 1 chunks are in
// flight.
struct Stream {
  const uint4* global;  // this query's or cone's steps, [steps][2][32]
  uint4* smem;          // resident: the steps; ring: [kRing][chunk]
  bool resident;
  int chunks;           // of one simulate
  uint32_t total;       // chunks of every simulate the launch may run
  uint32_t begun;       // chunks begun so far

  __device__ void fetch(uint32_t n, int t) {
    if (n < total) {
      const uint4* src = global + (n % chunks) * (kChunkSteps * kStepQuads);
      uint4* dst = smem + (n % kRing) * (kChunkSteps * kStepQuads);
#pragma unroll
      for (int i = t; i < kChunkSteps * kStepQuads; i += 32)
        copy_async16(dst + i, src + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ void start(int t) {
    begun = 0;
    if (resident) return;
    for (int n = 0; n < kRing - 1; ++n) fetch(n, t);
  }
  // Chunk c of this simulate; called for c = 0, 1, ... in order by every
  // thread of the warp.
  __device__ __forceinline__ const uint4* chunk(int c, int t) {
    if (resident) return smem + c * (kChunkSteps * kStepQuads);
    __syncwarp();  // every read of the slot chunk begun - 1 left is done
    fetch(begun + kRing - 1, t);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    __syncwarp();  // the other threads' parts of chunk `begun` landed
    return smem + (begun++ % kRing) * (kChunkSteps * kStepQuads);
  }
  __device__ void finish() {
    if (!resident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

// x's word at byte offset `off` (circuit_layout's and xla_layout's
// offsets).
template <class Word>
__device__ __forceinline__ Word word_at(const Word* x, uint32_t off) {
  return *reinterpret_cast<const Word*>(
      reinterpret_cast<const uint8_t*>(x) + off);
}

// Byte k of `masks` in every byte of a word.
__device__ __forceinline__ uint32_t mask_byte(uint32_t masks, int k) {
  return __byte_perm(masks, 0, 0x1111 * k);
}

// One step of the simulate: thread t's gate for every lane at once. `p`
// is (out | flags, a0, a1, a) and `q` (masks, b0, b1, b)
// (circuit_layout): each child's value is the AND of two literals (the
// child's own inputs on the pair's first level, else the child twice),
// then its negation. A slot of padding is var 0 := x[0] & x[0].
template <class Word>
__device__ __forceinline__ void gate(Word* x, uint4 p, uint4 q) {
  const Word va = ((word_at(x, p.y) ^ static_cast<Word>(mask_byte(q.x, 0))) &
                   (word_at(x, p.z) ^ static_cast<Word>(mask_byte(q.x, 1)))) ^
                  static_cast<Word>(0u - (p.w & 1u));
  const Word vb = ((word_at(x, q.y) ^ static_cast<Word>(mask_byte(q.x, 2))) &
                   (word_at(x, q.z) ^ static_cast<Word>(mask_byte(q.x, 3)))) ^
                  static_cast<Word>(0u - (q.w & 1u));
  *reinterpret_cast<Word*>(reinterpret_cast<uint8_t*>(x) +
                           (p.x & 0x3FFFFFFFu)) = static_cast<Word>(va & vb);
  __syncwarp();
}

// One simulate of the warp's lanes: x[0] = 0, then every step of the
// stream in order (two levels a step), thread t taking slot t. The next
// step's slot is read before this step's x reads, and a whole chunk runs
// unrolled.
template <class Word>
__device__ __forceinline__ void simulate(Word* x, Stream& st, int num_steps,
                                         int t) {
  if (t == 0) x[0] = 0;
  __syncwarp();
  for (int c = 0; c * kChunkSteps < num_steps; ++c) {
    const uint4* steps = st.chunk(c, t) + t;
    const int n = min(kChunkSteps, num_steps - c * kChunkSteps);
    uint4 a = steps[0], b = steps[32];
    if (n == kChunkSteps) {
#pragma unroll
      for (int k = 0; k < kChunkSteps; ++k) {
        const int next = min(k + 1, kChunkSteps - 1) * kStepQuads;
        const uint4 na = steps[next], nb = steps[next + 32];
        gate(x, a, b);
        a = na;
        b = nb;
      }
    } else {
      for (int k = 0; k < n; ++k) {
        const int next = min(k + 1, n - 1) * kStepQuads;
        const uint4 na = steps[next], nb = steps[next + 32];
        gate(x, a, b);
        a = na;
        b = nb;
      }
    }
  }
}

// Lane t's root check on its own bit: true when a root is violated, with
// `choice` the violated root of maximal key (hash >> 1), the lowest on a
// tie.
template <class Word>
__device__ __forceinline__ bool check(const Word* x,
                                      const uint32_t* __restrict__ roots,
                                      int nr, uint32_t key_base, int t,
                                      int& choice) {
  int best_key = -1, best = 0;
#pragma unroll 4
  for (int j = 0; j < nr; ++j) {
    const uint32_t r = __ldg(roots + j);
    const uint32_t bit = (static_cast<uint32_t>(x[r >> 2]) >> t) & 1u;
    // live (not masked) and its literal false
    if ((r & 1u) && bit == ((r >> 1) & 1u)) {
      const int key = static_cast<int>(
          hash32(key_base ^ (static_cast<uint32_t>(j) * kRoot)) >> 1);
      if (key > best_key) {
        best_key = key;
        best = j;
      }
    }
  }
  choice = best;
  return best_key >= 0;
}

// Set bit t of x[v] to `want`; other lanes may flip bits of the same word.
template <class Word>
__device__ __forceinline__ void flip(Word* x, uint32_t v, int t,
                                     uint32_t want) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(x + v);
  unsigned int* word = reinterpret_cast<unsigned int*>(at & ~uintptr_t(3));
  const unsigned int mask = 1u << (8 * (at & 3) + t);
  if (want)
    atomicOr(word, mask);
  else
    atomicAnd(word, ~mask);
}

// Lane t's justification walk from the violated root `r` (when `walking`),
// then its flip. The whole warp runs the loop in step, without branches,
// until the last walk has ended. Every read is of shared memory (the
// records of the xshared and global tiers excepted).
template <class Word, class Recs>
__device__ __forceinline__ void walk_and_flip(Word* x, const Recs& rec_of,
                                              bool walking, uint32_t r,
                                              int walk_depth,
                                              uint32_t coin_base, int t) {
  uint32_t cur = r >> 2, want = 1u ^ ((r >> 1) & 1u);
  uint2 rec = rec_of(cur);
  bool active = walking;
  for (int depth = 0; depth < walk_depth; ++depth) {
    const uint32_t coin =
        hash32(coin_base ^ (static_cast<uint32_t>(depth) * kDepth)) & 1u;
    const uint32_t a = rec.x >> 1, b = rec.y >> 1;
    // both children's records before the choice is known
    const uint2 ra = rec_of(a), rb = rec_of(b);
    const uint32_t av = ((static_cast<uint32_t>(x[a]) >> t) ^ rec.x) & 1u;
    const uint32_t bv = ((static_cast<uint32_t>(x[b]) >> t) ^ rec.y) & 1u;
    // a variable that is not a gate, or a justified gate, ends the walk
    active = active && a != cur && (av & bv) != want;
    if (!__any_sync(kFull, active)) break;
    // want 1 descends into a false child, want 0 into a true one: b when
    // only b is such a child, the coin when both are
    const uint32_t fa = av ^ want, fb = bv ^ want;
    const bool choose_b = active && (fb & ((fa ^ 1u) | coin));
    const bool choose_a = active && !choose_b;
    cur = choose_b ? b : (choose_a ? a : cur);
    want ^= choose_b ? rec.y & 1u : (choose_a ? rec.x & 1u : 0u);
    rec = choose_b ? rb : (choose_a ? ra : rec);
  }
  if (walking) flip(x, cur, t, want);
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace
