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
// What bounds it. A step is a serial chain: one barrier per level of the
// simulate, a root reduction, then the walk, a chain of dependent loads one
// gate long each (up to walk_depth). The bytes are few (each query's tables
// read once, x in and out): on the analyze path's batches the bound by bytes
// is far below the chain's latency, so the chain bounds it.
//
// Design (a simple kernel that is right; no wgmma, TMA or warp
// specialisation). The grid is (group of restart lanes, query slot). A
// block of 256 threads owns up to 8 lanes of one query and keeps their x
// rows in dynamic shared memory as a byte per variable while they fit
// SMEM_X_CAP (224 KB: three lanes at 65,536 variables); a query whose one
// row does not fit keeps x in global memory, in x_out itself. The level and
// gate tables are read from global memory and L2, shared by every block of
// the query. A step runs in three parts:
//   - simulate: thread t sweeps cell t of each level for every lane of the
//     block (cells past 256 in a loop), a barrier after each level that
//     writes; level l + 1's cell descriptors are loaded while level l
//     computes, so the barrier chain does not wait on L2 each level. A
//     cell whose out_idx is 0 is padding and is skipped (the reference
//     writes 0 into var 0, which is already 0);
//   - the root check and the pick: warp w reduces lane w's roots (violated
//     or not, the maximal hash key, the lowest root on a tie);
//   - the walk: thread 0 of warp w walks lane w's chain and flips its end,
//     unless the lane has found a model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesMax = kThreads / 32;

constexpr uint32_t kStep = 0x9E3779B9u, kLane = 0x85EBCA6Bu,
                   kQuery = 0xC2B2AE35u, kRoot = 0x27D4EB2Fu,
                   kCoin = 0x94D049BBu, kDepth = 0x165667B1u;

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  v = (v ^ (v >> 16)) * 0x7FEB352Du;
  v = (v ^ (v >> 15)) * 0x846CA68Bu;
  return v ^ (v >> 16);
}

struct Tables {
  const int* out_idx;
  const int* a_var;
  const int* a_neg;
  const int* b_var;
  const int* b_neg;
  const int* ga_var;
  const int* ga_neg;
  const int* gb_var;
  const int* gb_neg;
  const int* is_gate;
  const int* root_var;
  const int* root_neg;
  const int* root_mask;
  const int* rows;
};

// One query's slice of every table.
struct Query {
  const int* __restrict__ out_idx;
  const int* __restrict__ a_var;
  const int* __restrict__ a_neg;
  const int* __restrict__ b_var;
  const int* __restrict__ b_neg;
  const int* __restrict__ ga_var;
  const int* __restrict__ ga_neg;
  const int* __restrict__ gb_var;
  const int* __restrict__ gb_neg;
  const int* __restrict__ is_gate;
  const int* __restrict__ root_var;
  const int* __restrict__ root_neg;
  const int* __restrict__ root_mask;
  const int* __restrict__ rows;
  int levels, width, roots;
};

// x[:, 0] = 0, then every level in order (see the note above).
template <typename T>
__device__ __forceinline__ void simulate(const Query& t, T* base,
                                         size_t stride, int nl) {
  const int tid = threadIdx.x;
  if (tid < nl) base[(size_t)tid * stride] = 0;
  __syncthreads();
  const bool has = tid < t.width;
  int o = 0, a = 0, an = 0, b = 0, bn = 0;
  int r_next = __ldg(t.rows);
  if (has) {
    o = __ldg(t.out_idx + tid);
    a = __ldg(t.a_var + tid);
    an = __ldg(t.a_neg + tid);
    b = __ldg(t.b_var + tid);
    bn = __ldg(t.b_neg + tid);
  }
  for (int l = 0; l < t.levels; ++l) {
    const int r = r_next;
    const int co = o, ca = a, can = an, cb = b, cbn = bn;
    if (l + 1 < t.levels) {
      r_next = __ldg(t.rows + l + 1);
      if (has) {
        const size_t i = (size_t)(l + 1) * t.width + tid;
        o = __ldg(t.out_idx + i);
        a = __ldg(t.a_var + i);
        an = __ldg(t.a_neg + i);
        b = __ldg(t.b_var + i);
        bn = __ldg(t.b_neg + i);
      }
    }
    if (r == 0) continue;  // padding alone: nothing written, no barrier
    if (tid < r && co != 0) {
      for (int k = 0; k < nl; ++k) {
        T* xr = base + (size_t)k * stride;
        xr[co] = (T)((((int)xr[ca]) ^ can) & (((int)xr[cb]) ^ cbn));
      }
    }
    for (int c = tid + kThreads; c < r; c += kThreads) {
      const size_t i = (size_t)l * t.width + c;
      const int o2 = __ldg(t.out_idx + i);
      if (o2 == 0) continue;
      const int a2 = __ldg(t.a_var + i), an2 = __ldg(t.a_neg + i);
      const int b2 = __ldg(t.b_var + i), bn2 = __ldg(t.b_neg + i);
      for (int k = 0; k < nl; ++k) {
        T* xr = base + (size_t)k * stride;
        xr[o2] = (T)((((int)xr[a2]) ^ an2) & (((int)xr[b2]) ^ bn2));
      }
    }
    __syncthreads();
  }
}

// Warp-wide root check of one lane: whether a root is violated, and the
// violated root of maximal key (the lowest on a tie; root 0 when none).
template <typename T>
__device__ __forceinline__ void pick_root(const Query& t, const T* xr,
                                          uint32_t step_key, uint32_t salt,
                                          bool* violated, int* choice) {
  const int lane = threadIdx.x & 31;
  int best_key = -1, best = lane < t.roots ? lane : 0x7FFFFFFF;
  bool any = false;
  for (int j = lane; j < t.roots; j += 32) {
    const int rv = __ldg(t.root_var + j);
    const int viol = ((((int)xr[rv]) ^ __ldg(t.root_neg + j)) == 0)
                     && __ldg(t.root_mask + j) == 1;
    any |= viol;
    const int key =
        viol ? (int)(hash32(step_key ^ salt ^ ((uint32_t)j * kRoot)) >> 1)
             : -1;
    if (key > best_key) {
      best_key = key;
      best = j;
    }
  }
  for (int off = 16; off; off >>= 1) {
    const int k2 = __shfl_down_sync(0xFFFFFFFFu, best_key, off);
    const int b2 = __shfl_down_sync(0xFFFFFFFFu, best, off);
    if (k2 > best_key || (k2 == best_key && b2 < best)) {
      best_key = k2;
      best = b2;
    }
  }
  *violated = __any_sync(0xFFFFFFFFu, any);
  *choice = best;
}

// The justification walk from `var`, wanting variable value `want`: returns
// the variable to flip and sets `want` to the value it must take.
template <typename T>
__device__ __forceinline__ int walk(const Query& t, const T* xr, int var,
                                    int* want_io, int depth,
                                    uint32_t coin_base) {
  int cur = var, want = *want_io;
  for (int d = 0; d < depth; ++d) {
    if (__ldg(t.is_gate + cur) != 1) break;
    const int av_i = __ldg(t.ga_var + cur), an = __ldg(t.ga_neg + cur);
    const int bv_i = __ldg(t.gb_var + cur), bn = __ldg(t.gb_neg + cur);
    const int av = ((int)xr[av_i]) ^ an;
    const int bv = ((int)xr[bv_i]) ^ bn;
    if ((av & bv) == want) break;  // justified
    const bool coin = hash32(coin_base ^ ((uint32_t)d * kDepth)) & 1u;
    const bool choose_b =
        want == 1 ? ((av == 1 && bv == 0) || (av == 0 && bv == 0 && coin))
                  : ((av == 0 && bv == 1) || (av == 1 && bv == 1 && coin));
    cur = choose_b ? bv_i : av_i;
    want ^= choose_b ? bn : an;
  }
  *want_io = want;
  return cur;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    circuit_round_kernel(Tables tables, const int* __restrict__ x_in,
                         int* x_out, bool* __restrict__ found_out,
                         int lanes, int levels, int width, int v1, int roots,
                         int steps, int walk_depth, uint32_t seed,
                         int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.y;
  const int lane0 = blockIdx.x * per_block;
  const int nl = min(per_block, lanes - lane0);
  const int tid = threadIdx.x, warp = tid >> 5;

  Query t;
  const size_t qlw = (size_t)q * levels * width;
  const size_t qv = (size_t)q * v1, qr = (size_t)q * roots;
  t.out_idx = tables.out_idx + qlw;
  t.a_var = tables.a_var + qlw;
  t.a_neg = tables.a_neg + qlw;
  t.b_var = tables.b_var + qlw;
  t.b_neg = tables.b_neg + qlw;
  t.ga_var = tables.ga_var + qv;
  t.ga_neg = tables.ga_neg + qv;
  t.gb_var = tables.gb_var + qv;
  t.gb_neg = tables.gb_neg + qv;
  t.is_gate = tables.is_gate + qv;
  t.root_var = tables.root_var + qr;
  t.root_neg = tables.root_neg + qr;
  t.root_mask = tables.root_mask + qr;
  t.rows = tables.rows + (size_t)q * levels;
  t.levels = levels;
  t.width = width;
  t.roots = roots;

  // the block's x rows: bytes in shared memory, or x_out's own rows
  const size_t first = ((size_t)q * lanes + lane0) * v1;
  T* base;
  size_t stride;
  if (sizeof(T) == 1) {
    base = reinterpret_cast<T*>(smem);
    stride = ((size_t)v1 + 15) & ~(size_t)15;
  } else {
    base = reinterpret_cast<T*>(x_out + first);
    stride = v1;
  }
  for (int k = 0; k < nl; ++k)
    for (int v = tid; v < v1; v += kThreads)
      base[(size_t)k * stride + v] = (T)x_in[first + (size_t)k * v1 + v];
  __syncthreads();

  const bool owner = warp < nl;  // warp w serves lane lane0 + w
  T* my_row = base + (size_t)(owner ? warp : 0) * stride;
  const uint32_t salt =
      ((uint32_t)q * kQuery) ^ ((uint32_t)(lane0 + warp) * kLane);
  bool found = false;
  for (int step = 0; step < steps; ++step) {
    simulate(t, base, stride, nl);
    const uint32_t step_key = hash32(seed ^ ((uint32_t)step * kStep));
    if (owner) {
      bool violated;
      int choice;
      pick_root(t, my_row, step_key, salt, &violated, &choice);
      found |= !violated;
      if (!found && (tid & 31) == 0) {
        int want = 1 ^ __ldg(t.root_neg + choice);
        const int var = walk(t, my_row, __ldg(t.root_var + choice), &want,
                             walk_depth, (step_key ^ kCoin) ^ salt);
        my_row[var] = (T)want;
      }
    }
    __syncthreads();
  }
  simulate(t, base, stride, nl);
  if (owner) {
    bool violated;
    int choice;
    pick_root(t, my_row, 0u, salt, &violated, &choice);
    found |= !violated;
    if ((tid & 31) == 0) found_out[(size_t)q * lanes + lane0 + warp] = found;
  }
  if (sizeof(T) == 1) {
    __syncthreads();
    for (int k = 0; k < nl; ++k)
      for (int v = tid; v < v1; v += kThreads)
        x_out[first + (size_t)k * v1 + v] = (int)base[(size_t)k * stride + v];
  }
}

}  // namespace

extern "C" int circuit_round_launch(
    const void* out_idx, const void* a_var, const void* a_neg,
    const void* b_var, const void* b_neg, const void* ga_var,
    const void* ga_neg, const void* gb_var, const void* gb_neg,
    const void* is_gate, const void* root_var, const void* root_neg,
    const void* root_mask, const void* rows, const void* x_in, void* x_out,
    void* found, int queries, int lanes, int levels, int width, int v1,
    int roots, int steps, int walk_depth, unsigned seed, int per_block,
    int smem_path, void* stream) {
  if (per_block < 1 || per_block > kLanesMax)
    return (int)cudaErrorInvalidValue;
  Tables tables = {
      (const int*)out_idx, (const int*)a_var,   (const int*)a_neg,
      (const int*)b_var,   (const int*)b_neg,   (const int*)ga_var,
      (const int*)ga_neg,  (const int*)gb_var,  (const int*)gb_neg,
      (const int*)is_gate, (const int*)root_var, (const int*)root_neg,
      (const int*)root_mask, (const int*)rows};
  const dim3 grid((lanes + per_block - 1) / per_block, queries);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_path) {
    const size_t smem = (size_t)per_block * (((size_t)v1 + 15) & ~(size_t)15);
    cudaError_t err = cudaFuncSetAttribute(
        circuit_round_kernel<uint8_t>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    circuit_round_kernel<uint8_t><<<grid, kThreads, smem, s>>>(
        tables, (const int*)x_in, (int*)x_out, (bool*)found, lanes, levels,
        width, v1, roots, steps, walk_depth, seed, per_block);
  } else {
    circuit_round_kernel<int><<<grid, kThreads, 0, s>>>(
        tables, (const int*)x_in, (int*)x_out, (bool*)found, lanes, levels,
        width, v1, roots, steps, walk_depth, seed, per_block);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* circuit_round_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
