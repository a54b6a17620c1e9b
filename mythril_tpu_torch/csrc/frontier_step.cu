// The batched frontier step (K6, with K7's division inside) for Hopper
// (sm_90a).
//
// Replaces mythril_tpu/laser/frontier/kernel.py `_build_jax_step` (the XLA
// program jit(vmap(_exec)), _exec at :172-286) and, inside it,
// mythril_tpu/laser/frontier/words.py `_divmod_bitserial` (:136-158). It
// computes what `_exec` computes for one straight-line Run over N sibling
// EVM states, bit for bit: the stack words the run leaves, the memory
// window and its written mask, msize, both gas bounds and the `ok` mask,
// the (offset, value) of every MSTORE/MSTORE8 in run order, and the two
// words a terminal JUMPI or RETURN pops.
//
// The program is data. gpu/frontier_kernel.py encodes each Run once into
// an int32 op table of (kind, arg, gas_min, gas_max) and a pool of
// PUSH/PC constants, so one build of this file serves every run: nothing
// is compiled per run or per batch shape, and batches are not padded.
//
// One thread per row walks the table. A word is 8 x u32 (w[0] least
// significant) in registers while an op works on it; the stack slots live
// in a global scratch of capacity x 8 x N u32 (slot-major, rows
// innermost, so a warp's rows touch neighbouring addresses). The frame's
// words are 32 big-endian byte limbs in int32 and are converted at the
// edges. Every row computes every op, as the vectorised `_exec` does;
// only the memory stores are masked by `ok`.
//
// What bounds it on this card: neither bytes nor operations. A step's
// frame is a few KiB per row and a run is tens of ops; the launch and the
// host's upload and download of the frame (gpu/frontier_kernel.py) are
// the cost. K7 is a 256-step restoring division whose steps depend on
// each other (about 10 dependent instructions a step on 8 words).
// What the design does about it: nothing yet beyond one launch per step
// (the XLA program was one fused launch too). A warp per row with the
// limbs across lanes, frames kept on the device between steps, and CUDA
// graphs across a chain of runs are later work.
//
// Semantics carried over from the plain version, and easy to get wrong:
//  - gas accrues after every op, then ok &= min_gas <= gas_limit;
//  - memory offsets: a word whose bytes 0..28 are not all zero, or whose
//    low 24 bits plus the access size pass the window, is out of bounds:
//    the row's ok drops and the offset is clamped to 0;
//  - memory extension (MachineState.mem_extend): word-aligned growth; the
//    fee 3w + w*w/512 is charged as fee(new) - fee(old) only on a row
//    that extends (msize <= end and new words > old words), in int32;
//  - MSTORE8 writes the value's low byte but logs the whole word;
//  - division by zero yields (0, 0); SDIV divides the absolute values and
//    negates when the signs differ (-2^255 / -1 = -2^255); SMOD takes the
//    dividend's sign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLimbs = 32;  // byte limbs of a frame word
constexpr int kWords = 8;   // u32 words of a kernel word

// micro-op kinds and binary ops: the order of gpu/frontier_kernel.py's
// KINDS and BIN_OPS
enum Kind {
  kPush, kDup, kSwap, kPop, kBin, kNot, kIszero, kByte, kShl, kShr, kSar,
  kSignextend, kMload, kMstore, kMstore8, kJumpi, kReturn, kStop,
  kCalldataload, kMsize, kPc, kNop
};
enum BinOp {
  bAdd, bSub, bMul, bDiv, bMod, bSdiv, bSmod, bAnd, bOr, bXor, bLt, bGt,
  bSlt, bSgt, bEq
};

struct Word {
  uint32_t w[kWords];
};

__device__ __forceinline__ Word zero_word() {
  Word r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = 0u;
  return r;
}

__device__ __forceinline__ Word small_word(uint32_t v) {
  Word r = zero_word();
  r.w[0] = v;
  return r;
}

__device__ __forceinline__ bool is_zero(const Word& a) {
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) any |= a.w[k];
  return any == 0u;
}

__device__ __forceinline__ bool eq(const Word& a, const Word& b) {
  uint32_t diff = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) diff |= a.w[k] ^ b.w[k];
  return diff == 0u;
}

__device__ __forceinline__ bool ult(const Word& a, const Word& b) {
#pragma unroll
  for (int k = kWords - 1; k >= 0; --k) {
    if (a.w[k] != b.w[k]) return a.w[k] < b.w[k];
  }
  return false;
}

__device__ __forceinline__ bool slt(const Word& a, const Word& b) {
  Word fa = a, fb = b;
  fa.w[kWords - 1] ^= 0x80000000u;
  fb.w[kWords - 1] ^= 0x80000000u;
  return ult(fa, fb);
}

__device__ __forceinline__ Word add(const Word& a, const Word& b) {
  Word r;
  uint64_t carry = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    r.w[k] = (uint32_t)t;
    carry = t >> 32;
  }
  return r;
}

__device__ __forceinline__ Word sub(const Word& a, const Word& b) {
  Word r;
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t t = (uint64_t)a.w[k] - b.w[k] - borrow;
    r.w[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return r;
}

__device__ __forceinline__ Word negate(const Word& a) {
  return sub(zero_word(), a);
}

// the truncated 256-bit product: schoolbook over u32 limbs, u64 partials
__device__ __forceinline__ Word mul(const Word& a, const Word& b) {
  Word r = zero_word();
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t carry = 0u;
#pragma unroll
    for (int j = 0; j < kWords - i; ++j) {
      uint64_t t = (uint64_t)a.w[i] * b.w[j] + r.w[i + j] + carry;
      r.w[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return r;
}

__device__ __forceinline__ uint32_t bit_at(const Word& a, int i) {
  return (a.w[i >> 5] >> (i & 31)) & 1u;
}

// K7: unsigned restoring division, one dividend bit a step from the
// highest set bit down (the steps above it leave the remainder 0). The
// remainder stays below 2^256: before each shift it is at most the
// dividend's prefix above the next bit. Division by zero yields (0, 0).
__device__ void divmod_unsigned(const Word& a, const Word& b, Word& q,
                                Word& r) {
  q = zero_word();
  r = zero_word();
  if (is_zero(b)) return;
  int top = -1;
#pragma unroll
  for (int k = kWords - 1; k >= 0; --k) {
    if (top < 0 && a.w[k] != 0u) top = k * 32 + 31 - __clz(a.w[k]);
  }
  for (int i = top; i >= 0; --i) {
    // r = r * 2 + bit i of a
#pragma unroll
    for (int k = kWords - 1; k > 0; --k) {
      r.w[k] = (r.w[k] << 1) | (r.w[k - 1] >> 31);
    }
    r.w[0] = (r.w[0] << 1) | bit_at(a, i);
    if (!ult(r, b)) {
      r = sub(r, b);
      q.w[i >> 5] |= 1u << (i & 31);
    }
  }
}

__device__ __forceinline__ bool negative(const Word& a) {
  return (a.w[kWords - 1] >> 31) != 0u;
}

__device__ __forceinline__ Word abs_word(const Word& a) {
  return negative(a) ? negate(a) : a;
}

__device__ Word binary(int op, const Word& a, const Word& b) {
  Word q, r;
  switch (op) {
    case bAdd: return add(a, b);
    case bSub: return sub(a, b);
    case bMul: return mul(a, b);
    case bDiv: divmod_unsigned(a, b, q, r); return q;
    case bMod: divmod_unsigned(a, b, q, r); return r;
    case bSdiv:
      divmod_unsigned(abs_word(a), abs_word(b), q, r);
      return (negative(a) != negative(b)) ? negate(q) : q;
    case bSmod:
      divmod_unsigned(abs_word(a), abs_word(b), q, r);
      return negative(a) ? negate(r) : r;
    case bAnd: {
      Word t;
#pragma unroll
      for (int k = 0; k < kWords; ++k) t.w[k] = a.w[k] & b.w[k];
      return t;
    }
    case bOr: {
      Word t;
#pragma unroll
      for (int k = 0; k < kWords; ++k) t.w[k] = a.w[k] | b.w[k];
      return t;
    }
    case bXor: {
      Word t;
#pragma unroll
      for (int k = 0; k < kWords; ++k) t.w[k] = a.w[k] ^ b.w[k];
      return t;
    }
    case bLt: return small_word(ult(a, b) ? 1u : 0u);
    case bGt: return small_word(ult(b, a) ? 1u : 0u);
    case bSlt: return small_word(slt(a, b) ? 1u : 0u);
    case bSgt: return small_word(slt(b, a) ? 1u : 0u);
    default: return small_word(eq(a, b) ? 1u : 0u);  // bEq
  }
}

// true when the word is at least `limit` (a small bound)
__device__ __forceinline__ bool at_least(const Word& a, uint32_t limit) {
  uint32_t high = 0u;
#pragma unroll
  for (int k = 1; k < kWords; ++k) high |= a.w[k];
  return high != 0u || a.w[0] >= limit;
}

// EVM BYTE: byte `index` of `value`, 0 = most significant
__device__ __forceinline__ Word byte_op(const Word& index, const Word& value) {
  if (at_least(index, 32u)) return zero_word();
  int from_low = 31 - (int)index.w[0];
  return small_word((value.w[from_low >> 2] >> (8 * (from_low & 3))) & 0xFFu);
}

__device__ Word shift_left(const Word& v, int s) {
  Word r;
  int ws = s >> 5, bs = s & 31;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t hi = (k - ws >= 0) ? (v.w[k - ws] << bs) : 0u;
    uint32_t lo = (bs != 0 && k - ws - 1 >= 0)
                      ? (v.w[k - ws - 1] >> (32 - bs)) : 0u;
    r.w[k] = hi | lo;
  }
  return r;
}

__device__ Word shift_right(const Word& v, int s) {
  Word r;
  int ws = s >> 5, bs = s & 31;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t lo = (k + ws < kWords) ? (v.w[k + ws] >> bs) : 0u;
    uint32_t hi = (bs != 0 && k + ws + 1 < kWords)
                      ? (v.w[k + ws + 1] << (32 - bs)) : 0u;
    r.w[k] = hi | lo;
  }
  return r;
}

__device__ Word not_word(const Word& a) {
  Word r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = ~a.w[k];
  return r;
}

__device__ Word shl(const Word& shift, const Word& value) {
  if (at_least(shift, 256u)) return zero_word();
  return shift_left(value, (int)shift.w[0]);
}

__device__ Word shr(const Word& shift, const Word& value) {
  if (at_least(shift, 256u)) return zero_word();
  return shift_right(value, (int)shift.w[0]);
}

// arithmetic shift: a negative value shifts in ones, ~(~v >> s)
__device__ Word sar(const Word& shift, const Word& value) {
  bool neg = negative(value);
  if (at_least(shift, 256u)) return neg ? not_word(zero_word()) : zero_word();
  if (!neg) return shift_right(value, (int)shift.w[0]);
  return not_word(shift_right(not_word(value), (int)shift.w[0]));
}

// EVM SIGNEXTEND: the sign bit is bit 8 * pos + 7; pos >= 31 is the
// identity
__device__ Word signextend(const Word& pos, const Word& value) {
  if (at_least(pos, 31u)) return value;
  int bit = 8 * (int)pos.w[0] + 7;
  int wi = bit >> 5, bi = bit & 31;
  uint32_t sign = (value.w[wi] >> bi) & 1u;
  uint32_t keep = (bi == 31) ? 0xFFFFFFFFu : ((1u << (bi + 1)) - 1u);
  Word r = value;
  r.w[wi] = sign ? (value.w[wi] | ~keep) : (value.w[wi] & keep);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (k > wi) r.w[k] = sign ? 0xFFFFFFFFu : 0u;
  }
  return r;
}

// memory offset word -> small offset, or out of bounds (clamped to 0)
__device__ __forceinline__ int mem_offset(const Word& w, int size, int window,
                                          bool& oob) {
  uint32_t high = w.w[0] >> 24;
#pragma unroll
  for (int k = 1; k < kWords; ++k) high |= w.w[k];
  int small = (int)(w.w[0] & 0xFFFFFFu);
  oob = high != 0u || small + size > window;
  return oob ? 0 : small;
}

__device__ __forceinline__ int expansion_fee(int words) {
  return words * 3 + words * words / 512;
}

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// MachineState.mem_extend for a concrete offset, in int32
__device__ __forceinline__ void mem_extend(int off, int size, int& msize,
                                           int& min_gas, int& max_gas,
                                           int gas_limit, bool& ok) {
  int end = off + size;
  int needed = ((end + 31) / 32) * 32;
  int new_words = needed / 32;
  int old_words = msize / 32;
  bool extend = msize <= end && new_words > old_words;
  int fee = extend ? expansion_fee(new_words) - expansion_fee(old_words) : 0;
  min_gas = add32(min_gas, fee);
  max_gas = add32(max_gas, fee);
  ok = ok && min_gas <= gas_limit;
  if (extend) msize = needed;
}

// frame word (32 big-endian byte limbs in int32) <-> kernel word
__device__ __forceinline__ Word load_limbs(const int* limbs) {
  Word r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int* p = limbs + kLimbs - 4 * (k + 1);
    r.w[k] = ((uint32_t)(p[0] & 0xFF) << 24) | ((uint32_t)(p[1] & 0xFF) << 16)
             | ((uint32_t)(p[2] & 0xFF) << 8) | (uint32_t)(p[3] & 0xFF);
  }
  return r;
}

__device__ __forceinline__ void store_limbs(int* limbs, const Word& a) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    int* p = limbs + kLimbs - 4 * (k + 1);
    p[0] = (int)(a.w[k] >> 24);
    p[1] = (int)((a.w[k] >> 16) & 0xFFu);
    p[2] = (int)((a.w[k] >> 8) & 0xFFu);
    p[3] = (int)(a.w[k] & 0xFFu);
  }
}

struct Frame {
  const int* ops;           // [n_ops, 4] (kind, arg, gas_min, gas_max)
  const uint32_t* consts;   // [n_consts, 8] words, w[0] first
  const int* stack_in;      // [rows, touch, 32]
  int* stack_out;           // [rows, out_len, 32]
  uint32_t* scratch;        // [capacity, 8, rows]
  int* mem;                 // [rows, window], updated in place
  uint8_t* written;         // [rows, window], updated in place
  const int* msize_in;      // [rows] each
  const int* min_gas_in;
  const int* max_gas_in;
  const int* gas_limit;
  const uint8_t* live;
  int* msize_out;
  int* min_gas_out;
  int* max_gas_out;
  uint8_t* ok_out;
  int* log_off;             // [rows, n_log]
  int* log_val;             // [rows, n_log, 32]
  int* fork_out;            // [rows, n_fork, 32]
  int n_ops, touch, out_len, capacity, window, n_log, n_fork, rows;
};

__device__ __forceinline__ Word load_slot(const Frame& f, int slot, int row) {
  Word r;
  const uint32_t* base = f.scratch + (size_t)slot * kWords * f.rows + row;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = base[(size_t)k * f.rows];
  return r;
}

__device__ __forceinline__ void store_slot(const Frame& f, int slot, int row,
                                           const Word& a) {
  uint32_t* base = f.scratch + (size_t)slot * kWords * f.rows + row;
#pragma unroll
  for (int k = 0; k < kWords; ++k) base[(size_t)k * f.rows] = a.w[k];
}

__device__ __forceinline__ Word const_word(const Frame& f, int index) {
  Word r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = __ldg(f.consts + index * kWords + k);
  return r;
}

__global__ void frontier_step_kernel(Frame f) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= f.rows) return;
  for (int j = 0; j < f.touch; ++j) {
    store_slot(f, j, row,
               load_limbs(f.stack_in + ((size_t)row * f.touch + j) * kLimbs));
  }
  int sp = f.touch;
  int msize = f.msize_in[row];
  int min_gas = f.min_gas_in[row];
  int max_gas = f.max_gas_in[row];
  const int gas_limit = f.gas_limit[row];
  bool ok = f.live[row] != 0;
  int* mem = f.mem + (size_t)row * f.window;
  uint8_t* written = f.written + (size_t)row * f.window;
  int log_index = 0, fork_index = 0;
  for (int pc = 0; pc < f.n_ops; ++pc) {
    const int kind = __ldg(f.ops + 4 * pc);
    const int arg = __ldg(f.ops + 4 * pc + 1);
    switch (kind) {
      case kPush:
      case kPc:
        store_slot(f, sp++, row, const_word(f, arg));
        break;
      case kDup:
        store_slot(f, sp, row, load_slot(f, sp - arg, row));
        ++sp;
        break;
      case kSwap: {
        Word top = load_slot(f, sp - 1, row);
        store_slot(f, sp - 1, row, load_slot(f, sp - 1 - arg, row));
        store_slot(f, sp - 1 - arg, row, top);
        break;
      }
      case kPop:
        --sp;
        break;
      case kBin: {
        Word a = load_slot(f, sp - 1, row);
        Word b = load_slot(f, sp - 2, row);
        sp -= 2;
        store_slot(f, sp++, row, binary(arg, a, b));
        break;
      }
      case kNot:
        store_slot(f, sp - 1, row, not_word(load_slot(f, sp - 1, row)));
        break;
      case kIszero:
        store_slot(f, sp - 1, row,
                   small_word(is_zero(load_slot(f, sp - 1, row)) ? 1u : 0u));
        break;
      case kByte:
      case kShl:
      case kShr:
      case kSar:
      case kSignextend: {
        Word a = load_slot(f, sp - 1, row);  // index / shift / position
        Word b = load_slot(f, sp - 2, row);  // value
        sp -= 2;
        Word r = kind == kByte ? byte_op(a, b)
                 : kind == kShl ? shl(a, b)
                 : kind == kShr ? shr(a, b)
                 : kind == kSar ? sar(a, b)
                 : signextend(a, b);
        store_slot(f, sp++, row, r);
        break;
      }
      case kMload: {
        bool oob;
        int off = mem_offset(load_slot(f, sp - 1, row), 32, f.window, oob);
        ok = ok && !oob;
        mem_extend(off, 32, msize, min_gas, max_gas, gas_limit, ok);
        int limbs[kLimbs];
#pragma unroll
        for (int p = 0; p < kLimbs; ++p) limbs[p] = mem[off + p];
        store_slot(f, sp - 1, row, load_limbs(limbs));
        break;
      }
      case kMstore:
      case kMstore8: {
        const int size = kind == kMstore ? 32 : 1;
        bool oob;
        int off = mem_offset(load_slot(f, sp - 1, row), size, f.window, oob);
        Word value = load_slot(f, sp - 2, row);
        sp -= 2;
        ok = ok && !oob;
        mem_extend(off, size, msize, min_gas, max_gas, gas_limit, ok);
        int* logged = f.log_val + ((size_t)row * f.n_log + log_index) * kLimbs;
        store_limbs(logged, value);
        f.log_off[(size_t)row * f.n_log + log_index] = off;
        ++log_index;
        if (ok) {
          for (int p = 0; p < size; ++p) {
            mem[off + p] = logged[kLimbs - size + p];
            written[off + p] = 1;
          }
        }
        break;
      }
      case kJumpi:
      case kReturn:
        // destination then condition, or offset then length
        for (int k = 0; k < 2; ++k) {
          store_limbs(
              f.fork_out + ((size_t)row * f.n_fork + fork_index) * kLimbs,
              load_slot(f, sp - 1, row));
          --sp;
          ++fork_index;
        }
        break;
      case kCalldataload:  // the lane's placeholder: decode builds the term
        store_slot(f, sp - 1, row, zero_word());
        break;
      case kMsize:
        store_slot(f, sp++, row, small_word((uint32_t)msize));
        break;
      default:  // kStop, kNop
        break;
    }
    min_gas = add32(min_gas, __ldg(f.ops + 4 * pc + 2));
    max_gas = add32(max_gas, __ldg(f.ops + 4 * pc + 3));
    ok = ok && min_gas <= gas_limit;
  }
  for (int j = 0; j < f.out_len; ++j) {
    store_limbs(f.stack_out + ((size_t)row * f.out_len + j) * kLimbs,
                load_slot(f, j, row));
  }
  f.msize_out[row] = msize;
  f.min_gas_out[row] = min_gas;
  f.max_gas_out[row] = max_gas;
  f.ok_out[row] = ok ? 1 : 0;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// Launches one step on `stream`; returns cudaGetLastError() of the launch
// (0 when it was accepted). Allocates nothing.
int frontier_step_launch(
    const int* ops, const uint32_t* consts, const int* stack_in,
    int* stack_out, uint32_t* scratch, int* mem, uint8_t* written,
    const int* msize_in, const int* min_gas_in, const int* max_gas_in,
    const int* gas_limit, const uint8_t* live, int* msize_out,
    int* min_gas_out, int* max_gas_out, uint8_t* ok_out, int* log_off,
    int* log_val, int* fork_out, int n_ops, int touch, int out_len,
    int capacity, int window, int n_log, int n_fork, int rows,
    void* stream) {
  Frame f;
  f.ops = ops;
  f.consts = consts;
  f.stack_in = stack_in;
  f.stack_out = stack_out;
  f.scratch = scratch;
  f.mem = mem;
  f.written = written;
  f.msize_in = msize_in;
  f.min_gas_in = min_gas_in;
  f.max_gas_in = max_gas_in;
  f.gas_limit = gas_limit;
  f.live = live;
  f.msize_out = msize_out;
  f.min_gas_out = min_gas_out;
  f.max_gas_out = max_gas_out;
  f.ok_out = ok_out;
  f.log_off = log_off;
  f.log_val = log_val;
  f.fork_out = fork_out;
  f.n_ops = n_ops;
  f.touch = touch;
  f.out_len = out_len;
  f.capacity = capacity;
  f.window = window;
  f.n_log = n_log;
  f.n_fork = n_fork;
  f.rows = rows;
  if (rows <= 0) return 0;
  int blocks = (rows + kThreads - 1) / kThreads;
  frontier_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}

const char* frontier_step_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
