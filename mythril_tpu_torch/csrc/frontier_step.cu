// The batched frontier step (K6, with K7's division inside) for Hopper
// (sm_90a).
//
// Replaces mythril_tpu/laser/frontier/kernel.py `_build_jax_step` (:316,
// the XLA program jit(vmap(_exec)), _exec at :172-286) and, inside it,
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
// What bounds it on this card: neither bytes nor operations. A row's frame
// is a few KiB and a run tens of ops, each depending on the one before;
// the step pays the chain's latency, the launch and the host's two
// copies. The design works on all three:
//  - a group of 8 lanes works a row, lane k holding u32 word k of every
//    256-bit value (word 0 least significant), so a warp holds 4 rows and
//    every row runs the same op sequence in lockstep. A block holds at
//    most kMaxBlockRows rows, fewer when the run's stack does not fit
//    (gpu/frontier_kernel.block_rows), so a 64-row batch spreads over
//    several SMs;
//  - the run's stack lives in dynamic shared memory, `pitch` slots a row
//    (the run's capacity rounded up to odd, so the 4 rows of a warp fall
//    on different banks) of 8 words. PUSH/DUP/SWAP/POP are one 4-byte
//    shared access a lane; there is no global scratch;
//  - word ops cross the group with shuffles and ballots: ADD/SUB by carry
//    lookahead over the group's generate/propagate bits, the comparisons
//    by the highest word that differs, MUL by columns of the 8 x 8
//    partial products and one carry pass, the shifts by two shuffles and
//    a funnel shift;
//  - K7 is Knuth's Algorithm D on 32-bit digits (at most 8 digit steps,
//    each a 64-by-32 estimate by a reciprocal multiply, a multiply-
//    subtract and a rare add-back) with a short path for one-digit
//    divisors, run by every lane of the group on the 8 words gathered by
//    shuffles (no divergence inside the group, no shared-memory round
//    trip), its digits in registers. On the card this beat sharing the
//    multiply-subtract across the group by lookahead (PERF.md, Findings).
//    Quotient and remainder are unique, so it gives the bit-serial
//    reference's bits;
//  - each op and its constant word are loaded one op ahead, so their
//    latency hides behind the op before;
//  - frame words arrive as 32 big-endian byte limbs in int32: lane k
//    reads limbs 28-4k..31-4k of a slot as one 16-byte load (the group's
//    8 lanes cover the slot's 128 bytes) and converts them, and converts
//    back on the way out;
//  - one launch a step with one host-to-device and one device-to-host copy
//    of a packed frame, issued by frontier_step below in one call.
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

constexpr int kLimbs = 32;        // byte limbs of a frame word
constexpr int kWords = 8;         // u32 words of a kernel word
constexpr int kGroup = 8;         // lanes a row: one word each
constexpr int kMaxBlockRows = 8;  // gpu/frontier_kernel.MAX_BLOCK_ROWS
constexpr size_t kDefaultSmem = 48 * 1024;

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

// The kernel's argument, mirrored by gpu/frontier_kernel.py's _Frame.
struct Frame {
  const int* ops;           // [n_ops, 4] (kind, arg, gas_min, gas_max)
  const uint32_t* consts;   // [n_consts, 8] words, w[0] first
  const int* stack_in;      // [rows, touch, 32]
  const int* msize_in;      // [rows] each
  const int* min_gas_in;
  const int* max_gas_in;
  const int* gas_limit;
  const uint8_t* live;
  int* mem;                 // [rows, window], updated in place
  uint8_t* written;         // [rows, window], updated in place
  int* stack_out;           // [rows, out_len, 32]
  int* msize_out;           // [rows] each
  int* min_gas_out;
  int* max_gas_out;
  uint8_t* ok_out;
  int* log_off;             // [rows, n_log]
  int* log_val;             // [rows, n_log, 32]
  int* fork_out;            // [rows, n_fork, 32]
  int n_ops, touch, out_len, pitch, window, n_log, n_fork, rows, block_rows;
};

// One step, mirrored by gpu/frontier_kernel.py's _StepArgs: the frame and
// the packed copies around the launch (sizes 0: no copy).
struct StepArgs {
  Frame frame;
  const void* upload_src;   // pinned host buffer
  void* upload_dst;         // device buffer
  const void* download_src;
  void* download_dst;
  long long upload_bytes;
  long long download_bytes;  // > 0: copy back, then synchronise
};

// The 8 lanes of a row.
struct Group {
  unsigned mask;  // the lanes of the warp that exist
  int base;       // the group's first lane in its warp
  int k;          // this lane's word
};

// bit i: the predicate of the group's lane i
__device__ __forceinline__ uint32_t bits(const Group& g, bool p) {
  return (__ballot_sync(g.mask, p) >> g.base) & 0xFFu;
}

// word `src` (taken mod 8) of the group's value
__device__ __forceinline__ uint32_t word_of(const Group& g, uint32_t v,
                                            int src) {
  return __shfl_sync(g.mask, v, g.base + (src & 7));
}

__device__ __forceinline__ uint32_t small_word(const Group& g, uint32_t v) {
  return g.k == 0 ? v : 0u;
}

// a + b and a - b: the carry (borrow) into word k is the carry into bit k
// of x + gen, x = gen | propagate (generate and propagate are exclusive)
__device__ __forceinline__ uint32_t add_w(const Group& g, uint32_t a,
                                          uint32_t b) {
  uint32_t s = a + b;
  uint32_t gen = bits(g, s < a);
  uint32_t x = gen | bits(g, s == 0xFFFFFFFFu);
  uint32_t carry = (x + gen) ^ x ^ gen;
  return s + ((carry >> g.k) & 1u);
}

__device__ __forceinline__ uint32_t sub_w(const Group& g, uint32_t a,
                                          uint32_t b) {
  uint32_t d = a - b;
  uint32_t gen = bits(g, a < b);
  uint32_t x = gen | bits(g, d == 0u);
  uint32_t borrow = (x + gen) ^ x ^ gen;
  return d - ((borrow >> g.k) & 1u);
}

// a < b (unsigned) in every lane: decided by the highest word that differs
__device__ __forceinline__ bool ult_w(const Group& g, uint32_t a,
                                      uint32_t b) {
  uint32_t diff = bits(g, a != b);
  uint32_t less = bits(g, a < b);
  int top = 31 - __clz(diff | 1u);
  return diff != 0u && ((less >> top) & 1u) != 0u;
}

__device__ __forceinline__ bool slt_w(const Group& g, uint32_t a,
                                      uint32_t b) {
  uint32_t flip = g.k == kWords - 1 ? 0x80000000u : 0u;
  return ult_w(g, a ^ flip, b ^ flip);
}

__device__ __forceinline__ bool is_zero_w(const Group& g, uint32_t a) {
  return bits(g, a != 0u) == 0u;
}

// the truncated 256-bit product: lane k sums column k of the partial
// products (low halves) and column k - 1 (high halves), then one carry
// pass adds each column's overflow into the next
__device__ uint32_t mul_w(const Group& g, uint32_t a, uint32_t b) {
  uint64_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint32_t ai = word_of(g, a, i);
    uint32_t bj = word_of(g, b, g.k - i);
    uint64_t p = i <= g.k ? (uint64_t)ai * bj : 0u;
    lo += (uint32_t)p;
    hi += p >> 32;
  }
  uint64_t below = __shfl_sync(g.mask, hi, g.base + ((g.k - 1) & 7));
  uint64_t t = lo + (g.k == 0 ? 0u : below);  // < 2^36
  uint32_t up = word_of(g, (uint32_t)(t >> 32), g.k - 1);
  return add_w(g, (uint32_t)t, g.k == 0 ? 0u : up);
}

// word 0 of a value, and whether any higher word is set
struct Small {
  uint32_t low;
  bool high;
};

__device__ __forceinline__ Small small_of(const Group& g, uint32_t a) {
  Small s;
  s.low = word_of(g, a, 0);
  s.high = bits(g, g.k != 0 && a != 0u) != 0u;
  return s;
}

// EVM BYTE: byte `index` of `value`, 0 = most significant
__device__ uint32_t byte_w(const Group& g, uint32_t index, uint32_t value) {
  Small i = small_of(g, index);
  int from_low = 31 - (int)(i.low & 31u);
  uint32_t w = word_of(g, value, from_low >> 2);
  uint32_t byte = (w >> (8 * (from_low & 3))) & 0xFFu;
  return (i.high || i.low >= 32u) ? 0u : small_word(g, byte);
}

// value << amount, value >> amount, amount < 256
__device__ __forceinline__ uint32_t shl_bits(const Group& g, uint32_t value,
                                             uint32_t amount) {
  int src = g.k - (int)(amount >> 5);
  uint32_t hi = word_of(g, value, src);
  uint32_t lo = word_of(g, value, src - 1);
  return __funnelshift_l(src >= 1 ? lo : 0u, src >= 0 ? hi : 0u,
                         amount & 31u);
}

__device__ __forceinline__ uint32_t shr_bits(const Group& g, uint32_t value,
                                             uint32_t amount) {
  int src = g.k + (int)(amount >> 5);
  uint32_t lo = word_of(g, value, src);
  uint32_t hi = word_of(g, value, src + 1);
  return __funnelshift_r(src < kWords ? lo : 0u,
                         src + 1 < kWords ? hi : 0u, amount & 31u);
}

__device__ uint32_t shl_w(const Group& g, uint32_t shift, uint32_t value) {
  Small s = small_of(g, shift);
  uint32_t r = shl_bits(g, value, s.low & 255u);
  return (s.high || s.low >= 256u) ? 0u : r;
}

__device__ uint32_t shr_w(const Group& g, uint32_t shift, uint32_t value) {
  Small s = small_of(g, shift);
  uint32_t r = shr_bits(g, value, s.low & 255u);
  return (s.high || s.low >= 256u) ? 0u : r;
}

// arithmetic shift: a negative value shifts in ones, ~(~v >> s)
__device__ uint32_t sar_w(const Group& g, uint32_t shift, uint32_t value) {
  Small s = small_of(g, shift);
  uint32_t fill = (word_of(g, value, kWords - 1) >> 31) ? 0xFFFFFFFFu : 0u;
  uint32_t r = shr_bits(g, value ^ fill, s.low & 255u) ^ fill;
  return (s.high || s.low >= 256u) ? fill : r;
}

// EVM SIGNEXTEND: the sign bit is bit 8 * pos + 7; pos >= 31 is the
// identity
__device__ uint32_t signextend_w(const Group& g, uint32_t pos,
                                 uint32_t value) {
  Small p = small_of(g, pos);
  int bit = 8 * (int)(p.low & 31u) + 7;
  int wi = bit >> 5, bi = bit & 31;
  uint32_t sign = (word_of(g, value, wi) >> bi) & 1u;
  uint32_t fill = sign ? 0xFFFFFFFFu : 0u;
  uint32_t keep = bi == 31 ? 0xFFFFFFFFu : ((2u << bi) - 1u);
  uint32_t r = g.k < wi ? value
               : g.k == wi ? ((value & keep) | (fill & ~keep)) : fill;
  return (p.high || p.low >= 31u) ? value : r;
}

// -- K7: division on 32-bit digits, a thread-local copy of the words --------

__device__ __forceinline__ void negate_digits(uint32_t (&x)[kWords]) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t t = 0u - (uint64_t)x[i] - borrow;
    x[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
}

__device__ __forceinline__ bool less_digits(const uint32_t (&a)[kWords],
                                            const uint32_t (&b)[kWords]) {
  bool less = false, decided = false;
#pragma unroll
  for (int i = kWords - 1; i >= 0; --i) {
    if (!decided && a[i] != b[i]) {
      less = a[i] < b[i];
      decided = true;
    }
  }
  return less;
}

// x <<= T digits, x >>= T digits (zeros shifted in), when `on`
template <int T, int N>
__device__ __forceinline__ void shift_up(uint32_t (&x)[N], bool on) {
#pragma unroll
  for (int d = N - 1; d >= 0; --d) {
    x[d] = on ? (d >= T ? x[d >= T ? d - T : 0] : 0u) : x[d];
  }
}

template <int T, int N>
__device__ __forceinline__ void shift_down(uint32_t (&x)[N], bool on) {
#pragma unroll
  for (int d = 0; d < N; ++d) {
    x[d] = on ? (d + T < N ? x[d + T < N ? d + T : 0] : 0u) : x[d];
  }
}

// floor(num / v) and num % v for a normalised digit v (v >= 2^31), from
// r = floor((2^64 - 1) / v): the high half of num * r falls short of the
// quotient by at most 2, so two corrections at most replace a 64-by-32
// division (a long software routine on this card) by a multiply
__device__ __forceinline__ uint64_t div_digit(uint64_t num, uint32_t v,
                                              uint64_t r, uint64_t& rem) {
  uint64_t q = __umul64hi(num, r);
  uint64_t rest = num - q * v;
  while (rest >= v) {
    ++q;
    rest -= v;
  }
  rem = rest;
  return q;
}

// (q, r) = (a / b, a % b), unsigned; division by zero yields (0, 0).
// Knuth's Algorithm D (TAOCP vol. 2, 4.3.1), in the form of Hacker's
// Delight's divmnu: both operands are shifted left by S = 32 * (8 - n) + s
// (n the divisor's digits, s its top digit's leading zeros), so the
// divisor fills all 8 digits with its top bit set and every index below is
// static (the digits stay in registers). The shifted dividend has 16
// digits and quotient digit j is found from the window u[j..j+8]; S leaves
// the quotient alone and scales the remainder, which is shifted back.
__device__ __forceinline__ void divmod_digits(const uint32_t (&a)[kWords],
                                              const uint32_t (&b)[kWords],
                                              uint32_t (&q)[kWords],
                                              uint32_t (&r)[kWords]) {
  int n = 0;
  uint32_t top = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    q[i] = 0u;
    r[i] = 0u;
    if (b[i] != 0u) {
      n = i + 1;
      top = b[i];
    }
  }
  if (n == 0) return;
  if (less_digits(a, b)) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) r[i] = a[i];
    return;
  }
  const int s = __clz(top);
  if (n == 1) {  // one 64-by-32 division a digit, on a << s by b << s
    const uint32_t v = b[0] << s;
    const uint64_t inverse = ~0ull / v;
    uint64_t rem = __funnelshift_l(a[kWords - 1], 0u, s);
#pragma unroll
    for (int i = kWords - 1; i >= 0; --i) {
      uint32_t digit = i > 0 ? __funnelshift_l(a[i - 1], a[i], s) : a[0] << s;
      q[i] = (uint32_t)div_digit((rem << 32) | digit, v, inverse, rem);
    }
    r[0] = (uint32_t)rem >> s;
    return;
  }
  const int ws = kWords - n;
  uint32_t u[2 * kWords], v[kWords];
#pragma unroll
  for (int i = kWords + 1; i < 2 * kWords; ++i) u[i] = 0u;
  u[kWords] = __funnelshift_l(a[kWords - 1], 0u, s);
#pragma unroll
  for (int i = kWords - 1; i > 0; --i) {
    u[i] = __funnelshift_l(a[i - 1], a[i], s);
    v[i] = __funnelshift_l(b[i - 1], b[i], s);
  }
  u[0] = a[0] << s;
  v[0] = b[0] << s;
  shift_up<4>(u, ws & 4);  // the word shift, by ws = 0..6
  shift_up<2>(u, ws & 2);
  shift_up<1>(u, ws & 1);
  shift_up<4>(v, ws & 4);
  shift_up<2>(v, ws & 2);
  shift_up<1>(v, ws & 1);
  // the window w = u[j..j+8] slides down a digit a step; the digits below
  // it wait in `low`, the next on top, and quotient digits enter q from
  // below, so every index is static and the digits stay in registers
  uint32_t w[kWords + 1], low[kWords];
#pragma unroll
  for (int i = 0; i <= kWords; ++i) w[i] = u[i + kWords - 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) low[i] = i > 0 ? u[i - 1] : 0u;
  const uint64_t base = 1ull << 32;
  const uint64_t inverse = ~0ull / v[kWords - 1];
#pragma unroll 1
  for (int step = 0; step < kWords; ++step) {
    if (step > 0) {
      shift_up<1>(w, true);
      w[0] = low[kWords - 1];
      shift_up<1>(low, true);
    }
    // D3: estimate from the window's top two digits, corrected at most
    // twice against v[6]; then qhat is the digit or one too large
    uint64_t num = ((uint64_t)w[kWords] << 32) | w[kWords - 1];
    uint64_t rhat;
    uint64_t qhat = div_digit(num, v[kWords - 1], inverse, rhat);
    if (qhat >= base
        || qhat * v[kWords - 2] > ((rhat << 32) | w[kWords - 2])) {
      --qhat;
      rhat += v[kWords - 1];
      if (rhat < base
          && (qhat >= base
              || qhat * v[kWords - 2] > ((rhat << 32) | w[kWords - 2]))) {
        --qhat;
      }
    }
    // D4: w -= qhat * v
    int64_t borrow = 0, t;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint64_t p = qhat * v[i];
      t = (int64_t)w[i] - borrow - (int64_t)(p & 0xFFFFFFFFu);
      w[i] = (uint32_t)t;
      borrow = (int64_t)(p >> 32) - (t >> 32);
    }
    t = (int64_t)w[kWords] - borrow;
    w[kWords] = (uint32_t)t;
    shift_up<1>(q, true);
    q[0] = (uint32_t)qhat;
    if (t < 0) {  // D6: qhat was one too large; add v back
      q[0] -= 1u;
      uint64_t carry = 0u;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        uint64_t sum = (uint64_t)w[i] + v[i] + carry;
        w[i] = (uint32_t)sum;
        carry = sum >> 32;
      }
      w[kWords] += (uint32_t)carry;
    }
  }
  // D8: the remainder is w[0..7] << S (w[8] is 0); shift it back
  shift_down<4>(w, ws & 4);
  shift_down<2>(w, ws & 2);
  shift_down<1>(w, ws & 1);
#pragma unroll
  for (int d = 0; d < kWords; ++d) r[d] = __funnelshift_r(w[d], w[d + 1], s);
}

// DIV, MOD, SDIV, SMOD: the group gathers both words into every lane,
// every lane divides, and lane k keeps word k of the result
__device__ uint32_t divide_w(const Group& g, int op, uint32_t a,
                             uint32_t b) {
  uint32_t x[kWords], y[kWords], q[kWords], r[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    x[i] = word_of(g, a, i);
    y[i] = word_of(g, b, i);
  }
  const bool is_signed = op == bSdiv || op == bSmod;
  const bool neg_a = is_signed && (x[kWords - 1] >> 31) != 0u;
  const bool neg_b = is_signed && (y[kWords - 1] >> 31) != 0u;
  if (neg_a) negate_digits(x);
  if (neg_b) negate_digits(y);
  divmod_digits(x, y, q, r);
  const bool quotient = op == bDiv || op == bSdiv;
  const bool negate = op == bSdiv ? neg_a != neg_b : op == bSmod && neg_a;
#pragma unroll
  for (int i = 0; i < kWords; ++i) x[i] = quotient ? q[i] : r[i];
  if (negate) negate_digits(x);
  uint32_t mine = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) mine = i == g.k ? x[i] : mine;
  return mine;
}

__device__ uint32_t binary_w(const Group& g, int op, uint32_t a,
                             uint32_t b) {
  switch (op) {
    case bAdd: return add_w(g, a, b);
    case bSub: return sub_w(g, a, b);
    case bMul: return mul_w(g, a, b);
    case bDiv:
    case bMod:
    case bSdiv:
    case bSmod: return divide_w(g, op, a, b);
    case bAnd: return a & b;
    case bOr: return a | b;
    case bXor: return a ^ b;
    case bLt: return small_word(g, ult_w(g, a, b) ? 1u : 0u);
    case bGt: return small_word(g, ult_w(g, b, a) ? 1u : 0u);
    case bSlt: return small_word(g, slt_w(g, a, b) ? 1u : 0u);
    case bSgt: return small_word(g, slt_w(g, b, a) ? 1u : 0u);
    default: return small_word(g, bits(g, a != b) == 0u ? 1u : 0u);  // bEq
  }
}

// memory offset word -> small offset, or out of bounds (clamped to 0)
__device__ __forceinline__ int mem_offset_w(const Group& g, uint32_t a,
                                            int size, int window,
                                            bool& oob) {
  uint32_t low = word_of(g, a, 0);
  bool high = bits(g, g.k == 0 ? (a >> 24) != 0u : a != 0u) != 0u;
  int small = (int)(low & 0xFFFFFFu);
  oob = high || small + size > window;
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

// 4 big-endian byte limbs <-> a word
__device__ __forceinline__ uint32_t from_limbs(int4 x) {
  return ((uint32_t)(x.x & 0xFF) << 24) | ((uint32_t)(x.y & 0xFF) << 16)
         | ((uint32_t)(x.z & 0xFF) << 8) | (uint32_t)(x.w & 0xFF);
}

__device__ __forceinline__ int4 to_limbs(uint32_t w) {
  return make_int4((int)(w >> 24), (int)((w >> 16) & 0xFFu),
                   (int)((w >> 8) & 0xFFu), (int)(w & 0xFFu));
}

// the constant pool entry an op pushes (entry 0, which always exists, for
// an op that pushes none)
__device__ __forceinline__ int const_index(int4 op) {
  return op.x == kPush || op.x == kPc ? op.y : 0;
}

__global__ void __launch_bounds__(kMaxBlockRows * kGroup)
frontier_step_kernel(const Frame f) {
  extern __shared__ uint32_t stack_words[];
  const int lane = threadIdx.x & 31;
  const int in_warp = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  Group g;
  g.mask = in_warp == 32 ? 0xFFFFFFFFu : ((1u << in_warp) - 1u);
  g.base = lane & ~(kGroup - 1);
  g.k = lane & (kGroup - 1);
  const int place = threadIdx.x / kGroup;  // the row's place in the block
  const int row_index = blockIdx.x * (blockDim.x / kGroup) + place;
  // a place past the last row runs the program on the last row's inputs,
  // so the warp stays converged, and writes nothing
  const bool valid = row_index < f.rows;
  const size_t row = valid ? row_index : f.rows - 1;
  // this lane's word of slot j is stack[j * kWords]
  uint32_t* stack = stack_words + (size_t)place * f.pitch * kWords + g.k;
  // this lane's 4 limbs of a frame word
  const int limb = kLimbs - 4 * (g.k + 1);

  for (int j = 0; j < f.touch; ++j) {
    stack[j * kWords] = from_limbs(__ldg(reinterpret_cast<const int4*>(
        f.stack_in + (row * f.touch + j) * kLimbs + limb)));
  }
  int sp = f.touch;
  int msize = f.msize_in[row];
  int min_gas = f.min_gas_in[row];
  int max_gas = f.max_gas_in[row];
  const int gas_limit = f.gas_limit[row];
  bool ok = f.live[row] != 0;
  int* mem = f.mem + row * f.window;
  uint8_t* written = f.written + row * f.window;
  int log_index = 0, fork_index = 0;
  // each op (kind, arg, gas_min, gas_max) and its constant word are
  // loaded one op ahead, so their latency hides behind the op before
  const int4* ops = reinterpret_cast<const int4*>(f.ops);
  const int last = f.n_ops > 0 ? f.n_ops - 1 : 0;
  int4 op = f.n_ops > 0 ? __ldg(ops) : make_int4(kNop, 0, 0, 0);
  uint32_t word = __ldg(f.consts + const_index(op) * kWords + g.k);
  for (int pc = 0; pc < f.n_ops; ++pc) {
    const int4 next = __ldg(ops + min(pc + 1, last));
    const uint32_t next_word =
        __ldg(f.consts + const_index(next) * kWords + g.k);
    uint32_t* top = stack + (sp - 1) * kWords;
    switch (op.x) {
      case kPush:
      case kPc:
        top[kWords] = word;
        ++sp;
        break;
      case kDup:
        top[kWords] = top[(1 - op.y) * kWords];
        ++sp;
        break;
      case kSwap: {
        uint32_t t = top[0];
        top[0] = top[-op.y * kWords];
        top[-op.y * kWords] = t;
        break;
      }
      case kPop:
        --sp;
        break;
      case kBin:
        top[-kWords] = binary_w(g, op.y, top[0], top[-kWords]);
        --sp;
        break;
      case kNot:
        top[0] = ~top[0];
        break;
      case kIszero:
        top[0] = small_word(g, is_zero_w(g, top[0]) ? 1u : 0u);
        break;
      case kByte:
        top[-kWords] = byte_w(g, top[0], top[-kWords]);
        --sp;
        break;
      case kShl:
        top[-kWords] = shl_w(g, top[0], top[-kWords]);
        --sp;
        break;
      case kShr:
        top[-kWords] = shr_w(g, top[0], top[-kWords]);
        --sp;
        break;
      case kSar:
        top[-kWords] = sar_w(g, top[0], top[-kWords]);
        --sp;
        break;
      case kSignextend:
        top[-kWords] = signextend_w(g, top[0], top[-kWords]);
        --sp;
        break;
      case kMload: {
        bool oob;
        int off = mem_offset_w(g, top[0], 32, f.window, oob);
        ok = ok && !oob;
        mem_extend(off, 32, msize, min_gas, max_gas, gas_limit, ok);
        const int* p = mem + off + limb;
        top[0] = from_limbs(make_int4(p[0], p[1], p[2], p[3]));
        break;
      }
      case kMstore:
      case kMstore8: {
        const int size = op.x == kMstore ? 32 : 1;
        bool oob;
        int off = mem_offset_w(g, top[0], size, f.window, oob);
        const int4 value = to_limbs(top[-kWords]);
        sp -= 2;
        ok = ok && !oob;
        mem_extend(off, size, msize, min_gas, max_gas, gas_limit, ok);
        if (valid) {
          const size_t entry = row * f.n_log + log_index;
          *reinterpret_cast<int4*>(f.log_val + entry * kLimbs + limb) = value;
          if (g.k == 0) f.log_off[entry] = off;
          if (ok && size == 32) {
            int* p = mem + off + limb;
            p[0] = value.x;
            p[1] = value.y;
            p[2] = value.z;
            p[3] = value.w;
            uint8_t* w = written + off + limb;
            w[0] = w[1] = w[2] = w[3] = 1;
          } else if (ok && g.k == 0) {
            mem[off] = value.w;
            written[off] = 1;
          }
        }
        ++log_index;
        __syncwarp(g.mask);  // the group's later MLOADs see these bytes
        break;
      }
      case kJumpi:
      case kReturn:
        // destination then condition, or offset then length
        for (int k = 0; k < 2; ++k) {
          if (valid) {
            *reinterpret_cast<int4*>(
                f.fork_out + (row * f.n_fork + fork_index) * kLimbs + limb) =
                to_limbs(stack[(sp - 1) * kWords]);
          }
          --sp;
          ++fork_index;
        }
        break;
      case kCalldataload:  // the lane's placeholder: decode builds the term
        top[0] = 0u;
        break;
      case kMsize:
        top[kWords] = small_word(g, (uint32_t)msize);
        ++sp;
        break;
      default:  // kStop, kNop
        break;
    }
    min_gas = add32(min_gas, op.z);
    max_gas = add32(max_gas, op.w);
    ok = ok && min_gas <= gas_limit;
    op = next;
    word = next_word;
  }
  if (!valid) return;
  for (int j = 0; j < f.out_len; ++j) {
    *reinterpret_cast<int4*>(
        f.stack_out + (row * f.out_len + j) * kLimbs + limb) =
        to_limbs(stack[j * kWords]);
  }
  if (g.k == 0) {
    f.msize_out[row] = msize;
    f.min_gas_out[row] = min_gas;
    f.max_gas_out[row] = max_gas;
    f.ok_out[row] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int frontier_step_args_size() { return (int)sizeof(StepArgs); }

// One step on `stream`: `step` is a StepArgs (taken as void*, for a type
// of this file's unnamed namespace would leave the function unexported).
// The upload, the launch and the download are each issued only when they
// have bytes or rows. With a download it synchronises the stream, so a
// fault of the run is reported here. Returns a cudaError_t (0: done).
// Allocates nothing.
int frontier_step(const void* step, void* stream_ptr) {
  const StepArgs* args = static_cast<const StepArgs*>(step);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Frame& f = args->frame;
  if (f.block_rows < 1 || f.block_rows > kMaxBlockRows || f.pitch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t status = cudaSuccess;
  if (args->upload_bytes > 0) {
    status = cudaMemcpyAsync(args->upload_dst, args->upload_src,
                             (size_t)args->upload_bytes,
                             cudaMemcpyHostToDevice, stream);
    if (status != cudaSuccess) return (int)status;
  }
  if (f.rows > 0) {
    const int groups = f.rows < f.block_rows ? f.rows : f.block_rows;
    const size_t smem = (size_t)groups * f.pitch * kWords * sizeof(uint32_t);
    if (smem > kDefaultSmem) {
      status = cudaFuncSetAttribute(
          frontier_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (status != cudaSuccess) return (int)status;
    }
    const int blocks = (f.rows + groups - 1) / groups;
    frontier_step_kernel<<<blocks, groups * kGroup, smem, stream>>>(f);
    status = cudaGetLastError();
    if (status != cudaSuccess) return (int)status;
  }
  if (args->download_bytes > 0) {
    status = cudaMemcpyAsync(args->download_dst, args->download_src,
                             (size_t)args->download_bytes,
                             cudaMemcpyDeviceToHost, stream);
    if (status != cudaSuccess) return (int)status;
    status = cudaStreamSynchronize(stream);
  }
  return (int)status;
}

const char* frontier_step_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
