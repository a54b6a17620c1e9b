"""Batched 256-bit machine words as big-endian uint8 limb arrays.

The dense frontier representation keeps every EVM word as 32 limbs of one
byte each (big-endian, limb 0 = most significant), stored in int32 arrays
whose LAST axis is the limb axis — leading axes are free, so the same op
code runs on one word (shape ``(32,)``) and on a batch (shape
``(N, 32)``). Byte limbs were chosen over wider packings deliberately:

  - they match EVM memory bytes exactly, so MLOAD/MSTORE are pure
    gathers/scatters with no repacking at the memory seam;
  - partial products in MUL fit comfortably in int32 (32 * 255^2 < 2^21),
    so no backend needs 64-bit intermediates;
  - carry/borrow propagation is a statically-unrolled 32-step pass.

Every function takes the array namespace `xp` explicitly: numpy (the host
step) or `torch_namespace(device)`, the slice of numpy's namespace these
functions use, on torch tensors of one device (the plain version of the
frontier step, laser/frontier/kernel.py). All ops are exact bit-level
implementations of the corresponding EVM semantics — the differential
property tests in tests/test_torch_frontier.py hold them to the per-state
interpreter bit for bit, and tests/test_torch_frontier_parity.py to the
JAX package's words on numpy and jax.numpy.
"""

LIMBS = 32
WORD_BITS = 256


# -- host-side packing (python int <-> limb vectors) -------------------------


def word_from_int(value: int):
    """256-bit python int -> list of 32 big-endian byte limbs."""
    return list(value.to_bytes(32, "big"))


def int_from_limbs(limbs) -> int:
    """Limb vector (any int array-like of length 32) -> python int."""
    return int.from_bytes(bytes(int(v) & 0xFF for v in limbs), "big")


# -- the torch namespace -----------------------------------------------------


class _TorchNamespace:
    """numpy's names as this module and kernel._exec call them, on torch
    tensors: axis= becomes dim=, take_along_axis takes int64 indices, and
    every new array is made on the namespace's device."""

    __name__ = "torch"

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = device
        self.int32 = torch.int32
        self.int64 = torch.int64
        self._dtypes = {bool: torch.bool, int: torch.int64}

    def stack(self, arrays, axis=0):
        return self._torch.stack(list(arrays), dim=axis)

    def concatenate(self, arrays, axis=0):
        return self._torch.cat(list(arrays), dim=axis)

    def zeros(self, shape, dtype):
        return self._torch.zeros(tuple(shape),
                                 dtype=self._dtypes.get(dtype, dtype),
                                 device=self.device)

    def zeros_like(self, a):
        return self._torch.zeros_like(a)

    def arange(self, *bounds):
        return self._torch.arange(*bounds, device=self.device)

    def where(self, cond, a, b):
        return self._torch.where(cond, a, b)

    def all(self, a, axis):
        return self._torch.all(a, dim=axis)

    def any(self, a, axis):
        return self._torch.any(a, dim=axis)

    def sum(self, a, axis):
        return self._torch.sum(a, dim=axis)

    def clip(self, a, low, high):
        return self._torch.clamp(a, low, high)

    def take_along_axis(self, a, indices, axis):
        return self._torch.take_along_dim(a, indices.long(), dim=axis)


_NAMESPACES = {}


def torch_namespace(device):
    """The torch namespace bound to `device` (one per device)."""
    key = str(device)
    namespace = _NAMESPACES.get(key)
    if namespace is None:
        namespace = _NAMESPACES[key] = _TorchNamespace(device)
    return namespace


def _cast(xp, a, dtype):
    """a.astype(dtype); torch tensors have .to instead."""
    if xp.__name__ == "numpy":
        return a.astype(dtype)
    return a.to(dtype)


# -- canonicalization --------------------------------------------------------


def _carry_canon(xp, cols):
    """Propagate carries LSB->MSB over raw column sums (each column may
    hold any value < 2^31 / 32); the final carry out of limb 0 is dropped
    (mod 2^256)."""
    cols = list(cols)
    for i in range(LIMBS - 1, 0, -1):
        carry = cols[i] >> 8
        cols[i] = cols[i] & 0xFF
        cols[i - 1] = cols[i - 1] + carry
    cols[0] = cols[0] & 0xFF
    return xp.stack(cols, axis=-1)


# -- arithmetic --------------------------------------------------------------


def add(xp, a, b):
    return _carry_canon(xp, [a[..., i] + b[..., i] for i in range(LIMBS)])


def sub(xp, a, b):
    # one borrow-propagation implementation: the division step needs
    # the final borrow exposed (_sub_borrow), SUB just drops it
    return _sub_borrow(xp, a, b)[0]


def mul(xp, a, b):
    """Truncated 256-bit product. Column k (byte weight 31-k) collects the
    partial products with i + j = 31 + k."""
    zero = a[..., 0] * 0
    cols = [zero] * LIMBS
    for i in range(LIMBS):
        ai = a[..., i]
        for j in range(LIMBS - 1 - i, LIMBS):
            k = i + j - (LIMBS - 1)
            cols[k] = cols[k] + ai * b[..., j]
    return _carry_canon(xp, cols)


# -- division (bit-serial restoring long division) ---------------------------


def _sub_borrow(xp, a, b):
    """a - b with the final borrow exposed: (difference mod 2^256,
    borrow-out mask). The borrow-out IS the unsigned a < b verdict, so
    the division step gets its compare and its conditional subtract from
    ONE limb pass."""
    cols = [a[..., i] - b[..., i] for i in range(LIMBS)]
    for i in range(LIMBS - 1, 0, -1):
        borrow = _cast(xp, cols[i] < 0, a.dtype)
        cols[i] = cols[i] + (borrow << 8)
        cols[i - 1] = cols[i - 1] - borrow
    underflow = cols[0] < 0
    cols[0] = cols[0] & 0xFF
    return xp.stack(cols, axis=-1), underflow


def _shift_in_bit(xp, rem, bit):
    """rem * 2 + bit across big-endian byte limbs (one vectorized pass:
    per-limb double is even and <= 254, so adding the carry bit — or the
    incoming dividend bit at the LSB — cannot overflow a byte)."""
    doubled = rem * 2
    kept = doubled & 0xFF
    carry = doubled >> 8
    shifted = kept + xp.concatenate(
        [carry[..., 1:], xp.zeros_like(carry[..., :1])], axis=-1)
    lsb = shifted[..., 31:] + bit[..., None]
    return xp.concatenate([shifted[..., :31], lsb], axis=-1)


def _divmod_host(xp, a, b):
    """Numpy (eager, concrete) divmod: the limbs ARE concrete bytes, so
    per-row python bignum divmod is exact and far cheaper than the
    bit-serial array loop."""
    import numpy as np

    flat_a = np.asarray(a, dtype=np.int64).reshape(-1, LIMBS)
    flat_b = np.asarray(b, dtype=np.int64).reshape(-1, LIMBS)
    quotient = np.zeros_like(flat_a, dtype=np.int32)
    remainder = np.zeros_like(flat_a, dtype=np.int32)
    for i in range(flat_a.shape[0]):
        divisor = int_from_limbs(flat_b[i])
        if divisor == 0:
            continue
        q, r = divmod(int_from_limbs(flat_a[i]), divisor)
        quotient[i] = np.frombuffer(q.to_bytes(32, "big"), dtype=np.uint8)
        remainder[i] = np.frombuffer(r.to_bytes(32, "big"), dtype=np.uint8)
    shape = np.shape(a)
    return quotient.reshape(shape), remainder.reshape(shape)


_CHUNK_MASK = (1 << 32) - 1


def _to_chunks(xp, a):
    """(..., 32) byte limbs -> (..., 8) 32-bit chunks in int64, most
    significant first."""
    grouped = _cast(xp, a, xp.int64).reshape(a.shape[:-1] + (8, 4))
    weights = 1 << (8 * (3 - xp.arange(4)))
    return xp.sum(grouped * weights, axis=-1)


def _from_chunks(xp, chunks):
    shifts = 8 * (3 - xp.arange(4))
    limbs = (chunks[..., :, None] >> shifts) & 0xFF
    return _cast(xp, limbs.reshape(chunks.shape[:-1] + (LIMBS,)), xp.int32)


def _divmod_bitserial(xp, a, b):
    """256 bit-serial restoring-division steps as a Python loop over the
    batch: the plain version of K7 (the CUDA step divides inside its
    kernel, csrc/frontier_step.cu). Each step shifts the next dividend
    bit into the remainder and subtracts the divisor where the borrow
    says it fits; the quotient bit is that verdict. The remainder is held
    as eight 32-bit chunks in int64 (one borrow pass of 7 steps instead
    of 31 over byte limbs); it never passes 2^256, since before each
    shift it is at most the dividend's bits above the next one."""
    abits = to_bits(xp, a)
    divisor = _to_chunks(xp, b)
    rem = xp.zeros_like(divisor)
    qbits = []
    for i in range(WORD_BITS):
        doubled = rem * 2
        rem = (doubled & _CHUNK_MASK) + xp.concatenate(
            [doubled[..., 1:] >> 32, abits[..., i:i + 1]], axis=-1)
        cols = [rem[..., k] - divisor[..., k] for k in range(8)]
        for k in range(7, 0, -1):
            borrow = _cast(xp, cols[k] < 0, rem.dtype)
            cols[k] = cols[k] + (borrow << 32)
            cols[k - 1] = cols[k - 1] - borrow
        under = cols[0] < 0
        rem = xp.where(under[..., None], rem, xp.stack(cols, axis=-1))
        qbits.append(_cast(xp, ~under, a.dtype))
    return from_bits(xp, xp.stack(qbits, axis=-1)), _from_chunks(xp, rem)


def divmod_unsigned(xp, a, b):
    """EVM unsigned (a // b, a % b); division by zero yields (0, 0), as
    DIV/MOD specify. numpy takes the host bignum path, torch the
    bit-serial loop; both are held to the per-state interpreter."""
    if xp.__name__ == "numpy":
        quotient, remainder = _divmod_host(xp, a, b)
    else:
        quotient, remainder = _divmod_bitserial(xp, a, b)
    by_zero = is_zero_mask(xp, b)[..., None]
    quotient = xp.where(by_zero, 0, quotient)
    remainder = xp.where(by_zero, 0, remainder)
    return quotient, remainder


def _negate(xp, a):
    """Two's-complement negation (0 - a mod 2^256)."""
    return sub(xp, xp.zeros_like(a), a)


def _sign_mask(xp, a):
    return a[..., 0] >= 128


def _abs_word(xp, a):
    return xp.where(_sign_mask(xp, a)[..., None], _negate(xp, a), a)


def div(xp, a, b):
    return divmod_unsigned(xp, a, b)[0]


def mod(xp, a, b):
    return divmod_unsigned(xp, a, b)[1]


def sdiv(xp, a, b):
    """EVM SDIV: truncated signed division on two's-complement words.
    abs-divide then negate when the signs differ; the -2^255 / -1
    overflow case falls out correctly (abs(-2^255) = 2^255 unsigned,
    and negating 2^255 is the identity)."""
    quotient, _ = divmod_unsigned(xp, _abs_word(xp, a), _abs_word(xp, b))
    negate = _sign_mask(xp, a) ^ _sign_mask(xp, b)
    return xp.where(negate[..., None], _negate(xp, quotient), quotient)


def smod(xp, a, b):
    """EVM SMOD: remainder takes the DIVIDEND's sign (truncated
    division), |b| = 0 yields 0."""
    _, remainder = divmod_unsigned(xp, _abs_word(xp, a), _abs_word(xp, b))
    return xp.where(_sign_mask(xp, a)[..., None],
                    _negate(xp, remainder), remainder)


# -- comparisons (return bool masks over the leading axes) -------------------


def eq_mask(xp, a, b):
    return xp.all(a == b, axis=-1)


def is_zero_mask(xp, a):
    return xp.all(a == 0, axis=-1)


def ult_mask(xp, a, b):
    """Unsigned a < b: lexicographic from the most significant limb."""
    result = xp.zeros(a.shape[:-1], dtype=bool)
    decided = xp.zeros(a.shape[:-1], dtype=bool)
    for i in range(LIMBS):
        ai, bi = a[..., i], b[..., i]
        result = xp.where(~decided & (ai < bi), True, result)
        decided = decided | (ai != bi)
    return result


def _flip_sign(xp, a):
    """XOR the sign bit so signed compare = unsigned compare of images."""
    return xp.concatenate([a[..., :1] ^ 0x80, a[..., 1:]], axis=-1)


def slt_mask(xp, a, b):
    return ult_mask(xp, _flip_sign(xp, a), _flip_sign(xp, b))


def mask_to_word(xp, mask):
    """bool mask -> EVM boolean word (0 or 1)."""
    shape = mask.shape + (LIMBS - 1,)
    return xp.concatenate(
        [xp.zeros(shape, dtype=xp.int32),
         _cast(xp, mask, xp.int32)[..., None]], axis=-1)


# -- bitwise -----------------------------------------------------------------


def bit_and(xp, a, b):
    return a & b


def bit_or(xp, a, b):
    return a | b


def bit_xor(xp, a, b):
    return a ^ b


def bit_not(xp, a):
    return 255 - a


def byte_op(xp, index_word, value):
    """EVM BYTE: byte `i` of `value` (0 = most significant), 0 for i >= 32.
    With big-endian byte limbs this is a single limb gather."""
    high = xp.any(index_word[..., :31] != 0, axis=-1)
    small = index_word[..., 31]
    oob = high | (small >= LIMBS)
    idx = xp.where(oob, 0, small)
    picked = xp.take_along_axis(value, idx[..., None], axis=-1)[..., 0]
    picked = xp.where(oob, 0, picked)
    shape = picked.shape + (LIMBS - 1,)
    return xp.concatenate(
        [xp.zeros(shape, dtype=xp.int32), picked[..., None]], axis=-1)


# -- shifts ------------------------------------------------------------------


def to_bits(xp, a):
    """(..., 32) byte limbs -> (..., 256) bits, MSB first."""
    shifts = xp.arange(7, -1, -1)
    bits = (a[..., :, None] >> shifts) & 1
    return bits.reshape(a.shape[:-1] + (WORD_BITS,))


def from_bits(xp, bits):
    grouped = bits.reshape(bits.shape[:-1] + (LIMBS, 8))
    weights = 1 << xp.arange(7, -1, -1)
    return _cast(xp, xp.sum(grouped * weights, axis=-1), xp.int32)


def shift_amount(xp, w):
    """Shift-word -> (amount clamped into [0, 255], oob mask for >=256)."""
    high = xp.any(w[..., :30] != 0, axis=-1)
    small = w[..., 30] * 256 + w[..., 31]
    oob = high | (small >= WORD_BITS)
    return xp.where(oob, 0, small), oob


def shl(xp, shift_word, value):
    amount, oob = shift_amount(xp, shift_word)
    bits = to_bits(xp, value)
    idx = xp.arange(WORD_BITS) + amount[..., None]
    src = xp.take_along_axis(bits, xp.clip(idx, 0, WORD_BITS - 1), axis=-1)
    out = xp.where((idx < WORD_BITS) & ~oob[..., None], src, 0)
    return from_bits(xp, out)


def shr(xp, shift_word, value):
    amount, oob = shift_amount(xp, shift_word)
    bits = to_bits(xp, value)
    idx = xp.arange(WORD_BITS) - amount[..., None]
    src = xp.take_along_axis(bits, xp.clip(idx, 0, WORD_BITS - 1), axis=-1)
    out = xp.where((idx >= 0) & ~oob[..., None], src, 0)
    return from_bits(xp, out)


def sar(xp, shift_word, value):
    amount, oob = shift_amount(xp, shift_word)
    bits = to_bits(xp, value)
    sign = bits[..., :1]
    idx = xp.arange(WORD_BITS) - amount[..., None]
    src = xp.take_along_axis(bits, xp.clip(idx, 0, WORD_BITS - 1), axis=-1)
    out = xp.where((idx >= 0) & ~oob[..., None], src, sign)
    return from_bits(xp, out)


# -- SIGNEXTEND --------------------------------------------------------------


def signextend(xp, pos_word, value):
    """EVM SIGNEXTEND: sign byte sits at byte index 31 - pos (big-endian
    limbs); every more significant limb becomes the sign fill. pos >= 31
    is the identity."""
    high = xp.any(pos_word[..., :30] != 0, axis=-1)
    small = pos_word[..., 30] * 256 + pos_word[..., 31]
    identity = high | (small >= 31)
    sign_idx = xp.clip(31 - small, 0, 31)
    sign_byte = xp.take_along_axis(value, sign_idx[..., None], axis=-1)[..., 0]
    fill = ((sign_byte >> 7) & 1) * 255
    keep = xp.arange(LIMBS) >= sign_idx[..., None]
    return xp.where(keep | identity[..., None], value, fill[..., None])


# -- memory offsets / small-int conversions ----------------------------------


def mem_offset(xp, w, size, window):
    """Offset word -> (small offset, oob mask). oob marks states whose
    access [off, off+size) does not fit the dense window — they exit the
    batch and replay on the per-state interpreter (which handles huge
    concrete offsets via gas exhaustion)."""
    high = xp.any(w[..., :29] != 0, axis=-1)
    small = w[..., 29] * 65536 + w[..., 30] * 256 + w[..., 31]
    oob = high | (small + size > window)
    return xp.where(oob, 0, small), oob


def small_to_word(xp, value):
    """Non-negative int32 scalar array (< 2^31) -> word."""
    cols = [value * 0] * (LIMBS - 4)
    cols.append((value >> 24) & 0xFF)
    cols.append((value >> 16) & 0xFF)
    cols.append((value >> 8) & 0xFF)
    cols.append(value & 0xFF)
    return xp.stack(cols, axis=-1)
