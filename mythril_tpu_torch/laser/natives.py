"""Precompiled contracts 0x01-0x0a (reference laser/ethereum/natives.py:279).

This environment has no coincurve/py_ecc/blake2b native deps, so everything
is implemented here: secp256k1 recovery (pure Python), SHA-256 (hashlib),
RIPEMD-160 (pure Python), modexp (pow), alt_bn128 group ops, BLAKE2b F.
Symbolic inputs raise NativeContractException -> the caller falls back to a
fresh symbolic return buffer."""

import hashlib
from typing import Callable, List

from mythril_tpu_torch.utils.keccak import keccak256


class NativeContractException(Exception):
    pass


def _concrete_bytes(data) -> bytes:
    """data: list of BitVec(8)/ints -> bytes; raises on symbolic bytes."""
    out = bytearray()
    for byte in data:
        if isinstance(byte, int):
            out.append(byte & 0xFF)
            continue
        if byte.symbolic:
            raise NativeContractException("symbolic input to precompile")
        out.append(byte.concrete_value & 0xFF)
    return bytes(out)


# -- secp256k1 ecrecover -----------------------------------------------------

_P = 2 ** 256 - 2 ** 32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv_mod(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % _P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _inv_mod(2 * y1, _P) % _P
    else:
        lam = (y2 - y1) * _inv_mod((x2 - x1) % _P, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    y3 = (lam * (x1 - x3) - y1) % _P
    return (x3, y3)


def _ec_mul(point, scalar: int):
    result = None
    addend = point
    while scalar:
        if scalar & 1:
            result = _ec_add(result, addend)
        addend = _ec_add(addend, addend)
        scalar >>= 1
    return result


def ecrecover_raw(msg_hash: bytes, v: int, r: int, s: int) -> bytes:
    """Returns the 20-byte address or b'' on failure."""
    if v not in (27, 28) or not (1 <= r < _N) or not (1 <= s < _N):
        return b""
    x = r
    alpha = (pow(x, 3, _P) + 7) % _P
    beta = pow(alpha, (_P + 1) // 4, _P)
    y = beta if (beta % 2 == 0) == (v == 27) else _P - beta
    if pow(y, 2, _P) != alpha:
        return b""
    e = int.from_bytes(msg_hash, "big")
    point = _ec_add(
        _ec_mul((x, y), s),
        _ec_mul((_GX, _GY), (-e) % _N),
    )
    if point is None:
        return b""
    recovered = _ec_mul(point, _inv_mod(x, _N))
    if recovered is None:
        return b""
    rx, ry = recovered
    pub = rx.to_bytes(32, "big") + ry.to_bytes(32, "big")
    return keccak256(pub)[12:]


def ecrecover(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    raw = raw + b"\x00" * (128 - len(raw)) if len(raw) < 128 else raw[:128]
    msg_hash = raw[0:32]
    v = int.from_bytes(raw[32:64], "big")
    r = int.from_bytes(raw[64:96], "big")
    s = int.from_bytes(raw[96:128], "big")
    try:
        address = ecrecover_raw(msg_hash, v, r, s)
    except Exception:
        return []
    if not address:
        return []
    return list(b"\x00" * 12 + address)


# -- sha256 / ripemd160 / identity ------------------------------------------


def sha256_native(data: List) -> List[int]:
    return list(hashlib.sha256(_concrete_bytes(data)).digest())


def _ripemd160_py(message: bytes) -> bytes:
    # Pure-Python RIPEMD-160 (public domain algorithm constants).
    def rol(value, amount):
        return ((value << amount) | (value >> (32 - amount))) & 0xFFFFFFFF

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    r1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
    r2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
    s1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
          7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
          11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
          11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
          9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
    s2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
          9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
          9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
          15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
          8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]

    def f(j, x, y, z):
        if j < 16:
            return x ^ y ^ z
        if j < 32:
            return (x & y) | (~x & z)
        if j < 48:
            return (x | ~y) ^ z
        if j < 64:
            return (x & z) | (y & ~z)
        return x ^ (y | ~z)

    def k1(j):
        return [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E][j // 16]

    def k2(j):
        return [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000][j // 16]

    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded) % 64) % 64)
    padded += (len(message) * 8).to_bytes(8, "little")
    for block_start in range(0, len(padded), 64):
        block = padded[block_start:block_start + 64]
        x = [int.from_bytes(block[4 * i:4 * i + 4], "little") for i in range(16)]
        a1, b1, c1, d1, e1 = h
        a2, b2, c2, d2, e2 = h
        for j in range(80):
            t = (rol((a1 + f(j, b1, c1, d1) + x[r1[j]] + k1(j)) & 0xFFFFFFFF,
                     s1[j]) + e1) & 0xFFFFFFFF
            a1, e1, d1, c1, b1 = e1, d1, rol(c1, 10), b1, t
            t = (rol((a2 + f(79 - j, b2, c2, d2) + x[r2[j]] + k2(j)) & 0xFFFFFFFF,
                     s2[j]) + e2) & 0xFFFFFFFF
            a2, e2, d2, c2, b2 = e2, d2, rol(c2, 10), b2, t
        t = (h[1] + c1 + d2) & 0xFFFFFFFF
        h = [t,
             (h[2] + d1 + e2) & 0xFFFFFFFF,
             (h[3] + e1 + a2) & 0xFFFFFFFF,
             (h[4] + a1 + b2) & 0xFFFFFFFF,
             (h[0] + b1 + c2) & 0xFFFFFFFF]
    return b"".join(v.to_bytes(4, "little") for v in h)


def ripemd160(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    try:
        digest = hashlib.new("ripemd160", raw).digest()
    except Exception:
        digest = _ripemd160_py(raw)
    return list(b"\x00" * 12 + digest)


def identity(data: List) -> List:
    return list(data)


# -- modexp ------------------------------------------------------------------


def native_modexp(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    raw = raw + b"\x00" * max(0, 96 - len(raw))
    base_len = int.from_bytes(raw[0:32], "big")
    exp_len = int.from_bytes(raw[32:64], "big")
    mod_len = int.from_bytes(raw[64:96], "big")
    if base_len + exp_len + mod_len > 4096:
        raise NativeContractException("modexp input too large")
    body = raw[96:] + b"\x00" * (base_len + exp_len + mod_len)
    base = int.from_bytes(body[0:base_len], "big")
    exponent = int.from_bytes(body[base_len:base_len + exp_len], "big")
    modulus = int.from_bytes(
        body[base_len + exp_len:base_len + exp_len + mod_len], "big"
    )
    if modulus == 0:
        return list(b"\x00" * mod_len)
    result = pow(base, exponent, modulus)
    return list(result.to_bytes(mod_len, "big"))


# -- alt_bn128 ---------------------------------------------------------------

_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583


def _bn_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % _BN_P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * pow(2 * y1, _BN_P - 2, _BN_P) % _BN_P
    else:
        lam = (y2 - y1) * pow((x2 - x1) % _BN_P, _BN_P - 2, _BN_P) % _BN_P
    x3 = (lam * lam - x1 - x2) % _BN_P
    y3 = (lam * (x1 - x3) - y1) % _BN_P
    return (x3, y3)


def _bn_point(x: int, y: int):
    if x == 0 and y == 0:
        return None
    if (y * y - x * x * x - 3) % _BN_P != 0:
        raise NativeContractException("point not on alt_bn128")
    return (x, y)


def ec_add(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    raw = raw + b"\x00" * max(0, 128 - len(raw))
    x1, y1, x2, y2 = (int.from_bytes(raw[i:i + 32], "big") for i in range(0, 128, 32))
    result = _bn_add(_bn_point(x1, y1), _bn_point(x2, y2))
    if result is None:
        return list(b"\x00" * 64)
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_mul(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    raw = raw + b"\x00" * max(0, 96 - len(raw))
    x, y, scalar = (int.from_bytes(raw[i:i + 32], "big") for i in range(0, 96, 32))
    point = _bn_point(x, y)
    result = None
    addend = point
    while scalar:
        if scalar & 1:
            result = _bn_add(result, addend)
        addend = _bn_add(addend, addend)
        scalar >>= 1
    if result is None:
        return list(b"\x00" * 64)
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_pairing(data: List) -> List[int]:
    # full pairing check not implemented; treat as unknowable
    raise NativeContractException("alt_bn128 pairing unsupported")


# -- blake2b F ---------------------------------------------------------------

_BLAKE2_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_BLAKE2_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_M64 = (1 << 64) - 1


def _blake2_g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M64
    v[d] = _ror64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & _M64
    v[d] = _ror64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M64
    v[b] = _ror64(v[b] ^ v[c], 63)


def _ror64(value, amount):
    return ((value >> amount) | (value << (64 - amount))) & _M64


def blake2b_fcompress(data: List) -> List[int]:
    raw = _concrete_bytes(data)
    if len(raw) != 213:
        raise NativeContractException("blake2f input must be 213 bytes")
    rounds = int.from_bytes(raw[0:4], "big")
    h = [int.from_bytes(raw[4 + 8 * i:12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(raw[68 + 8 * i:76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(raw[196:204], "little")
    t1 = int.from_bytes(raw[204:212], "little")
    final = raw[212]
    if final not in (0, 1):
        raise NativeContractException("invalid blake2f final flag")
    v = h[:] + _BLAKE2_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64
    for round_index in range(rounds):
        sigma = _BLAKE2_SIGMA[round_index % 10]
        _blake2_g(v, 0, 4, 8, 12, m[sigma[0]], m[sigma[1]])
        _blake2_g(v, 1, 5, 9, 13, m[sigma[2]], m[sigma[3]])
        _blake2_g(v, 2, 6, 10, 14, m[sigma[4]], m[sigma[5]])
        _blake2_g(v, 3, 7, 11, 15, m[sigma[6]], m[sigma[7]])
        _blake2_g(v, 0, 5, 10, 15, m[sigma[8]], m[sigma[9]])
        _blake2_g(v, 1, 6, 11, 12, m[sigma[10]], m[sigma[11]])
        _blake2_g(v, 2, 7, 8, 13, m[sigma[12]], m[sigma[13]])
        _blake2_g(v, 3, 4, 9, 14, m[sigma[14]], m[sigma[15]])
    out = bytearray()
    for i in range(8):
        out += (h[i] ^ v[i] ^ v[i + 8]).to_bytes(8, "little")
    return list(out)


PRECOMPILE_FUNCTIONS: List[Callable] = [
    ecrecover,
    sha256_native,
    ripemd160,
    identity,
    native_modexp,
    ec_add,
    ec_mul,
    ec_pairing,
    blake2b_fcompress,
]
PRECOMPILE_COUNT = len(PRECOMPILE_FUNCTIONS)


def native_contracts(address: int, data: List) -> List[int]:
    """Dispatch by precompile address (1-based)."""
    if not (1 <= address <= PRECOMPILE_COUNT):
        raise NativeContractException(f"not a precompile: {address}")
    return PRECOMPILE_FUNCTIONS[address - 1](data)
