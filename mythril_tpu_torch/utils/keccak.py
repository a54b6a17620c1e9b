"""Self-contained Keccak-256 (the Ethereum hash; original pad, not SHA3-06).

The environment ships no native keccak (no eth-hash/pysha3/pycryptodome),
so the sponge is implemented here from the Keccak spec. It is used to
concretize symbolic hash placeholders (reference:
mythril/laser/ethereum/function_managers/keccak_function_manager.py:56-69)
and by the SHA3 opcode on concrete inputs. A C++ fast path can be layered
behind the same function later; correctness vectors live in
tests/test_keccak.py.
"""

from functools import lru_cache

_MASK64 = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] for lane (x, y).
_ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

_RATE_BYTES = 136  # 1600-bit state, 512-bit capacity -> 136-byte rate


def _rotl64(value: int, shift: int) -> int:
    return ((value << shift) | (value >> (64 - shift))) & _MASK64


def _keccak_f1600(lanes):
    """One permutation over the 5x5 lane matrix (lanes[x][y], 64-bit ints)."""
    for rc in _ROUND_CONSTANTS:
        # theta
        col = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
               for x in range(5)]
        delta = [col[(x - 1) % 5] ^ _rotl64(col[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            d = delta[x]
            lanes[x] = [lane ^ d for lane in lanes[x]]
        # rho + pi
        moved = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                moved[y][(2 * x + 3 * y) % 5] = _rotl64(lanes[x][y], _ROTATIONS[x][y])
        # chi
        for y in range(5):
            row = [moved[x][y] for x in range(5)]
            for x in range(5):
                lanes[x][y] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5])
        # iota
        lanes[0][0] ^= rc
    return lanes


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest of `data` (32 bytes)."""
    lanes = [[0] * 5 for _ in range(5)]
    # pad10*1 with the original Keccak domain byte 0x01
    padded = bytearray(data)
    pad_len = _RATE_BYTES - (len(padded) % _RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    # absorb
    for block_start in range(0, len(padded), _RATE_BYTES):
        block = padded[block_start:block_start + _RATE_BYTES]
        for i in range(_RATE_BYTES // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            x, y = i % 5, i // 5
            lanes[x][y] ^= lane
        _keccak_f1600(lanes)
    # squeeze (32 bytes < rate, single block)
    out = bytearray()
    for i in range(4):
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


def keccak256_int(value: int, width_bytes: int = 32) -> int:
    """Hash a big-endian fixed-width integer; returns the digest as an int."""
    return int.from_bytes(keccak256(value.to_bytes(width_bytes, "big")), "big")


@lru_cache(maxsize=65536)
def function_selector(signature: str) -> bytes:
    """First four digest bytes of an ABI signature, e.g. 'transfer(address,uint256)'."""
    return keccak256(signature.encode())[:4]
