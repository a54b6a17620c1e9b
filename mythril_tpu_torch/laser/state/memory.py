"""Symbolic byte-addressed EVM memory.

Reference (laser/ethereum/state/memory.py) keeps a dict of byte cells; here
memory is a functional SMT array (256-bit index -> 8-bit cells). The term
layer's eager read-over-write elimination makes concrete-index access fold
away, and symbolic-index access is handled by the solver's store-chain
unwinding — one mechanism instead of two."""

from typing import List, Union

from mythril_tpu_torch.smt import BitVec, Concat, Extract, If, symbol_factory
from mythril_tpu_torch.smt.array_expr import K
from mythril_tpu_torch.smt import terms as _terms

APPROX_ITR = 100  # cap for symbolic-length copy loops (reference memory.py:30)


def _to_index(index) -> BitVec:
    if isinstance(index, int):
        return symbol_factory.BitVecVal(index, 256)
    return index


class Memory:
    def __init__(self):
        self._memory = K(256, 8, 0)
        self._msize = 0
        # concrete shadow of the store chain, maintained incrementally so
        # the vmapped frontier (laser/frontier/) can densify the touched
        # window without walking the SMT array byte by byte:
        #   _shadow     concrete index -> concrete byte value (int 0-255)
        #   _sym_bytes  concrete indices last written with a SYMBOLIC value
        #   _poisoned   a write at a SYMBOLIC index happened — the store
        #               chain may alias any concrete index, so no dense
        #               view of this memory is trustworthy for reads
        self._shadow = {}
        self._sym_bytes = set()
        self._poisoned = False
        # last dense_window result, invalidated by any write: batch
        # admission and encode both densify the same untouched memory,
        # and the window build (bytearray + full shadow scan) is the
        # expensive part of the probe
        self._dense_cache = None

    @property
    def size(self) -> int:
        return self._msize

    def extend(self, size: int) -> None:
        self._msize += size

    def extend_to(self, offset: int, length: int) -> None:
        """Word-aligned growth covering [offset, offset+length)."""
        if length == 0:
            return
        needed = ((offset + length + 31) // 32) * 32
        if needed > self._msize:
            self._msize = needed

    def __getitem__(self, item) -> Union[BitVec, List[BitVec]]:
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop
            step = item.step or 1
            assert step == 1 and stop is not None, "memory slices must be contiguous"
            return [self.get_byte(i) for i in range(start, stop)]
        return self.get_byte(item)

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice):
            start = key.start or 0
            assert (key.step or 1) == 1
            for offset, byte in enumerate(value):
                self.write_byte(start + offset, byte)
        else:
            self.write_byte(key, value)

    def get_byte(self, index) -> BitVec:
        return self._memory[_to_index(index)]

    def write_byte(self, index, value) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 8)
        elif value.size != 8:
            value = Extract(7, 0, value)
        # shadow maintenance: the term layer folds concrete arithmetic
        # eagerly, so raw.is_const is a sufficient concreteness test here
        # (no simplify call on the hot write path)
        if isinstance(index, int):
            concrete_index = index
        elif index.raw.is_const:
            concrete_index = index.raw.value
        else:
            concrete_index = None
        if concrete_index is None:
            self._poisoned = True
        elif value.raw.is_const and not value.annotations:
            self._shadow[concrete_index] = value.raw.value
            self._sym_bytes.discard(concrete_index)
        else:
            self._shadow.pop(concrete_index, None)
            self._sym_bytes.add(concrete_index)
        self._dense_cache = None
        self._memory[_to_index(index)] = value

    def get_word_at(self, index) -> BitVec:
        """Big-endian 32-byte word starting at `index`."""
        if isinstance(index, int):
            parts = [self.get_byte(index + i) for i in range(32)]
        else:
            parts = [
                self.get_byte(index + symbol_factory.BitVecVal(i, 256))
                for i in range(32)
            ]
        return Concat(parts)

    def write_word_at(self, index, value) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        elif isinstance(value, bool):
            value = If(
                value,
                symbol_factory.BitVecVal(1, 256),
                symbol_factory.BitVecVal(0, 256),
            )
        if value.size < 256:
            from mythril_tpu_torch.smt import ZeroExt

            value = ZeroExt(256 - value.size, value)
        for i in range(32):
            byte = Extract(255 - 8 * i, 248 - 8 * i, value)
            if isinstance(index, int):
                self.write_byte(index + i, byte)
            else:
                self.write_byte(index + symbol_factory.BitVecVal(i, 256), byte)

    def copy_from_bytes(self, offset, data: bytes) -> None:
        for i, byte in enumerate(data):
            self.write_byte(offset + i, byte)

    def read_bytes_concrete(self, offset: int, length: int) -> List[BitVec]:
        return [self.get_byte(offset + i) for i in range(length)]

    def dense_window(self, window: int):
        """Concrete bytes [0, window) as a bytearray, or None when a dense
        read view would be unsound: a symbolic-index write may alias any
        byte, a symbolic byte value sits inside the window, or the array
        carries taint annotations a dense read would fail to propagate.
        Unwritten bytes are 0 — identical to the K(256, 8, 0) base array."""
        cached = self._dense_cache
        if cached is not None and cached[0] == window:
            return cached[1]
        if self._poisoned or self._memory.annotations:
            result = None
        elif self._sym_bytes and any(i < window for i in self._sym_bytes):
            result = None
        else:
            result = bytearray(window)
            for index, value in self._shadow.items():
                if index < window:
                    result[index] = value
        self._dense_cache = (window, result)
        return result

    def clone(self) -> "Memory":
        dup = Memory.__new__(Memory)
        dup._memory = self._memory.clone()
        dup._msize = self._msize
        dup._shadow = dict(self._shadow)
        dup._sym_bytes = set(self._sym_bytes)
        dup._poisoned = self._poisoned
        dup._dense_cache = None
        return dup

    def __deepcopy__(self, memo) -> "Memory":
        return self.clone()
