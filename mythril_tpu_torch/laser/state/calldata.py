"""Calldata models (reference laser/ethereum/state/calldata.py:326).

ConcreteCalldata — fixed byte list; SymbolicCalldata — unbounded SMT array
with a fresh symbolic size; BasicConcreteCalldata — plain list access."""

from typing import Any, List, Union

from mythril_tpu_torch.smt import BitVec, Concat, Extract, If, symbol_factory
from mythril_tpu_torch.smt.array_expr import Array, K


def _index_bv(item) -> BitVec:
    if isinstance(item, int):
        return symbol_factory.BitVecVal(item, 256)
    return item


class BaseCalldata:
    def __init__(self, tx_id: str):
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        raise NotImplementedError

    @property
    def size(self) -> Union[BitVec, int]:
        raise NotImplementedError

    def get_word_at(self, offset) -> BitVec:
        """Big-endian 32-byte word; out-of-range bytes read as zero."""
        parts = [self[_index_bv(offset) + i] for i in range(32)]
        return Concat(parts)

    def __getitem__(self, item) -> Any:
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop
            assert stop is not None and (item.step or 1) == 1
            current = _index_bv(start)
            out = []
            length = stop - start if isinstance(stop, int) and isinstance(start, int) else None
            assert length is not None, "symbolic slice bounds use concretize()"
            for i in range(length):
                out.append(self._load(_index_bv(start + i)))
            return out
        return self._load(_index_bv(item))

    def _load(self, index: BitVec) -> BitVec:
        raise NotImplementedError

    def concrete(self, model) -> List[int]:
        """Concrete byte list under a model."""
        raise NotImplementedError


def _byte_bv(value) -> BitVec:
    """Coerce an int or BitVec(8) entry to BitVec(8) (inner-call calldata is
    read out of symbolic memory, so entries may already be expressions)."""
    if isinstance(value, BitVec):
        return value
    return symbol_factory.BitVecVal(value, 8)


class ConcreteCalldata(BaseCalldata):
    def __init__(self, tx_id: str, calldata: List):
        super().__init__(tx_id)
        self._calldata = list(calldata)
        # array form so symbolic indexing works
        self._array = K(256, 8, 0)
        for i, byte in enumerate(self._calldata):
            self._array[i] = _byte_bv(byte)

    @property
    def calldatasize(self) -> BitVec:
        return symbol_factory.BitVecVal(len(self._calldata), 256)

    @property
    def size(self) -> int:
        return len(self._calldata)

    def _load(self, index: BitVec) -> BitVec:
        if not index.symbolic:
            i = index.concrete_value
            if i < len(self._calldata):
                return _byte_bv(self._calldata[i])
            return symbol_factory.BitVecVal(0, 8)
        return self._array[index]

    def concrete(self, model) -> List[int]:
        return [
            byte.concrete_value if isinstance(byte, BitVec) and not byte.symbolic
            else (model.eval_int(byte) if isinstance(byte, BitVec) else byte)
            for byte in self._calldata
        ]


class BasicConcreteCalldata(BaseCalldata):
    """Fixed-length byte list without the array form; entries may be
    symbolic BitVec(8) (inner-call data read from memory)."""

    def __init__(self, tx_id: str, calldata: List):
        super().__init__(tx_id)
        self._calldata = list(calldata)

    @property
    def calldatasize(self) -> BitVec:
        return symbol_factory.BitVecVal(len(self._calldata), 256)

    @property
    def size(self) -> int:
        return len(self._calldata)

    def _load(self, index: BitVec) -> BitVec:
        if not index.symbolic:
            i = index.concrete_value
            if i < len(self._calldata):
                return _byte_bv(self._calldata[i])
            return symbol_factory.BitVecVal(0, 8)
        result = symbol_factory.BitVecVal(0, 8)
        for i, byte in enumerate(self._calldata):
            result = If(index == i, _byte_bv(byte), result)
        return result

    def concrete(self, model) -> List[int]:
        return [
            byte.concrete_value if isinstance(byte, BitVec) and not byte.symbolic
            else (model.eval_int(byte) if isinstance(byte, BitVec) else byte)
            for byte in self._calldata
        ]


class SymbolicCalldata(BaseCalldata):
    def __init__(self, tx_id: str):
        super().__init__(tx_id)
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        self._array = Array(f"{tx_id}_calldata", 256, 8)

    @property
    def calldatasize(self) -> BitVec:
        return self._size

    @property
    def size(self) -> BitVec:
        return self._size

    def _load(self, index: BitVec) -> BitVec:
        # bytes past calldatasize read as zero
        return If(
            index < self._size,
            self._array[index],
            symbol_factory.BitVecVal(0, 8),
        )

    def concrete(self, model) -> List[int]:
        concrete_size = model.eval_int(self._size)
        concrete_size = min(concrete_size, 5000)  # matches exploit size cap
        return [
            model.eval_int(self._load(symbol_factory.BitVecVal(i, 256)))
            for i in range(concrete_size)
        ]
