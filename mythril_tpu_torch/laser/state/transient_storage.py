"""EIP-1153 transient storage, cleared between user transactions
(reference state/transient_storage.py:70; cleared at svm.py:263-265)."""

from mythril_tpu_torch.smt import BitVec, symbol_factory
from mythril_tpu_torch.smt.array_expr import K


class TransientStorage:
    def __init__(self):
        # (address is part of the key: keccak-free composite keying via
        # one array per account would need dynamic allocation; a single
        # 512-bit-keyed array keeps it functional)
        self._arrays = {}

    def _array_for(self, address: BitVec):
        key = address.concrete_value if not address.symbolic else hash(address.raw)
        if key not in self._arrays:
            self._arrays[key] = K(256, 256, 0)
        return self._arrays[key]

    def get(self, address: BitVec, index: BitVec) -> BitVec:
        return self._array_for(address)[index]

    def set(self, address: BitVec, index: BitVec, value: BitVec) -> None:
        self._array_for(address)[index] = value

    def clear(self) -> None:
        self._arrays.clear()

    def clone(self) -> "TransientStorage":
        dup = TransientStorage.__new__(TransientStorage)
        dup._arrays = {k: v.clone() for k, v in self._arrays.items()}
        return dup

    def __deepcopy__(self, memo):
        return self.clone()
