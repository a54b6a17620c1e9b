"""Symbolic keccak-256 modeling (reference
mythril/laser/ethereum/function_managers/keccak_function_manager.py).

Concrete inputs hash natively. A symbolic input of bit-width n flows through
the uninterpreted function keccak256_n; axioms injected at solve time
(via Constraints.get_all_constraints) give each width a disjoint output
interval, congruence with every concretely-hashed value, an inverse function
(injectivity), and result % 64 == 0 — mirroring the reference's trick that
keeps symbolic storage slots for mappings distinct and solvable. Exploit
concretization later rewrites placeholder hashes to real digests
(analysis/solver.py in the reference)."""

from typing import Dict, List, Tuple

from mythril_tpu_torch.smt import And, BitVec, Bool, Function, Or, symbol_factory
from mythril_tpu_torch.utils.keccak import keccak256

TOTAL_PARTS = 10 ** 40
PART = (2 ** 256 - 1) // TOTAL_PARTS
INTERVAL_DIFFERENCE = 10 ** 30


class KeccakFunctionManager:
    def __init__(self):
        self.store_function: Dict[int, Tuple[Function, Function]] = {}
        self.interval_hook_for_size: Dict[int, int] = {}
        # (size) -> list of symbolic input BitVecs seen
        self.symbolic_inputs: Dict[int, List[BitVec]] = {}
        # concretely hashed pairs keyed by (size, value) to avoid relying
        # on BitVec.__eq__ (which returns a Bool expression, not a bool)
        self.concrete_hashes: Dict[Tuple[int, int], Tuple[BitVec, BitVec]] = {}
        self.hash_matcher = "fffffff"  # marker prefix (reference :33)
        self._index_counter = TOTAL_PARTS - 34534

    def reset(self):
        self.__init__()

    def get_function(self, length: int) -> Tuple[Function, Function]:
        try:
            return self.store_function[length]
        except KeyError:
            func = Function(f"keccak256_{length}", [length], 256)
            inverse = Function(f"keccak256_{length}-1", [256], length)
            self.store_function[length] = (func, inverse)
            self.symbolic_inputs[length] = []
            return func, inverse

    @staticmethod
    def get_empty_keccak_hash() -> BitVec:
        return symbol_factory.BitVecVal(
            int.from_bytes(keccak256(b""), "big"), 256
        )

    def create_keccak(self, data: BitVec) -> BitVec:
        length = data.size
        func, _ = self.get_function(length)
        if not data.symbolic:
            concrete_hash = self.find_concrete_keccak(data)
            self.concrete_hashes[(length, data.concrete_value)] = (data, concrete_hash)
            return concrete_hash
        if all(data.raw is not seen.raw for seen in self.symbolic_inputs[length]):
            self.symbolic_inputs[length].append(data)
        return func(data)

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        return symbol_factory.BitVecVal(
            int.from_bytes(
                keccak256(data.concrete_value.to_bytes(data.size // 8, "big")),
                "big",
            ),
            256,
        )

    def _interval_constraint(self, hashed: BitVec, length: int) -> Bool:
        lower = self._interval_start_for_size(length)
        upper = lower + INTERVAL_DIFFERENCE - 64
        lower_bv = symbol_factory.BitVecVal(lower, 256)
        upper_bv = symbol_factory.BitVecVal(upper, 256)
        cond = And(
            hashed >= lower_bv,
            hashed <= upper_bv,
            (hashed % 64) == symbol_factory.BitVecVal(0, 256),
        )
        # hash may also equal any known concrete digest of the same width
        for (size, _), (_, concrete_hash) in self.concrete_hashes.items():
            if size != length:
                continue
            cond = Or(cond, hashed == concrete_hash)
        return cond

    def _interval_start_for_size(self, length: int) -> int:
        if length not in self.interval_hook_for_size:
            self.interval_hook_for_size[length] = self._index_counter
            self._index_counter -= INTERVAL_DIFFERENCE // PART + 1
        return self.interval_hook_for_size[length] * PART

    def create_conditions(self) -> List[Bool]:
        """Axioms for every symbolic application; appended at solve time."""
        conditions: List[Bool] = []
        for length, inputs in self.symbolic_inputs.items():
            func, inverse = self.store_function[length]
            for data in inputs:
                hashed = func(data)
                conditions.append(inverse(hashed) == data)
                conditions.append(self._interval_constraint(hashed, length))
        for (size, _), (data, concrete_hash) in self.concrete_hashes.items():
            func, inverse = self.get_function(size)
            conditions.append(func(data) == concrete_hash)
            conditions.append(inverse(concrete_hash) == data)
        return conditions


keccak_function_manager = KeccakFunctionManager()
