"""Symbolic EXP modeling (reference
mythril/laser/ethereum/function_managers/exponent_function_manager.py:71).

Concrete base+exponent folds natively. Otherwise EXP becomes an
uninterpreted function exp(base, exponent) with interpolation constraints
for small concrete bases (2, 10, 256) tying sampled powers down."""

from typing import List, Tuple

from mythril_tpu_torch.smt import And, BitVec, Bool, Function, symbol_factory


class ExponentFunctionManager:
    def __init__(self):
        self.exponentiation = Function("exponentiation", [256, 256], 256)
        self.concrete_constraints: List[Bool] = []

    def reset(self):
        self.__init__()

    def create_condition(self, base: BitVec, exponent: BitVec) -> Tuple[BitVec, Bool]:
        """Returns (power_expr, side_constraint)."""
        if not base.symbolic and not exponent.symbolic:
            value = pow(base.concrete_value, exponent.concrete_value, 2 ** 256)
            return symbol_factory.BitVecVal(value, 256), Bool.value(True)
        if not base.symbolic and base.concrete_value > 1 and (
            base.concrete_value & (base.concrete_value - 1)
        ) == 0:
            # power-of-two base: (2^k)^e == 1 << (k*e) exactly, including
            # the wrap to 0 once k*e >= 256 — guard only against the k*e
            # multiply itself wrapping. Solc emits exp(0x100, shift) for
            # packed-storage access; keeping this a shift instead of an
            # uninterpreted function lets div/mod by it reduce to shifts
            # instead of a ~400k-gate restoring divider.
            k = base.concrete_value.bit_length() - 1
            one = symbol_factory.BitVecVal(1, 256)
            from mythril_tpu_torch.smt import If as _If, ULE

            # guard folded INTO the shift amount (shl saturates to 0 at
            # >= 256) so the result stays a pure `1 << s` term that
            # div/mod-by-power-of-two rewrites can see through
            amount = _If(
                ULE(exponent, symbol_factory.BitVecVal(256, 256)),
                exponent * symbol_factory.BitVecVal(k, 256),
                symbol_factory.BitVecVal(256, 256),
            )
            return one << amount, Bool.value(True)
        power = self.exponentiation(base, exponent)
        if not base.symbolic and base.concrete_value in (2, 10, 256):
            base_value = base.concrete_value
            constraints = []
            exponent_bits = 256 if base_value == 2 else (77 if base_value == 10 else 32)
            for sample in range(0, exponent_bits, max(1, exponent_bits // 16)):
                constraints.append(
                    Bool.value(True)
                    if sample == 0
                    else (exponent == sample)
                    == (power == pow(base_value, sample, 2 ** 256))
                )
            condition = And(*constraints) if constraints else Bool.value(True)
            return power, condition
        return power, Bool.value(True)


exponent_function_manager = ExponentFunctionManager()
