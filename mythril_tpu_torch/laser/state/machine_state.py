"""Machine frame: stack / memory / pc / gas
(reference laser/ethereum/state/machine_state.py:263)."""

from typing import List

from mythril_tpu_torch.laser.evm_exceptions import StackOverflowException, StackUnderflowException
from mythril_tpu_torch.laser.state.memory import Memory

STACK_LIMIT = 1024

# EVM memory-expansion gas (yellow paper appendix G; reference
# laser/ethereum/state/machine_state.py:171-191 via instruction_data.py).
GAS_MEMORY = 3
GAS_MEMORY_QUADRATIC_DENOMINATOR = 512


def _ceil32(value: int) -> int:
    return ((value + 31) // 32) * 32


def memory_expansion_fee(words):
    """Total memory fee for a memory of `words` 32-byte words (yellow
    paper appendix G). Kept polynomial — no branches, no floats — so it
    evaluates identically for python ints here and for batched int32
    arrays inside the vmapped frontier step (laser/frontier/kernel.py
    mirrors mem_extend with this exact formula)."""
    return (words * GAS_MEMORY
            + words * words // GAS_MEMORY_QUADRATIC_DENOMINATOR)


class MachineStack(list):
    def append(self, element) -> None:
        if len(self) >= STACK_LIMIT:
            raise StackOverflowException(
                f"stack limit {STACK_LIMIT} reached"
            )
        super().append(element)

    def pop(self, index=-1):
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("pop from empty stack") from None


class MachineState:
    def __init__(
        self,
        gas_limit: int,
        pc: int = 0,
        stack=None,
        subroutine_stack=None,
        memory: Memory = None,
        depth: int = 0,
        max_gas_used: int = 0,
        min_gas_used: int = 0,
    ):
        self.gas_limit = gas_limit
        self.pc = pc
        self.stack = MachineStack(stack or [])
        self.subroutine_stack = MachineStack(subroutine_stack or [])
        self.memory = memory or Memory()
        self.depth = depth
        self.max_gas_used = max_gas_used
        self.min_gas_used = min_gas_used

    def check_gas(self) -> None:
        from mythril_tpu_torch.laser.evm_exceptions import OutOfGasException

        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException()

    @property
    def memory_size(self) -> int:
        return self.memory.size

    def calculate_extension_size(self, start: int, size: int) -> int:
        """Word-aligned growth needed to cover [start, start+size)
        (reference machine_state.py:152-168)."""
        if self.memory_size > start + size:
            return 0
        new_size = _ceil32(start + size) // 32
        old_size = self.memory_size // 32
        return (new_size - old_size) * 32

    def calculate_memory_gas(self, start: int, size: int) -> int:
        """Quadratic memory-expansion fee (reference machine_state.py:171-185)."""
        oldsize = self.memory_size // 32
        newsize = _ceil32(start + size) // 32
        return memory_expansion_fee(newsize) - memory_expansion_fee(oldsize)

    def mem_extend(self, start, size) -> None:
        """Grow memory, charging the expansion fee; symbolic bounds are left
        unexpanded (reference machine_state.py:187-208)."""
        if not isinstance(start, int):
            if getattr(start, "symbolic", True):
                return
            start = start.concrete_value
        if not isinstance(size, int):
            if getattr(size, "symbolic", True):
                return
            size = size.concrete_value
        if size == 0:
            return
        if self.calculate_extension_size(start, size):
            extend_gas = self.calculate_memory_gas(start, size)
            self.min_gas_used += extend_gas
            self.max_gas_used += extend_gas
            self.check_gas()
            self.memory.extend_to(start, size)

    def pop(self, amount: int = 1):
        values = [self.stack.pop() for _ in range(amount)]
        return values[0] if amount == 1 else values

    def clone(self) -> "MachineState":
        dup = MachineState.__new__(MachineState)
        dup.gas_limit = self.gas_limit
        dup.pc = self.pc
        dup.stack = MachineStack(self.stack)
        dup.subroutine_stack = MachineStack(self.subroutine_stack)
        dup.memory = self.memory.clone()
        dup.depth = self.depth
        dup.max_gas_used = self.max_gas_used
        dup.min_gas_used = self.min_gas_used
        return dup

    def __deepcopy__(self, memo):
        return self.clone()

    def as_dict(self):
        return {
            "pc": self.pc,
            "stack": list(self.stack),
            "memory": self.memory,
            "memsize": self.memory_size,
            "gas": self.gas_limit - self.max_gas_used,
        }
