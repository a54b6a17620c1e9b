"""Statespace op records for POST modules
(reference analysis/ops.py:94 + call_helpers.py:60)."""

from enum import Enum

from mythril_tpu_torch.smt import BitVec


class VarType(Enum):
    CONCRETE = 1
    SYMBOLIC = 2


class Variable:
    def __init__(self, val, var_type: VarType):
        self.val = val
        self.type = var_type

    def __str__(self):
        return str(self.val)


def get_variable(i) -> Variable:
    if isinstance(i, int):
        return Variable(i, VarType.CONCRETE)
    if isinstance(i, BitVec) and not i.symbolic:
        return Variable(i.concrete_value, VarType.CONCRETE)
    return Variable(i, VarType.SYMBOLIC)


class Op:
    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    def __init__(self, node, state, state_index, call_type, to,
                 gas, value=Variable(0, VarType.CONCRETE), data=None):
        super().__init__(node, state, state_index)
        self.to = to
        self.call_type = call_type
        self.gas = gas
        self.value = value
        self.data = data


def get_call_from_state(state, node=None, state_index=0):
    """Decode a call-family instruction's arguments from a state snapshot."""
    instruction = state.get_current_instruction()
    if instruction is None:
        return None
    op = instruction.opcode
    stack = state.mstate_stack if hasattr(state, "mstate_stack") else state.mstate.stack
    try:
        if op in ("CALL", "CALLCODE"):
            gas, to, value = stack[-1], stack[-2], stack[-3]
            return Call(node, state, state_index, op, get_variable(to),
                        get_variable(gas), get_variable(value))
        if op in ("DELEGATECALL", "STATICCALL"):
            gas, to = stack[-1], stack[-2]
            return Call(node, state, state_index, op, get_variable(to),
                        get_variable(gas))
    except IndexError:
        return None
    return None
