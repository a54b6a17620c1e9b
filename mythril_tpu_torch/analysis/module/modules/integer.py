"""IntegerArithmetics — SWC-101 overflow/underflow reaching a sink
(reference analysis/module/modules/integer.py:350).

Mechanism (mirrors the reference flow):
- pre-hooks on ADD/SUB/MUL/EXP annotate the first operand with the overflow
  predicate; the SMT layer propagates annotations through the arithmetic op
  so the *result* carries the marker.
- sink hooks (SSTORE/JUMPI/CALL/RETURN) collect markers whose value reached
  the sink into a state-level annotation.
- at transaction end (STOP/RETURN) each collected marker is re-solved under
  the *current* path constraints and confirmed into a direct Issue via
  get_transaction_sequence — NOT the two-phase PotentialIssue flow, so
  overflows found during creation-tx interpretation are still reported
  (reference integer.py:_handle_transaction_end)."""

import logging
from copy import copy
from math import ceil, log2
from typing import List, Set

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import (
    And,
    BitVec,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Bool,
    If,
    Not,
    symbol_factory,
)
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class OverUnderflowAnnotation:
    """Attached to the possibly-overflowing value.

    The reference stores the whole GlobalState (its StateTransition
    decorator copies states, so the hooked object stays frozen at the op);
    this engine mutates states in place, so the origin is snapshotted here:
    address/function/constraints as they were AT the arithmetic op."""

    __slots__ = ("address", "function_name", "contract_name", "bytecode",
                 "origin_constraints", "operator", "constraint")

    def __init__(self, state, operator: str, constraint: Bool):
        instruction = state.get_current_instruction()
        self.address = instruction.address
        self.function_name = state.environment.active_function_name
        self.contract_name = state.environment.active_account.contract_name
        self.bytecode = state.environment.code.bytecode
        self.origin_constraints = list(
            state.world_state.constraints.get_all_constraints()
        )
        self.operator = operator
        self.constraint = constraint

    def __deepcopy__(self, memodict={}):
        # markers are immutable snapshots; share across forks
        # (reference integer.py:46-48)
        return copy(self)

    # value semantics so per-fork copies dedupe inside the sink bucket
    def __hash__(self):
        return hash((self.address, self.operator, hash(self.constraint)))

    def __eq__(self, other):
        if not isinstance(other, OverUnderflowAnnotation):
            return NotImplemented
        return (
            self.address == other.address
            and self.operator == other.operator
            and hash(self.constraint) == hash(other.constraint)
        )


class OverUnderflowStateAnnotation(StateAnnotation):
    """State-level bucket of markers whose value reached a sink."""

    def __init__(self):
        self.overflowing_state_annotations: Set[OverUnderflowAnnotation] = set()

    def __copy__(self):
        new = OverUnderflowStateAnnotation()
        new.overflowing_state_annotations = copy(
            self.overflowing_state_annotations
        )
        return new


def _get_overflowunderflow_state_annotation(state) -> OverUnderflowStateAnnotation:
    existing = list(state.get_annotations(OverUnderflowStateAnnotation))
    if existing:
        return existing[0]
    annotation = OverUnderflowStateAnnotation()
    state.annotate(annotation)
    return annotation


class IntegerArithmetics(DetectionModule):
    name = "integer_overflow_and_underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = "Integer overflow or underflow reaching a sink."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD",
        "MUL",
        "EXP",
        "SUB",
        "SSTORE",
        "JUMPI",
        "STOP",
        "RETURN",
        "CALL",
    ]
    # JUMPI/STOP/RETURN/CALL/SSTORE are sinks for already-tainted values;
    # no issue without an arithmetic source executing
    trigger_opcodes = ["ADD", "MUL", "EXP", "SUB"]

    def __init__(self):
        super().__init__()
        # satisfiability cache of overflow predicates at their origin state
        self._ostates_satisfiable: Set[int] = set()
        self._ostates_unsatisfiable: Set[int] = set()

    def reset_module(self):
        super().reset_module()
        self._ostates_satisfiable = set()
        self._ostates_unsatisfiable = set()

    def _analyze_state(self, state) -> List[Issue]:
        if not args.use_integer_module:
            return []
        handlers = {
            "ADD": [self._handle_add],
            "SUB": [self._handle_sub],
            "MUL": [self._handle_mul],
            "EXP": [self._handle_exp],
            "SSTORE": [self._handle_sstore],
            "JUMPI": [self._handle_jumpi],
            "CALL": [self._handle_call],
            "RETURN": [self._handle_return, self._handle_transaction_end],
            "STOP": [self._handle_transaction_end],
        }
        issues: List[Issue] = []
        for handler in handlers.get(self.current_opcode, []):
            result = handler(state)
            if result:
                issues += result
        return issues

    # -- arithmetic-op marking ----------------------------------------------

    @staticmethod
    def _make_bitvec_if_not(stack, index):
        value = stack[index]
        if isinstance(value, BitVec):
            return value
        if isinstance(value, Bool):
            return If(value, 1, 0)
        stack[index] = symbol_factory.BitVecVal(value, 256)
        return stack[index]

    def _get_args(self, state):
        stack = state.mstate.stack
        return (
            self._make_bitvec_if_not(stack, -1),
            self._make_bitvec_if_not(stack, -2),
        )

    def _handle_add(self, state):
        op0, op1 = self._get_args(state)
        constraint = Not(BVAddNoOverflow(op0, op1, False))
        op0.annotate(OverUnderflowAnnotation(state, "addition", constraint))

    def _handle_sub(self, state):
        op0, op1 = self._get_args(state)
        constraint = Not(BVSubNoUnderflow(op0, op1, False))
        op0.annotate(OverUnderflowAnnotation(state, "subtraction", constraint))

    def _handle_mul(self, state):
        op0, op1 = self._get_args(state)
        constraint = Not(BVMulNoOverflow(op0, op1, False))
        op0.annotate(
            OverUnderflowAnnotation(state, "multiplication", constraint)
        )

    def _handle_exp(self, state):
        op0, op1 = self._get_args(state)
        if (not op1.symbolic and op1.concrete_value == 0) or (
            not op0.symbolic and op0.concrete_value < 2
        ):
            return
        if op0.symbolic and op1.symbolic:
            constraint = And(
                op1 > symbol_factory.BitVecVal(256, 256),
                op0 > symbol_factory.BitVecVal(1, 256),
            )
        elif op0.symbolic:
            constraint = op0 >= symbol_factory.BitVecVal(
                2 ** ceil(256 / op1.concrete_value), 256
            )
        else:
            constraint = op1 >= symbol_factory.BitVecVal(
                ceil(256 / log2(op0.concrete_value)), 256
            )
        op0.annotate(
            OverUnderflowAnnotation(state, "exponentiation", constraint)
        )

    # -- sink collection -----------------------------------------------------

    @staticmethod
    def _collect(state, value) -> None:
        if not isinstance(value, BitVec):
            return
        bucket = _get_overflowunderflow_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                bucket.overflowing_state_annotations.add(annotation)

    def _handle_sstore(self, state):
        self._collect(state, state.mstate.stack[-2])

    def _handle_jumpi(self, state):
        self._collect(state, state.mstate.stack[-2])

    def _handle_call(self, state):
        self._collect(state, state.mstate.stack[-3])

    def _handle_return(self, state):
        """Values flowing out via RETURN memory are sinks too
        (reference integer.py:_handle_return)."""
        stack = state.mstate.stack
        offset, length = stack[-1], stack[-2]
        if offset.symbolic or length.symbolic:
            return
        start = offset.concrete_value
        count = min(length.concrete_value, 0x1000)
        for i in range(count):
            self._collect(state, state.mstate.memory.get_byte(start + i))

    # -- transaction-end confirmation ---------------------------------------

    def _handle_transaction_end(self, state) -> List[Issue]:
        issues: List[Issue] = []
        bucket = _get_overflowunderflow_state_annotation(state)
        for annotation in bucket.overflowing_state_annotations:
            okey = (annotation.address, hash(annotation.constraint))
            if okey in self._ostates_unsatisfiable:
                continue
            if okey not in self._ostates_satisfiable:
                # quick pre-check at the origin state before the expensive
                # sequence concretization (reference integer.py:268-277)
                try:
                    get_model(
                        annotation.origin_constraints + [annotation.constraint]
                    )
                    self._ostates_satisfiable.add(okey)
                except Exception:
                    self._ostates_unsatisfiable.add(okey)
                    continue
            try:
                constraints = list(state.world_state.constraints) + [
                    annotation.constraint
                ]
                transaction_sequence = solver.get_transaction_sequence(
                    state, constraints
                )
            except (UnsatError, SolverTimeOutException):
                continue
            description_head = "The arithmetic operator can {}.".format(
                "underflow"
                if annotation.operator == "subtraction"
                else "overflow"
            )
            description_tail = (
                "It is possible to cause an integer overflow or underflow "
                "in the arithmetic operation. Prevent this by constraining "
                "inputs using the require() statement or use the "
                "OpenZeppelin SafeMath library for integer arithmetic "
                "operations. Refer to the transaction trace generated for "
                "this issue to reproduce the issue."
            )
            issue = Issue(
                contract=annotation.contract_name,
                function_name=annotation.function_name,
                address=annotation.address,
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                bytecode=annotation.bytecode,
                title="Integer Arithmetic Bugs",
                severity="High",
                description_head=description_head,
                description_tail=description_tail,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
            state.annotate(
                IssueAnnotation(
                    issue=issue, detector=self, conditions=[And(*constraints)]
                )
            )
            issues.append(issue)
        return issues
