"""Exceptions — SWC-110 reachable assert violation
(reference analysis/module/modules/exceptions.py:152).

Two assert encodings are recognized:
- pre-0.8 solc: `assert` compiles to the INVALID (0xfe) opcode;
- solc >= 0.8: assert failure REVERTs with `Panic(uint256)` code 0x01 —
  detected by matching the Panic ABI signature in the revert buffer
  (reference exceptions.py:139-151).

Issues are cached per (last JUMP address, code hash) so the same assert
body reached from different call sites still reports once per site
(reference exceptions.py:44-56,86-91)."""

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import And
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)

# ABI signature of Panic(uint256)
PANIC_SIGNATURE = [78, 72, 123, 113]

DESCRIPTION_HEAD = "An assertion violation was triggered."
DESCRIPTION_TAIL = (
    "It is possible to trigger an assertion violation. Note that Solidity "
    "assert() statements should only be used to check invariants. Review "
    "the transaction trace generated for this issue and either make sure "
    "your program logic is correct, or use require() instead of assert() "
    "if your goal is to constrain user inputs or enforce preconditions."
)


class LastJumpAnnotation(StateAnnotation):
    """Tracks the address of the last JUMP taken on this path."""

    def __init__(self, last_jump: Optional[int] = None):
        self.last_jump = last_jump

    def __copy__(self):
        return LastJumpAnnotation(self.last_jump)

    def clone(self):
        return LastJumpAnnotation(self.last_jump)


def _concrete_or_none(value) -> Optional[int]:
    if isinstance(value, int):
        return value
    if getattr(value, "symbolic", True):
        return None
    return value.concrete_value


def is_assertion_failure(state) -> bool:
    """REVERT buffer starts with Panic(uint256) and the code is 0x01."""
    mstate = state.mstate
    offset, length = mstate.stack[-1], mstate.stack[-2]
    offset_c = _concrete_or_none(offset)
    length_c = _concrete_or_none(length)
    if offset_c is None or length_c is None or not 4 < length_c <= 0x1000:
        return False
    data = [
        _concrete_or_none(mstate.memory.get_byte(offset_c + i))
        for i in range(length_c)
    ]
    if any(b is None for b in data):
        return False
    return data[:4] == PANIC_SIGNATURE and data[-1] == 1


class Exceptions(DetectionModule):
    name = "exceptions"
    swc_id = ASSERT_VIOLATION
    description = DESCRIPTION_HEAD
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["INVALID", "JUMP", "REVERT"]
    # JUMP only records the last-jump cache key; issues fire at
    # INVALID (0.4-style assert) or panic-data REVERT (0.8 assert)
    trigger_opcodes = ["INVALID", "REVERT"]

    def __init__(self):
        super().__init__()
        self.auto_cache = False

    def _analyze_state(self, state) -> List[Issue]:
        instruction = state.get_current_instruction()
        opcode, address = instruction.opcode, instruction.address

        annotations = list(state.get_annotations(LastJumpAnnotation))
        if not annotations:
            annotation = LastJumpAnnotation()
            state.annotate(annotation)
            annotations = [annotation]

        if opcode == "JUMP":
            annotations[0].last_jump = address
            return []

        if opcode == "REVERT" and not is_assertion_failure(state):
            return []

        cache_address = annotations[0].last_jump
        code_hash = "0x" + state.environment.code.bytecode_hash.hex()
        if (cache_address, code_hash) in self.cache:
            return []

        log.debug(
            "ASSERT_FAIL/REVERT in function %s",
            state.environment.active_function_name,
        )
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except (UnsatError, SolverTimeOutException):
            return []
        except Exception:
            return []

        self.cache.add((cache_address, code_hash))
        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=address,
            swc_id=ASSERT_VIOLATION,
            title="Exception State",
            severity="Medium",
            bytecode=state.environment.code.bytecode,
            description_head=DESCRIPTION_HEAD,
            description_tail=DESCRIPTION_TAIL,
            transaction_sequence=transaction_sequence,
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
        )
        state.annotate(
            IssueAnnotation(
                conditions=[And(*state.world_state.constraints)],
                issue=issue,
                detector=self,
            )
        )
        return [issue]
