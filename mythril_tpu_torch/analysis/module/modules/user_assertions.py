"""UserAssertions — SWC-110 user-defined assertion signals
(reference analysis/module/modules/user_assertions.py:131).

Three signals, all deliberate assertion mechanisms (a plain
`require(cond, "reason")` revert is NOT one — flagging those would report
every guard clause in every contract):

* solidity >=0.8 `assert` — REVERT carrying `Panic(0x01)`;
* `emit AssertionFailed(string)` — LOG1 with the well-known topic;
* hevm-style property failure — MSTORE of the 0xcafecafe... marker word.
"""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.laser.instructions import concrete_or_none
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)

# Panic(uint256) selector; assertion failure is code 0x01
PANIC_SELECTOR = 0x4E487B71
# keccak("AssertionFailed(string)") — the MythX/hevm assertion event topic
ASSERTION_FAILED_TOPIC = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)
# hevm writes a word starting with this marker before failing a property
HEVM_MARKER_PREFIX = "0xcafecafecafecafecafecafecafecafecafecafe"


def _mstore_value_blocks(value: int) -> bool:
    """Conditional-transparency predicate for the MSTORE hook on batched
    frontier runs: the hook acts ONLY on a concretely-written hevm
    marker word (_hevm_marker_message — a symbolic value is already
    inert there), so a batched MSTORE of any other concrete value — the
    batch guarantees concreteness — may skip it. A row that DOES write
    the marker trips this predicate and bails to the per-state
    interpreter, where the hook fires exactly as before."""
    return hex(value).startswith(HEVM_MARKER_PREFIX)


class UserAssertions(DetectionModule):
    name = "user_assertions"
    swc_id = ASSERT_VIOLATION
    description = "A user-provided assertion failed."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["REVERT", "LOG1", "MSTORE"]
    # laser/frontier hook contract: MSTORE-bearing straight-line runs no
    # longer cut on this module — the hook is provably inert unless the
    # written word matches the hevm marker prefix (util.py copies this
    # onto the bound hook as frontier_transparent_unless)
    frontier_transparent_unless = {"MSTORE": _mstore_value_blocks}

    def _analyze_state(self, state):
        opcode = state.get_current_instruction().opcode
        if opcode == "REVERT":
            message = self._panic_message(state)
        elif opcode == "LOG1":
            message = self._assertion_event_message(state)
        else:
            message = self._hevm_marker_message(state)
        if message is None:
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except (UnsatError, SolverTimeOutException):
            return []
        except Exception:
            return []
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction().address,
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                bytecode=state.environment.code.bytecode,
                description_head=message,
                description_tail=(
                    "Review the transaction trace to see under which "
                    "conditions the assertion can be violated."
                ),
                transaction_sequence=transaction_sequence,
            )
        ]

    @staticmethod
    def _panic_message(state):
        """solidity 0.8 assert: REVERT with Panic(0x01) calldata."""
        offset, length = state.mstate.stack[-1], state.mstate.stack[-2]
        offset_c = concrete_or_none(offset)
        length_c = concrete_or_none(length)
        if offset_c is None or length_c is None or length_c < 36:
            return None
        word = state.mstate.memory.get_word_at(offset_c)
        selector_bv = concrete_or_none(word)
        if selector_bv is None or (selector_bv >> 224) != PANIC_SELECTOR:
            return None
        code = concrete_or_none(state.mstate.memory.get_word_at(offset_c + 4))
        if code != 1:
            return None
        return "An assertion violation was triggered (Panic 0x01)."

    @staticmethod
    def _assertion_event_message(state):
        """emit AssertionFailed(string): LOG1 with the well-known topic."""
        if len(state.mstate.stack) < 3:
            return None
        topic = concrete_or_none(state.mstate.stack[-3])
        if topic != ASSERTION_FAILED_TOPIC:
            return None
        return "A user-provided assertion failed (AssertionFailed event)."

    @staticmethod
    def _hevm_marker_message(state):
        """hevm property failure: MSTORE of the cafecafe... marker word."""
        if len(state.mstate.stack) < 2:
            return None
        value = concrete_or_none(state.mstate.stack[-2])
        if value is None:
            return None
        if not hex(value).startswith(HEVM_MARKER_PREFIX):
            return None
        return f"Failed property id {value & 0xFFFF}"
