"""RequirementsViolation — SWC-123 callee-reachable revert with caller data
(reference analysis/module/modules/requirements_violation.py:85)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import REQUIREMENT_VIOLATION
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class RequirementsViolation(DetectionModule):
    name = "requirements_violation"
    swc_id = REQUIREMENT_VIOLATION
    description = "A requirement was violated in a nested call."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["REVERT"]

    def _analyze_state(self, state):
        # only flag REVERTs inside called (inner) frames: the caller supplied
        # data that made the callee's require() fail
        inner_frames = sum(
            1 for _tx, snap in state.transaction_stack if snap is not None
        )
        if inner_frames == 0:
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
                swc_id=REQUIREMENT_VIOLATION,
                title="Requirement Violation",
                severity="Medium",
                bytecode=state.environment.code.bytecode,
                description_head="A requirement was violated in a nested call and the call was reverted as a result.",
                description_tail=(
                    "Make sure valid inputs are provided to the nested call "
                    "(for instance, via passed arguments)."
                ),
                transaction_sequence=transaction_sequence,
            )
        ]
