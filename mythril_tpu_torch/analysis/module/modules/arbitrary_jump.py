"""ArbitraryJump — SWC-127 attacker-controlled jump destination
(reference analysis/module/modules/arbitrary_jump.py:113)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ARBITRARY_JUMP
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class ArbitraryJump(DetectionModule):
    name = "arbitrary_jump"
    swc_id = ARBITRARY_JUMP
    description = "Caller can redirect execution to arbitrary bytecode locations."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]
    # fires (and solves) ONLY on a symbolic jump destination — a cone the
    # static CFG fully resolved (every target a push constant) cannot
    # trigger it, so inert-cone analysis may ignore this module's hooks
    symbolic_jump_only = True

    def _analyze_state(self, state):
        jump_dest = state.mstate.stack[-1]
        if not jump_dest.symbolic:
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
                swc_id=ARBITRARY_JUMP,
                title="Jump to an arbitrary instruction",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head="The caller can redirect execution to arbitrary bytecode locations.",
                description_tail=(
                    "It is possible to redirect the control flow to arbitrary "
                    "locations in the code. This may allow an attacker to "
                    "bypass security controls or manipulate the business logic "
                    "of the smart contract. Avoid using low-level-operations "
                    "and assembly to prevent this issue."
                ),
                transaction_sequence=transaction_sequence,
            )
        ]
