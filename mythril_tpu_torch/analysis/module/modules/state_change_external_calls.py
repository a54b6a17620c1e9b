"""StateChangeAfterCall — SWC-107 state write after external call
(reference analysis/module/modules/state_change_external_calls.py:205)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import UGT, symbol_factory
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class CallIssueAnnotation(StateAnnotation):
    def __init__(self, call_address: int, user_defined_address: bool):
        self.call_address = call_address
        self.user_defined_address = user_defined_address

    def clone(self):
        return CallIssueAnnotation(self.call_address, self.user_defined_address)


class StateChangeAfterCall(DetectionModule):
    name = "state_change_external_calls"
    swc_id = REENTRANCY
    description = "State change after an external call."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "CALLCODE", "SSTORE", "CREATE",
                 "CREATE2"]

    def _analyze_state(self, state):
        opcode = self.current_opcode
        if opcode in ("CALL", "DELEGATECALL", "CALLCODE"):
            gas = state.mstate.stack[-1]
            to = state.mstate.stack[-2]
            # only calls that can execute code (enough gas) count
            try:
                get_model(
                    state.world_state.constraints.get_all_constraints()
                    + [UGT(gas, symbol_factory.BitVecVal(2300, 256))]
                )
            except UnsatError:
                return []
            except Exception:
                return []
            state.annotate(
                CallIssueAnnotation(
                    call_address=state.get_current_instruction().address,
                    user_defined_address=to.symbolic,
                )
            )
            return []

        # state-changing opcode: flag if any prior external call on this path
        annotations = [
            a for a in state.annotations if isinstance(a, CallIssueAnnotation)
        ]
        if not annotations:
            return []
        annotation = annotations[-1]
        severity = "Medium" if annotation.user_defined_address else "Low"
        address_desc = (
            "a user-defined address" if annotation.user_defined_address
            else "a fixed address"
        )
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=state.get_current_instruction().address,
            swc_id=REENTRANCY,
            title="State access after external call",
            severity=severity,
            bytecode=state.environment.code.bytecode,
            description_head=(
                "Write to persistent state following external call"
            ),
            description_tail=(
                f"The contract account state is accessed after an external "
                f"call to {address_desc}. To prevent reentrancy issues, "
                f"consider accessing the state only before the call, "
                f"especially if the callee is untrusted. Alternatively, a "
                f"reentrancy lock can be used to prevent untrusted callees "
                f"from re-entering the contract in an intermediate state."
            ),
            constraints=[],
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
