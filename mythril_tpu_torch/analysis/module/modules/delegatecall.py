"""ArbitraryDelegateCall — SWC-112 delegatecall to attacker-controlled callee
(reference analysis/module/modules/delegatecall.py:100)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class ArbitraryDelegateCall(DetectionModule):
    name = "arbitrary_delegatecall"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = "Delegatecall to a user-specified address."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]

    def _analyze_state(self, state):
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        if not to.symbolic:
            return []
        constraints = [
            to == ACTORS.attacker,
        ]
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx.caller, int) and tx.caller.symbolic:
                constraints.append(tx.caller == ACTORS.attacker)
        try:
            get_model(
                state.world_state.constraints.get_all_constraints() + constraints
            )
        except UnsatError:
            return []
        except Exception:
            return []
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=state.get_current_instruction().address,
            swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
            title="Delegatecall to user-specified address",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The contract delegates execution to another contract with a user-supplied address.",
            description_tail=(
                "The smart contract delegates execution to a user-supplied "
                "address. This could allow an attacker to execute arbitrary "
                "code in the context of this contract account and manipulate "
                "the state of the contract account or execute actions on its "
                "behalf."
            ),
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
