"""ExternalCalls — SWC-107 call to untrusted address with user gas
(reference analysis/module/modules/external_calls.py:122)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.smt import UGT, symbol_factory
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)

DESCRIPTION_HEAD = "A call to a user-supplied address is executed."
DESCRIPTION_TAIL_GAS = (
    "An external message call to an address specified by the caller is "
    "executed. Note that the callee account might contain arbitrary code "
    "and could re-enter any function within this contract. Reentering the "
    "contract in an intermediate state may lead to unexpected behaviour. "
    "Make sure that no state modifications are executed after this call "
    "and/or reentrancy guards are in place."
)


class ExternalCalls(DetectionModule):
    name = "external_calls"
    swc_id = REENTRANCY
    description = DESCRIPTION_HEAD
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]

    def _analyze_state(self, state):
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        if not to.symbolic:
            return []
        try:
            # enough gas forwarded for the callee to do damage (> stipend)
            constraints = [UGT(gas, symbol_factory.BitVecVal(2300, 256))]
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
            swc_id=REENTRANCY,
            title="External Call To User-Supplied Address",
            severity="Low",
            bytecode=state.environment.code.bytecode,
            description_head=DESCRIPTION_HEAD,
            description_tail=DESCRIPTION_TAIL_GAS,
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
