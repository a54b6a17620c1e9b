"""ArbitraryStorage — SWC-124 write to attacker-controlled slot
(reference analysis/module/modules/arbitrary_write.py:79)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import WRITE_TO_ARBITRARY_STORAGE
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class ArbitraryStorage(DetectionModule):
    name = "arbitrary_storage_write"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Caller can write to arbitrary storage locations."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]

    def _analyze_state(self, state):
        write_slot = state.mstate.stack[-1]
        if not write_slot.symbolic:
            return []
        # can the slot be forced to an arbitrary probe value?
        probe = symbol_factory.BitVecVal(324345425435, 256)
        constraints = [write_slot == probe]
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
            swc_id=WRITE_TO_ARBITRARY_STORAGE,
            title="Write to an arbitrary storage location",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The caller can write to arbitrary storage locations.",
            description_tail=(
                "It is possible to write to arbitrary storage locations. By "
                "modifying the values of storage variables, attackers may "
                "bypass security controls or manipulate the business logic of "
                "the smart contract."
            ),
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
