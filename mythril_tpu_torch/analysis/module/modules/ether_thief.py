"""EtherThief — SWC-105 unprotected ether withdrawal
(reference analysis/module/modules/ether_thief.py:100)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT
from mythril_tpu_torch.support.model import get_model
from mythril_tpu_torch.smt.solver.frontend import UnsatError

log = logging.getLogger(__name__)

DESCRIPTION_HEAD = "Any sender can withdraw ETH from the contract account."
DESCRIPTION_TAIL = (
    "Arbitrary senders other than the contract creator can profitably "
    "extract ETH from the contract account. Verify the business logic "
    "carefully and make sure that appropriate security controls are in "
    "place to prevent unexpected loss of funds."
)


class EtherThief(DetectionModule):
    name = "ether_thief"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = DESCRIPTION_HEAD
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL", "STATICCALL"]

    def _analyze_state(self, state):
        instruction = state.get_current_instruction()
        if instruction is None:  # CALL was the last instruction of the code
            return []

        # the attacker sends the CURRENT tx (as an EOA: caller == origin)
        # and ends up richer than they started. Earlier txs stay
        # unconstrained — the contract may legitimately have been funded at
        # creation (reference ether_thief.py:65-72; constraining every tx's
        # value to 0 would rule out payable constructors like flag_array's).
        world_state = state.world_state
        current_tx = state.current_transaction
        constraints = [
            UGT(
                world_state.balances[ACTORS.attacker],
                world_state.starting_balances[ACTORS.attacker],
            ),
            state.environment.sender == ACTORS.attacker,
            current_tx.caller == current_tx.origin,
        ]

        try:
            get_model(
                world_state.constraints.get_all_constraints() + constraints
            )
        except UnsatError:
            return []
        except Exception:
            return []

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            # post-hook state: pc advanced past the 1-byte CALL opcode
            address=instruction.address - 1,
            swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
            title="Unprotected Ether Withdrawal",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head=DESCRIPTION_HEAD,
            description_tail=DESCRIPTION_TAIL,
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
