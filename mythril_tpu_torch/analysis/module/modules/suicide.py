"""AccidentallyKillable — SWC-106 unprotected SELFDESTRUCT
(reference analysis/module/modules/suicide.py:125).

Issues are confirmed immediately via get_transaction_sequence (the reference
does NOT route this module through PotentialIssue — suicide.py:70-95) so a
SELFDESTRUCT reached during the creation transaction is still reported even
though creation txs ending in SELFDESTRUCT never reach
check_potential_issues (svm gating on transaction.return_data)."""

import logging
from typing import List

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_SELFDESTRUCT
from mythril_tpu_torch.laser.transaction.models import ContractCreationTransaction
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import And
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)

DESCRIPTION_HEAD = "Any sender can cause the contract to self-destruct."
DESCRIPTION_TAIL = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to "
    "destroy this contract account and withdraw its balance to an arbitrary "
    "address. Review the transaction trace generated for this issue and "
    "make sure that appropriate security controls are in place to prevent "
    "unrestricted access."
)


class AccidentallyKillable(DetectionModule):
    name = "accidentally_killable"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = DESCRIPTION_HEAD
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SELFDESTRUCT"]

    def _analyze_state(self, state) -> List[Issue]:
        log.debug(
            "SELFDESTRUCT in function %s",
            state.environment.active_function_name,
        )
        instruction = state.get_current_instruction()
        to = state.mstate.stack[-1]

        attacker_constraints = []
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                attacker_constraints.append(
                    And(tx.caller == ACTORS.attacker, tx.caller == tx.origin)
                )

        try:
            try:
                # strongest variant: attacker also receives the funds
                constraints = (
                    list(state.world_state.constraints)
                    + [to == ACTORS.attacker]
                    + attacker_constraints
                )
                transaction_sequence = solver.get_transaction_sequence(
                    state, constraints
                )
                description_tail = (
                    DESCRIPTION_TAIL
                    + " The attacker controls the beneficiary address."
                )
            except UnsatError:
                constraints = (
                    list(state.world_state.constraints) + attacker_constraints
                )
                transaction_sequence = solver.get_transaction_sequence(
                    state, constraints
                )
                description_tail = DESCRIPTION_TAIL
        except (UnsatError, SolverTimeOutException):
            log.debug("no model found for SELFDESTRUCT reachability")
            return []

        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=instruction.address,
            swc_id=UNPROTECTED_SELFDESTRUCT,
            title="Unprotected Selfdestruct",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head=DESCRIPTION_HEAD,
            description_tail=description_tail,
            transaction_sequence=transaction_sequence,
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
        )
        state.annotate(
            IssueAnnotation(
                conditions=[And(*constraints)], issue=issue, detector=self
            )
        )
        return [issue]
