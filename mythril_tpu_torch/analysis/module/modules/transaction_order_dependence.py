"""TransactionOrderDependence — SWC-114 value transfer racing on storage
(reference analysis/module/modules/transaction_order_dependence.py:48-137).

Taint-annotation mechanism mirroring the reference: post-hooks on
SLOAD/BALANCE annotate the pushed value with the reading transaction's
sender; the annotation rides the engine's BitVec wrappers through any
arithmetic. At a CALL whose transfer value carries the taint, the payout
depends on balance/storage another transaction can change first —
front-running the write changes what the call pays out. (A post-hoc
statespace scan cannot detect this here: read-over-write elimination folds
`SLOAD(slot)` of a just-written slot into the written expression, so no
storage select survives in the value term.)"""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import TX_ORDER_DEPENDENCE
from mythril_tpu_torch.laser.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import Or, symbol_factory
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)


class BalanceAnnotation:
    def __init__(self, caller):
        self.caller = caller


class StorageAnnotation:
    def __init__(self, caller):
        self.caller = caller


class TxOrderDependence(DetectionModule):
    name = "tx_order_dependence"
    swc_id = TX_ORDER_DEPENDENCE
    description = "The call value depends on balance or storage writable by other transactions."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]
    post_hooks = ["BALANCE", "SLOAD"]
    # BALANCE/SLOAD only source taint; the issue itself fires at a CALL
    trigger_opcodes = ["CALL"]

    def _analyze_state(self, state):
        if not self.is_prehook:
            # post BALANCE/SLOAD: taint the pushed value with the sender
            if state.mstate.stack:
                value = state.mstate.stack[-1]
                annotation = (
                    BalanceAnnotation
                    if self.current_opcode == "BALANCE"
                    else StorageAnnotation
                )
                if not value.get_annotations(annotation):
                    value.annotate(annotation(state.environment.sender))
            return []

        value = state.mstate.stack[-3]
        # mirror the reference's gate exactly: a caller is harvested only
        # when EXACTLY ONE annotation of that type is present (reference
        # transaction_order_dependence.py appends iff len(annotations) == 1).
        # A value combining two differently-tainted reads (annotation-set
        # union through arithmetic) is suppressed — call_constraint stays
        # False -> UNSAT -> no report, matching the reference's findings.
        callers = []
        for annotation_type in (StorageAnnotation, BalanceAnnotation):
            annotations = value.get_annotations(annotation_type)
            if len(annotations) == 1:
                callers.append(annotations[0].caller)
        if not callers:
            return []
        call_constraint = symbol_factory.Bool(False)
        for caller in callers:
            call_constraint = Or(call_constraint, ACTORS.attacker == caller)
        constraints = [call_constraint]
        try:
            get_model(
                state.world_state.constraints.get_all_constraints()
                + constraints
            )
        except UnsatError:
            return []
        except Exception:
            return []
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=state.get_current_instruction().address,
            swc_id=TX_ORDER_DEPENDENCE,
            title="Transaction Order Dependence",
            severity="Medium",
            bytecode=state.environment.code.bytecode,
            description_head=(
                "The value of the call is dependent on balance or "
                "storage write"
            ),
            description_tail=(
                "This can lead to race conditions. An attacker may be "
                "able to run a transaction after our transaction which "
                "can change the value of the call, e.g. by front-running "
                "a storage write that determines the amount paid out."
            ),
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
