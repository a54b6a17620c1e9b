"""MultipleSends — SWC-113 several external calls in one transaction
(reference analysis/module/modules/multiple_sends.py:107)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import MULTIPLE_SENDS
from mythril_tpu_torch.laser.state.annotation import StateAnnotation

log = logging.getLogger(__name__)


class MultipleSendsAnnotation(StateAnnotation):
    def __init__(self):
        self.call_offsets = []

    def clone(self):
        dup = MultipleSendsAnnotation()
        dup.call_offsets = list(self.call_offsets)
        return dup


def _get_annotation(state) -> MultipleSendsAnnotation:
    for annotation in state.annotations:
        if isinstance(annotation, MultipleSendsAnnotation):
            return annotation
    annotation = MultipleSendsAnnotation()
    state.annotate(annotation)
    return annotation


class MultipleSends(DetectionModule):
    name = "multiple_sends"
    swc_id = MULTIPLE_SENDS
    description = "Multiple external calls in the same transaction."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE",
                 "RETURN", "STOP"]
    # RETURN/STOP only report calls already recorded on the path
    trigger_opcodes = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _analyze_state(self, state):
        annotation = _get_annotation(state)
        opcode = self.current_opcode
        if opcode in ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"):
            annotation.call_offsets.append(
                state.get_current_instruction().address
            )
            return []
        # RETURN/STOP: report if more than one call happened on this path
        if len(annotation.call_offsets) < 2:
            return []
        offset = annotation.call_offsets[1]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=state.environment.active_function_name,
            address=offset,
            swc_id=MULTIPLE_SENDS,
            title="Multiple Calls in a Single Transaction",
            severity="Low",
            bytecode=state.environment.code.bytecode,
            description_head=(
                "Multiple calls are executed in the same transaction."
            ),
            description_tail=(
                "This call is executed following another call within the same "
                "transaction. It is possible that the call never gets executed "
                "if a prior call fails permanently. This might be caused "
                "intentionally by a malicious callee. If possible, refactor "
                "the code such that each transaction only executes one "
                "external call or make sure that all callees can be trusted "
                "(i.e. they're part of your own codebase)."
            ),
            constraints=[],
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue
        )
        return []
