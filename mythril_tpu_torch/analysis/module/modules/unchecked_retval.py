"""UncheckedRetval — SWC-104 call return value never constrained
(reference analysis/module/modules/unchecked_retval.py:146)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import UNCHECKED_RET_VAL
from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class UncheckedRetvalAnnotation(StateAnnotation):
    def __init__(self):
        self.retvals = []  # [{"address": pc, "retval": BitVec}]

    def clone(self):
        dup = UncheckedRetvalAnnotation()
        dup.retvals = list(self.retvals)
        return dup


def _get_annotation(state) -> UncheckedRetvalAnnotation:
    for annotation in state.annotations:
        if isinstance(annotation, UncheckedRetvalAnnotation):
            return annotation
    annotation = UncheckedRetvalAnnotation()
    state.annotate(annotation)
    return annotation


class UncheckedRetval(DetectionModule):
    name = "unchecked_retval"
    swc_id = UNCHECKED_RET_VAL
    description = "Return value of an external call is not checked."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["RETURN", "STOP"]
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]
    # RETURN/STOP only read recorded retvals; no issue without a call
    trigger_opcodes = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _analyze_state(self, state):
        annotation = _get_annotation(state)
        if not self.is_prehook:
            # post-call: remember the pushed return value
            if state.mstate.stack:
                retval = state.mstate.stack[-1]
                if retval.symbolic:
                    annotation.retvals.append(
                        {"address": state.mstate.pc - 1, "retval": retval}
                    )
            return []
        # RETURN/STOP: a retval is "unchecked" if the path never constrained it
        issues = []
        for retval_record in annotation.retvals:
            retval = retval_record["retval"]
            try:
                # can the call have failed (retval == 0) on this very path?
                transaction_sequence = get_transaction_sequence(
                    state,
                    state.world_state.constraints + [retval == 0],
                )
                # and also succeeded? if both, nothing ever checked it
                get_transaction_sequence(
                    state,
                    state.world_state.constraints + [retval == 1],
                )
            except (UnsatError, SolverTimeOutException):
                continue
            except Exception:
                continue
            issues.append(
                Issue(
                    contract=state.environment.active_account.contract_name,
                    function_name=state.environment.active_function_name,
                    address=retval_record["address"],
                    swc_id=UNCHECKED_RET_VAL,
                    title="Unchecked return value from external call.",
                    severity="Medium",
                    bytecode=state.environment.code.bytecode,
                    description_head=(
                        "The return value of a message call is not checked."
                    ),
                    description_tail=(
                        "External calls return a boolean value. If the callee "
                        "halts with an exception, 'false' is returned and "
                        "execution continues in the caller. The caller should "
                        "check whether an exception happened and react "
                        "accordingly to avoid unexpected behavior. For example "
                        "it is often desirable to wrap external calls in "
                        "require() so the transaction is reverted if the call "
                        "fails."
                    ),
                    transaction_sequence=transaction_sequence,
                )
            )
        return issues
