"""PredictableVariables — SWC-116/120 branch depends on block env values
(reference analysis/module/modules/dependence_on_predictable_vars.py:196)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)

PREDICTABLE_OPS = ["COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER",
                   "PREVRANDAO", "BLOCKHASH"]


class PredictableValueAnnotation:
    def __init__(self, operation: str):
        self.operation = operation


class PredictableVariables(DetectionModule):
    name = "predictable_variables"
    swc_id = f"{TIMESTAMP_DEPENDENCE}, {WEAK_RANDOMNESS}"
    description = "Control flow depends on predictable block values."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = PREDICTABLE_OPS
    # JUMPI is only a taint OBSERVER: no issue without a predictable-value
    # source opcode executing first
    trigger_opcodes = PREDICTABLE_OPS

    def _analyze_state(self, state):
        if not self.is_prehook:
            # post-hook on env opcode: annotate the pushed value
            if state.mstate.stack:
                state.mstate.stack[-1].annotate(
                    PredictableValueAnnotation(self.current_opcode)
                )
            return []
        condition = state.mstate.stack[-2]
        markers = [
            a for a in condition.annotations
            if isinstance(a, PredictableValueAnnotation)
        ]
        if not markers:
            return []
        operation = markers[0].operation
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except (UnsatError, SolverTimeOutException):
            return []
        except Exception:
            return []
        swc_id = (
            TIMESTAMP_DEPENDENCE
            if operation == "TIMESTAMP"
            else WEAK_RANDOMNESS
        )
        pretty = operation.lower()
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction().address,
                swc_id=swc_id,
                title="Dependence on predictable environment variable",
                severity="Low",
                bytecode=state.environment.code.bytecode,
                description_head=(
                    "A control flow decision is made based on "
                    f"block.{pretty}."
                ),
                description_tail=(
                    f"The block.{pretty} environment variable is used to "
                    "determine a control flow decision. Note that the values "
                    "of variables like coinbase, gaslimit, block number and "
                    "timestamp are predictable and can be manipulated by a "
                    "malicious miner. Also keep in mind that attackers know "
                    "hashes of earlier blocks. Don't use any of those "
                    "environment variables as sources of randomness and be "
                    "aware that use of these variables introduces a certain "
                    "level of trust into miners."
                ),
                transaction_sequence=transaction_sequence,
            )
        ]
