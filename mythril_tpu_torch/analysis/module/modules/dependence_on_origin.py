"""TxOrigin — SWC-115 branch condition tainted by ORIGIN
(reference analysis/module/modules/dependence_on_origin.py:114)."""

import logging
from typing import List

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import TX_ORIGIN_USAGE
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class TxOriginAnnotation:
    """Marker attached to the ORIGIN value (taint via expression annotations)."""


class TxOrigin(DetectionModule):
    name = "tx_origin"
    swc_id = TX_ORIGIN_USAGE
    description = "Control flow depends on tx.origin."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]
    # JUMPI is only a taint OBSERVER: no issue without ORIGIN executing
    trigger_opcodes = ["ORIGIN"]

    def _analyze_state(self, state) -> List[Issue]:
        if self.current_opcode == "ORIGIN":
            # post-hook: annotate the pushed value
            state.mstate.stack[-1].annotate(TxOriginAnnotation())
            return []
        instruction = state.get_current_instruction()
        # JUMPI pre-hook: check the branch condition for the taint marker
        condition = state.mstate.stack[-2]
        if not any(
            isinstance(a, TxOriginAnnotation) for a in condition.annotations
        ):
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except (UnsatError, SolverTimeOutException):
            return []
        except Exception:
            return []
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=instruction.address,
                swc_id=TX_ORIGIN_USAGE,
                title="Dependence on tx.origin",
                severity="Low",
                bytecode=state.environment.code.bytecode,
                description_head="Use of tx.origin as a part of authorization control.",
                description_tail=(
                    "The tx.origin environment variable has been found to "
                    "influence a control flow decision. Note that using "
                    "tx.origin as a security control might cause a situation "
                    "where a user inadvertently authorizes a smart contract "
                    "to perform an action on their behalf. It is recommended "
                    "to use msg.sender instead."
                ),
                transaction_sequence=transaction_sequence,
            )
        ]
