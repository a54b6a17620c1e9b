"""UnexpectedEther — SWC-132 strict balance equality broken by forced ether
(reference analysis/module/modules/unexpected_ether.py:143, POST entry)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import UNEXPECTED_ETHER_BALANCE
from mythril_tpu_torch.smt import terms as _terms
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


def _condition_tests_balance_equality(condition_term, balance_array_names):
    """True if the term contains EQ over a select on a balance array."""
    for node in _terms.walk_terms([condition_term]):
        if node.op != "eq":
            continue
        for child in node.children:
            for sub in _terms.walk_terms([child]):
                if sub.op == "select" and sub.children[0].op == "array":
                    if sub.children[0].params[0] in balance_array_names:
                        return True
    return False


class UnexpectedEther(DetectionModule):
    name = "unexpected_ether"
    swc_id = UNEXPECTED_ETHER_BALANCE
    description = "Strict balance equality can be broken by forcibly sending ether."
    entry_point = EntryPoint.POST

    def _analyze_statespace(self, statespace) -> list:
        issues = []
        seen = set()
        for node in statespace.nodes.values():
            for state in node.states:
                instruction = state.get_current_instruction()
                if instruction is None or instruction.opcode != "JUMPI":
                    continue
                key = (
                    instruction.address,
                    "0x" + state.environment.code.bytecode_hash.hex(),
                )
                if key in seen or key in self.cache:
                    continue
                stack = (
                    state.mstate_stack
                    if hasattr(state, "mstate_stack")
                    else state.mstate.stack
                )
                if len(stack) < 2:
                    continue
                condition = stack[-2]
                if condition.symbolic is False:
                    continue
                # base balance array name under any store chain
                base = state.world_state.balances.raw
                while base.op == "store":
                    base = base.children[0]
                if base.op != "array":
                    continue
                if not _condition_tests_balance_equality(
                    condition.raw, {base.params[0]}
                ):
                    continue
                try:
                    transaction_sequence = get_transaction_sequence(
                        state, state.constraints
                    )
                except (UnsatError, SolverTimeOutException, AttributeError):
                    continue
                except Exception:
                    continue
                seen.add(key)
                issues.append(
                    Issue(
                        contract=state.environment.active_account.contract_name,
                        function_name=state.environment.active_function_name,
                        address=instruction.address,
                        swc_id=UNEXPECTED_ETHER_BALANCE,
                        title="Dependence on the balance of the contract",
                        severity="Medium",
                        bytecode=state.environment.code.bytecode,
                        description_head=(
                            "A control flow decision depends on "
                            "a strict check of the contract balance."
                        ),
                        description_tail=(
                            "A branch condition tests the exact balance of "
                            "the contract account. Since ether can be "
                            "forcibly sent to any account (e.g. via "
                            "selfdestruct or as a block reward recipient), "
                            "strict equality checks on the balance can be "
                            "broken by an attacker and should be avoided."
                        ),
                        transaction_sequence=transaction_sequence,
                    )
                )
        return issues
