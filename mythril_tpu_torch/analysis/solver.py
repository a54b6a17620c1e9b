"""Exploit concretization (reference mythril/analysis/solver.py:257).

get_transaction_sequence turns a SAT path into a concrete attack: solve the
path + issue constraints while minimizing calldata sizes and call values
(reference :217-257), then extract per-transaction concrete inputs from the
model (reference :185-214)."""

import logging
from typing import Dict, List

from mythril_tpu_torch.laser.state.constraints import Constraints
from mythril_tpu_torch.laser.transaction.models import (
    BaseTransaction,
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import ULE, symbol_factory
from mythril_tpu_torch.smt.solver.frontend import UnsatError  # noqa: F401 (re-export)
from mythril_tpu_torch.support.model import get_model

log = logging.getLogger(__name__)

MAX_CALLDATA_SIZE = 5000


def pretty_print_model(model) -> str:
    lines = []
    for name in sorted(str(d) for d in model.decls()):
        lines.append(f"{name}: {model.assignment.get(name)}")
    return "\n".join(lines)


def get_transaction_sequence(global_state, constraints: Constraints) -> Dict:
    """Solve constraints and concretize the tx sequence; raises UnsatError.

    Runs in a detection context: an UNSAT here is a detection-critical "no
    exploit" verdict (module predicates, potential-issue confirmation), so
    get_model requests the permuted-instance crosscheck by default."""
    from mythril_tpu_torch.support.model import detection_context

    transaction_sequence = global_state.world_state.transaction_sequence

    tx_constraints, minimize = _set_minimisation_constraints(
        transaction_sequence,
        Constraints(list(constraints)),
    )
    with detection_context():
        model = get_model(
            tx_constraints.get_all_constraints()
            if isinstance(tx_constraints, Constraints)
            else tx_constraints,
            minimize=minimize,
        )

    steps = []
    initial_accounts = {}
    for transaction in transaction_sequence:
        concrete = _get_concrete_transaction(model, transaction)
        steps.append(concrete)
    # initial world state snapshot (reference :168-182)
    first_tx = transaction_sequence[0] if transaction_sequence else None
    if first_tx is not None:
        world = (
            first_tx.prev_world_state
            if isinstance(first_tx, ContractCreationTransaction)
            and first_tx.prev_world_state is not None
            else first_tx.world_state
        )
        for address, account in world.accounts.items():
            initial_accounts[f"0x{address:040x}"] = {
                "nonce": account.nonce,
                "code": account.serialised_code,
                "storage": {
                    str(k): str(v) for k, v in account.storage.printable_storage.items()
                },
                "balance": "0x0",
            }
    return {
        "initialState": {"accounts": initial_accounts},
        "steps": steps,
    }


def _get_concrete_transaction(model, transaction: BaseTransaction) -> Dict:
    caller = f"0x{model.eval_int(transaction.caller):040x}"
    value = hex(model.eval_int(transaction.call_value))
    if isinstance(transaction, ContractCreationTransaction):
        from mythril_tpu_torch.disasm.disassembly import _concrete_projection

        address = ""
        input_data = _concrete_projection(transaction.code.bytecode).hex()
    else:
        callee = transaction.callee_account.address
        address = f"0x{model.eval_int(callee):040x}"
        calldata_bytes = transaction.call_data.concrete(model)
        input_data = bytes(
            byte if isinstance(byte, int) else 0 for byte in calldata_bytes
        ).hex()
    return {
        "origin": caller,
        "address": address,
        "input": f"0x{input_data}",
        "value": value,
        "name": getattr(transaction, "contract_name", "") or "unknown",
    }


def _set_minimisation_constraints(transaction_sequence, constraints):
    """Cap + minimize calldata size and value (reference :217-257)."""
    minimize = []
    for transaction in transaction_sequence:
        if transaction.call_data is not None and hasattr(
            transaction.call_data, "calldatasize"
        ):
            size = transaction.call_data.calldatasize
            if size.symbolic:
                constraints.append(
                    ULE(size, symbol_factory.BitVecVal(MAX_CALLDATA_SIZE, 256))
                )
                minimize.append(size)
        if transaction.call_value is not None and transaction.call_value.symbolic:
            minimize.append(transaction.call_value)
    return constraints, tuple(minimize)
