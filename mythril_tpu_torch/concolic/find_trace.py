"""Concrete replay pass: build the initial world state from the input json
and execute the recorded transactions with the TraceFinder plugin on
(reference mythril/concolic/find_trace.py:41-76)."""

import binascii
from copy import deepcopy
from typing import List, Tuple

from mythril_tpu_torch.concolic.concrete_data import ConcreteData
from mythril_tpu_torch.disasm.disassembly import Disassembly
from mythril_tpu_torch.laser.plugin.plugins.trace import TraceFinder
from mythril_tpu_torch.laser.state.account import Account
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.svm import LaserEVM
from mythril_tpu_torch.laser.transaction.concolic import execute_transaction
from mythril_tpu_torch.laser.transaction.models import tx_id_manager
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.time_handler import time_handler


def _to_int(value, default: int = 0) -> int:
    if value is None:
        return default
    if isinstance(value, int):
        return value
    return int(value, 16) if value.startswith("0x") else int(value)


def setup_concrete_initial_state(concrete_data: ConcreteData) -> WorldState:
    world_state = WorldState()
    for address, details in concrete_data["initialState"]["accounts"].items():
        code_hex = details.get("code", "0x")
        account = Account(
            int(address, 16),
            code=Disassembly(code_hex[2:] if code_hex.startswith("0x")
                             else code_hex),
            concrete_storage=True,
            nonce=details.get("nonce", 0),
        )
        world_state.put_account(account)
        storage = details.get("storage") or {}
        for key, value in storage.items():
            account.storage[symbol_factory.BitVecVal(_to_int(key), 256)] = \
                symbol_factory.BitVecVal(_to_int(value), 256)
        balance = _to_int(details.get("balance", 0))
        if balance:
            account.add_balance(symbol_factory.BitVecVal(balance, 256))
    return world_state


def concrete_execution(
    concrete_data: ConcreteData,
) -> Tuple[WorldState, List]:
    """Returns (initial world state, per-tx (pc, tx_id) trace)."""
    args.pruning_factor = 1
    tx_id_manager.restart_counter()
    init_state = setup_concrete_initial_state(concrete_data)
    laser_evm = LaserEVM(execution_timeout=1000)
    laser_evm.open_states = [deepcopy(init_state)]
    tracer = TraceFinder()
    tracer.initialize(laser_evm)
    time_handler.start_execution(laser_evm.execution_timeout)
    for transaction in concrete_data["steps"]:
        if transaction["address"] == "":
            # creation step (same shape runner.flip_branches handles)
            from mythril_tpu_torch.laser.transaction.symbolic import (
                execute_contract_creation,
            )

            for world_state in laser_evm.open_states[:]:
                execute_contract_creation(
                    laser_evm, transaction["input"][2:],
                    world_state=world_state,
                )
            continue
        execute_transaction(
            laser_evm,
            callee_address=_to_int(transaction["address"]),
            caller_address=_to_int(transaction["origin"]),
            data=list(binascii.a2b_hex(transaction["input"][2:])),
            gas_price=_to_int(transaction.get("gasPrice"), 0x773594000),
            gas_limit=_to_int(transaction.get("gasLimit"), 8_000_000),
            value=_to_int(transaction.get("value", 0)),
        )
    tx_id_manager.restart_counter()
    return init_state, tracer.tx_trace
