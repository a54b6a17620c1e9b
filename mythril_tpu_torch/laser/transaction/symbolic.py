"""Symbolic transaction setup (reference laser/ethereum/transaction/symbolic.py).

ACTORS are the well-known analysis addresses (creator/attacker/someguy);
execute_message_call drains open world states and seeds the worklist with a
fully symbolic tx per state, constraining caller ∈ ACTORS (reference
:214-216)."""

from typing import List, Optional

from mythril_tpu_torch.laser.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.laser.transaction.models import (
    ContractCreationTransaction,
    MessageCallTransaction,
)
from mythril_tpu_torch.smt import Or, symbol_factory

CREATOR_ADDRESS = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE
ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
SOMEGUY_ADDRESS = 0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA


class Actors:
    def __init__(self):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(CREATOR_ADDRESS, 256),
            "ATTACKER": symbol_factory.BitVecVal(ATTACKER_ADDRESS, 256),
            "SOMEGUY": symbol_factory.BitVecVal(SOMEGUY_ADDRESS, 256),
        }

    @property
    def creator(self):
        return self.addresses["CREATOR"]

    @property
    def attacker(self):
        return self.addresses["ATTACKER"]

    @property
    def someguy(self):
        return self.addresses["SOMEGUY"]

    def __getitem__(self, item):
        return self.addresses[item]


ACTORS = Actors()


def generate_function_constraints(calldata, func_hashes: List[bytes]):
    """Constrain the 4-byte selector when --transaction-sequences pins
    functions (reference symbolic.py:74-100)."""
    if not func_hashes:
        return []
    constraints = []
    options = []
    for func_hash in func_hashes:
        if func_hash == -1:  # fallback: calldatasize < 4
            options.append(calldata.calldatasize < 4)
        else:
            selector = int.from_bytes(func_hash, "big") if isinstance(
                func_hash, bytes
            ) else func_hash
            word = calldata.get_word_at(0)
            from mythril_tpu_torch.smt import Extract

            options.append(
                Extract(255, 224, word)
                == symbol_factory.BitVecVal(selector, 32)
            )
    constraints.append(Or(*options))
    return constraints


def execute_message_call(laser_evm, callee_address, func_hashes=None) -> None:
    """One fully symbolic message call per open world state
    (reference :103-148)."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    for world_state in open_states:
        if callee_address.symbolic is False and (
            callee_address.concrete_value not in world_state.accounts
        ):
            continue
        transaction = build_message_call_transaction(
            world_state, callee_address, func_hashes
        )
        _setup_global_state_for_execution(laser_evm, transaction)
    laser_evm.exec()


def build_message_call_transaction(world_state: WorldState, callee_address,
                                   func_hashes=None):
    callee_account = world_state.accounts_exist_or_load(callee_address)
    tx = MessageCallTransaction(
        world_state=world_state,
        callee_account=callee_account,
        caller=symbol_factory.BitVecSym("sender", 256),  # renamed per-tx below
        call_data=None,
        init_call_data=False,
    )
    tx.caller = symbol_factory.BitVecSym(f"sender_{tx.id}", 256)
    tx.call_data = SymbolicCalldata(tx.id)
    tx.origin = tx.caller  # analysis assumption: EOA caller (origin==caller)
    tx.func_hashes = func_hashes
    return tx


def execute_contract_creation(
    laser_evm,
    contract_initialization_code,
    contract_name=None,
    world_state: Optional[WorldState] = None,
) -> "Account":
    """Symbolic creation tx from the CREATOR actor (reference :151-196)."""
    from mythril_tpu_torch.disasm import Disassembly

    world_state = world_state or WorldState()
    open_states = [world_state]
    del laser_evm.open_states[:]
    new_account = None
    for open_world_state in open_states:
        prev_world_state = open_world_state.clone()
        code_bytes = (
            bytes.fromhex(contract_initialization_code.replace("0x", ""))
            if isinstance(contract_initialization_code, str)
            else contract_initialization_code
        )
        # split off constructor arguments appended after the init code
        account = open_world_state.create_account(
            address=None,
            concrete_storage=True,
            creator=None,
        )
        account.contract_name = contract_name or account.contract_name
        tx = ContractCreationTransaction(
            world_state=open_world_state,
            callee_account=account,
            caller=ACTORS.creator,
            origin=ACTORS.creator,
            code=Disassembly(code_bytes),
            # symbolic calldata on purpose — constructor args live past the
            # init code and are modelled via CODESIZE/CODECOPY special cases
            # (reference symbolic.py:173-175)
            call_data=None,
            gas_price=None,
            call_value=symbol_factory.BitVecSym("creation_value", 256),
            prev_world_state=prev_world_state,
            contract_name=contract_name,
        )
        _setup_global_state_for_execution(laser_evm, tx)
        new_account = account
    laser_evm.exec(True)
    return new_account


def _setup_global_state_for_execution(laser_evm, transaction) -> None:
    """Seed the worklist with the tx's initial state (reference :199-230)."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    # caller is one of the analysis actors
    if isinstance(transaction, MessageCallTransaction):
        global_state.world_state.constraints.append(
            Or(
                transaction.caller == ACTORS.creator,
                transaction.caller == ACTORS.attacker,
                transaction.caller == ACTORS.someguy,
            )
        )
        func_hashes = getattr(transaction, "func_hashes", None)
        if func_hashes:
            for constraint in generate_function_constraints(
                transaction.call_data, func_hashes
            ):
                global_state.world_state.constraints.append(constraint)
    global_state.world_state.transaction_sequence.append(transaction)
    global_state.node = laser_evm.new_node(
        transaction, global_state.world_state.constraints
    )
    laser_evm.work_list.append(global_state)
