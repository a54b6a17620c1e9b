"""Concrete-value transaction setup (reference
laser/ethereum/transaction/concolic.py:172).

Used by the VMTests conformance harness and concolic mode: all tx fields
(caller, calldata, value, gas) are concrete. Unlike the symbolic setup,
NO caller-in-ACTORS constraint is added — replayed transactions come from
arbitrary recorded senders (reference concolic.py:123-149 has its own
_setup_global_state_for_execution without the actor disjunction)."""

from typing import List, Optional

from mythril_tpu_torch.laser.state.calldata import BasicConcreteCalldata
from mythril_tpu_torch.laser.transaction.models import MessageCallTransaction
from mythril_tpu_torch.smt import symbol_factory


def _setup_concrete_state_for_execution(laser_evm, transaction) -> None:
    """Seed the worklist WITHOUT the symbolic actor constraint. A concrete
    transaction.block_number pins NUMBER (replayed transactions come from a
    known block — this is what makes the BlockNumberDynamicJump*
    conformance vectors executable, where the jump target derives from
    NUMBER); inner frames inherit it in svm._start_inner_transaction."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    global_state.world_state.transaction_sequence.append(transaction)
    global_state.node = laser_evm.new_node(
        transaction, global_state.world_state.constraints
    )
    laser_evm.work_list.append(global_state)


def execute_transaction(
    laser_evm,
    callee_address,
    caller_address,
    data: Optional[List[int]] = None,
    gas_price: int = 10,
    gas_limit: int = 8_000_000,
    value: int = 0,
    origin_address=None,
    code=None,
    track_gas: bool = False,
    block_number=None,
):
    """Seed and run one concrete message call on every open world state."""
    if isinstance(callee_address, int):
        callee_address = symbol_factory.BitVecVal(callee_address, 256)
    if isinstance(caller_address, int):
        caller_address = symbol_factory.BitVecVal(caller_address, 256)
    if origin_address is None:
        origin_address = caller_address
    elif isinstance(origin_address, int):
        origin_address = symbol_factory.BitVecVal(origin_address, 256)
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    for world_state in open_states:
        callee_account = world_state.accounts_exist_or_load(callee_address)
        tx_code = callee_account.code
        if code is not None:
            from mythril_tpu_torch.disasm import Disassembly

            tx_code = code if isinstance(code, Disassembly) else Disassembly(code)
        transaction = MessageCallTransaction(
            world_state=world_state,
            callee_account=callee_account,
            caller=caller_address,
            call_data=BasicConcreteCalldata("concrete", list(data or [])),
            gas_price=symbol_factory.BitVecVal(gas_price, 256),
            gas_limit=gas_limit,
            origin=origin_address,
            code=tx_code,
            call_value=symbol_factory.BitVecVal(value, 256),
            block_number=block_number,
        )
        _setup_concrete_state_for_execution(laser_evm, transaction)
    return laser_evm.exec(track_gas=track_gas)


def execute_message_call(
    laser_evm,
    callee_address,
    caller_address,
    origin_address,
    data,
    gas_limit,
    gas_price,
    value,
    code=None,
    track_gas=False,
    block_number=None,
):
    """Reference-shaped alias (concolic.py:73) used by the VMTests harness."""
    return execute_transaction(
        laser_evm,
        callee_address,
        caller_address,
        data=list(data),
        gas_price=gas_price,
        gas_limit=gas_limit,
        value=value,
        origin_address=origin_address,
        code=code,
        track_gas=track_gas,
        block_number=block_number,
    )
