"""CALL/CALLCODE/DELEGATECALL/STATICCALL/CREATE/CREATE2 semantics
(reference laser/ethereum/instructions.py:1719-2470 + call.py).

Call frames are pushed by raising TransactionStartSignal; the engine pops
them on TransactionEndSignal and resumes the caller via the return context
stored on the transaction (svm._end_message_call in the reference re-runs
the call op in "post" mode; here the context travels with the signal)."""

from typing import List, Optional, Tuple

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser import natives
from mythril_tpu_torch.laser.cheat_code import is_cheat_address
from mythril_tpu_torch.laser.evm_exceptions import VmException, WriteProtection
from mythril_tpu_torch.laser.instructions import (
    advance,
    bv,
    concrete_or_none,
    concretize,
    op,
)
from mythril_tpu_torch.laser.state.calldata import BasicConcreteCalldata, BaseCalldata
from mythril_tpu_torch.laser.state.global_state import GlobalState
from mythril_tpu_torch.laser.state.return_data import ReturnData
from mythril_tpu_torch.laser.transaction.models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionStartSignal,
)
from mythril_tpu_torch.smt import UGE, symbol_factory

GAS_CALLSTIPEND = 2300
SYMBOLIC_CALLDATA_SIZE = 320  # bound for unconstrained inner calldata


class CallReturnContext:
    """Where to resume + where to write return data in the caller frame."""

    def __init__(self, global_state: GlobalState, memory_out_offset,
                 memory_out_size, op_name: str):
        self.global_state = global_state
        self.memory_out_offset = memory_out_offset
        self.memory_out_size = memory_out_size
        self.op_name = op_name


def _read_calldata_from_memory(global_state, mem_offset, mem_size):
    size_c = concrete_or_none(mem_size)
    if size_c is None:
        size_c = min(
            concretize(global_state, mem_size, "call_data_size"),
            SYMBOLIC_CALLDATA_SIZE,
        )
    offset_c = concrete_or_none(mem_offset)
    if offset_c is None and size_c:
        offset_c = concretize(global_state, mem_offset, "call_data_offset")
    data = [
        global_state.mstate.memory.get_byte(offset_c + i) for i in range(size_c)
    ]
    return data, size_c


def _call_family(global_state: GlobalState, op_name: str):
    stack = global_state.mstate.stack
    gas = stack.pop()
    to = stack.pop()
    if op_name in ("CALL", "CALLCODE"):
        value = stack.pop()
    else:
        value = bv(0)
    in_offset = stack.pop()
    in_size = stack.pop()
    out_offset = stack.pop()
    out_size = stack.pop()

    if op_name == "CALL" and global_state.environment.static:
        value_c = concrete_or_none(value)
        if value_c is None or value_c != 0:
            raise WriteProtection("CALL with value inside STATICCALL")

    environment = global_state.environment
    world_state = global_state.world_state
    to_concrete = concrete_or_none(to)

    # inner-call depth limit (reference call_depth_limiter plugin, default 3):
    # beyond the limit the callee is not executed, result is unconstrained
    from mythril_tpu_torch.support.args import args as _args

    inner_depth = sum(
        1 for _tx, snapshot in global_state.transaction_stack if snapshot is not None
    )
    if inner_depth >= _args.call_depth_limit:
        global_state.last_return_data = _symbolic_return_data(global_state)
        stack.append(
            global_state.new_bitvec(f"retval_depthcap_{global_state.mstate.pc}", 256)
        )
        return advance(global_state)

    # cheat-code address: stub success
    if to_concrete is not None and is_cheat_address(to_concrete):
        global_state.last_return_data = ReturnData([], 0)
        stack.append(bv(1))
        return advance(global_state)

    call_data_bytes, _size = _read_calldata_from_memory(
        global_state, in_offset, in_size
    )

    # precompiles execute natively
    if to_concrete is not None and 1 <= to_concrete <= natives.PRECOMPILE_COUNT:
        return _native_call(
            global_state, to_concrete, call_data_bytes, out_offset, out_size
        )

    # only use accounts we actually know about — materializing an empty
    # account here would make a later EXTCODESIZE concretely 0, where the
    # reference models unknown-address code as symbolic absent on-chain
    # data (reference world_state.py accounts_exist_or_load raises without
    # a dynamic loader and callers go symbolic)
    callee_account = None
    if to_concrete is not None:
        callee_account = world_state.accounts.get(to_concrete)

    if (
        callee_account is None
        or len(callee_account.code.bytecode) == 0
    ):
        # unknown or codeless target: value transfer + symbolic result
        if op_name in ("CALL", "CALLCODE"):
            _apply_value_transfer(global_state, environment.address, to, value)
        return_value = global_state.new_bitvec(
            f"retval_{global_state.mstate.pc}", 256
        )
        global_state.last_return_data = _symbolic_return_data(global_state)
        stack.append(return_value)
        # both outcomes possible; keep it symbolic (modules constrain it)
        return advance(global_state)

    # real inner transaction
    caller = environment.address
    callee_address = to
    if op_name == "DELEGATECALL":
        tx = MessageCallTransaction(
            world_state=world_state,
            callee_account=environment.active_account,
            caller=environment.sender,
            call_data=BasicConcreteCalldata("delegate", []),
            origin=environment.origin,
            code=callee_account.code,
            call_value=environment.callvalue,
            static=environment.static,
        )
    elif op_name == "CALLCODE":
        tx = MessageCallTransaction(
            world_state=world_state,
            callee_account=environment.active_account,
            caller=caller,
            origin=environment.origin,
            code=callee_account.code,
            call_value=value,
            static=environment.static,
        )
    else:
        tx = MessageCallTransaction(
            world_state=world_state,
            callee_account=callee_account,
            caller=caller,
            origin=environment.origin,
            code=callee_account.code,
            call_value=value,
            static=environment.static or op_name == "STATICCALL",
        )
    tx.call_data = BasicConcreteCalldata(tx.id, call_data_bytes)
    tx.return_context = CallReturnContext(
        global_state, out_offset, out_size, op_name
    )
    raise TransactionStartSignal(tx, op_name, global_state)


def _apply_value_transfer(global_state, sender, receiver, value):
    world_state = global_state.world_state
    world_state.constraints.append(UGE(world_state.balances[sender], value))
    world_state.balances[sender] = world_state.balances[sender] - value
    world_state.balances[receiver] = world_state.balances[receiver] + value


def _symbolic_return_data(global_state) -> ReturnData:
    size_sym = global_state.new_bitvec(
        f"returndatasize_{global_state.mstate.pc}", 256
    )
    data = [
        global_state.new_bitvec(f"returndata_{global_state.mstate.pc}_{i}", 8)
        for i in range(32)
    ]
    return ReturnData(data, size_sym)


def _native_call(global_state, precompile_address, call_data_bytes,
                 out_offset, out_size):
    stack = global_state.mstate.stack
    try:
        output = natives.native_contracts(precompile_address, call_data_bytes)
    except natives.NativeContractException:
        # symbolic input: unknown result
        global_state.last_return_data = _symbolic_return_data(global_state)
        stack.append(
            global_state.new_bitvec(f"native_{precompile_address}", 256)
        )
        return advance(global_state)
    _write_return_data(global_state, output, out_offset, out_size)
    global_state.last_return_data = ReturnData(list(output), len(output))
    stack.append(bv(1))
    return advance(global_state)


def _write_return_data(global_state, data, out_offset, out_size):
    offset_c = concrete_or_none(out_offset)
    size_c = concrete_or_none(out_size)
    if offset_c is None or size_c is None:
        return
    length = min(size_c, len(data))
    global_state.mstate.mem_extend(offset_c, length)
    for i in range(length):
        global_state.mstate.memory.write_byte(offset_c + i, data[i])


@op("CALL")
def call_(global_state):
    return _call_family(global_state, "CALL")


@op("CALLCODE")
def callcode_(global_state):
    return _call_family(global_state, "CALLCODE")


@op("DELEGATECALL")
def delegatecall_(global_state):
    return _call_family(global_state, "DELEGATECALL")


@op("STATICCALL")
def staticcall_(global_state):
    return _call_family(global_state, "STATICCALL")


# ---------------------------------------------------------------------------
# CREATE / CREATE2


def _create_family(global_state: GlobalState, op_name: str):
    stack = global_state.mstate.stack
    value = stack.pop()
    offset = stack.pop()
    length = stack.pop()
    salt = stack.pop() if op_name == "CREATE2" else None

    code_bytes_sym, size_c = _read_calldata_from_memory(
        global_state, offset, length
    )
    code_bytes = bytearray()
    for byte in code_bytes_sym:
        byte_c = concrete_or_none(byte)
        if byte_c is None:
            # symbolic init code: cannot execute; push symbolic address
            stack.append(global_state.new_bitvec("create_addr", 256))
            return advance(global_state)
        code_bytes.append(byte_c)

    world_state = global_state.world_state
    creator = global_state.environment.address
    creator_int = (
        creator.concrete_value if not creator.symbolic else None
    )
    if op_name == "CREATE2" and salt is not None:
        salt_c = concrete_or_none(salt)
        if salt_c is not None and creator_int is not None:
            from mythril_tpu_torch.utils.keccak import keccak256

            digest = keccak256(
                b"\xff"
                + creator_int.to_bytes(20, "big")
                + salt_c.to_bytes(32, "big")
                + keccak256(bytes(code_bytes))
            )
            new_address = int.from_bytes(digest[12:], "big")
        else:
            stack.append(global_state.new_bitvec("create2_addr", 256))
            return advance(global_state)
    else:
        new_address = None  # rlp-derived inside create_account

    account = world_state.create_account(
        address=new_address,
        concrete_storage=True,
        creator=creator_int,
    )
    if creator_int is not None and creator_int in world_state.accounts:
        world_state.accounts[creator_int].nonce += 1

    tx = ContractCreationTransaction(
        world_state=world_state,
        callee_account=account,
        caller=creator,
        origin=global_state.environment.origin,
        code=Disassembly(bytes(code_bytes)),
        call_value=value,
        prev_world_state=None,
    )
    tx.return_context = CallReturnContext(global_state, None, None, op_name)
    raise TransactionStartSignal(tx, op_name, global_state)


@op("CREATE")
def create_(global_state):
    return _create_family(global_state, "CREATE")


@op("CREATE2")
def create2_(global_state):
    return _create_family(global_state, "CREATE2")
