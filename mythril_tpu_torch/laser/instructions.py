"""EVM instruction semantics over symbolic state.

Behavioral parity with reference mythril/laser/ethereum/instructions.py
(2.5k LoC, class Instruction with one method per opcode); re-designed as a
dispatch table of handler functions. Each handler mutates the incoming
GlobalState (single-ownership worklist discipline; forks clone explicitly)
and returns the successor list. The engine owns pre/post hooks, stack-arity
checks, and signal handling (svm.py).

Conventions: stack top first. All 256-bit. `/`, `%`, `<`, `>` on BitVec are
UNSIGNED (EVM semantics; see smt/bitvec.py docstring).
"""

from typing import Callable, Dict, List

from mythril_tpu_torch.laser.evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    VmException,
    WriteProtection,
)
from mythril_tpu_torch.laser.function_managers import (
    exponent_function_manager,
    keccak_function_manager,
)
from mythril_tpu_torch.laser.state.global_state import GlobalState
from mythril_tpu_torch.laser.state.return_data import ReturnData
from mythril_tpu_torch.smt import (
    AShR,
    BitVec,
    Bool,
    Concat,
    Extract,
    If,
    LShR,
    Not,
    SDiv,
    SignExt,
    SRem,
    UDiv,
    UGE,
    UGT,
    ULT,
    URem,
    ZeroExt,
    is_false,
    is_true,
    simplify,
    symbol_factory,
)
from mythril_tpu_torch.support.opcodes import BY_NAME

HANDLERS: Dict[str, Callable] = {}

TT256 = 2 ** 256
TT256M1 = 2 ** 256 - 1

STATE_MODIFYING_OPS = frozenset(
    ["SSTORE", "CREATE", "CREATE2", "SELFDESTRUCT", "TSTORE",
     "LOG0", "LOG1", "LOG2", "LOG3", "LOG4"]
)


def op(*names):
    def register(func):
        for name in names:
            HANDLERS[name] = func
        return func

    return register


def bv(value: int) -> BitVec:
    return symbol_factory.BitVecVal(value, 256)


def bool_to_bv(condition: Bool) -> BitVec:
    return If(condition, bv(1), bv(0))


def concrete_or_none(value: BitVec):
    value = simplify(value)
    return value.concrete_value if not value.symbolic else None


def concretize(global_state: GlobalState, value: BitVec, name: str) -> int:
    """Force a concrete value via the solver (pins it with a constraint).

    An UNSAT path (or solver timeout) must kill THIS path, not the whole
    exploration — raise a VmException so execute_state retires the state
    like any other exceptional halt."""
    value = simplify(value)
    if not value.symbolic:
        return value.concrete_value
    from mythril_tpu_torch.smt.solver.frontend import (
        SolverTimeOutException,
        UnsatError,
    )
    from mythril_tpu_torch.support.model import get_model

    try:
        model = get_model(
            global_state.world_state.constraints.get_all_constraints()
        )
    except UnsatError:
        raise VmException(f"infeasible path at {name} concretization") \
            from None
    except SolverTimeOutException:
        raise VmException(f"solver timeout at {name} concretization") \
            from None
    concrete = model.eval_int(value)
    global_state.world_state.constraints.append(value == bv(concrete))
    return concrete


def execute(global_state: GlobalState, instr) -> List[GlobalState]:
    """Run one instruction. Raises Transaction*Signal / VmException."""
    name = instr.opcode
    spec = BY_NAME.get(name)
    if spec is None:
        raise InvalidInstruction(f"invalid opcode 0x{instr.byte:02x}")
    if global_state.environment.static and name in STATE_MODIFYING_OPS:
        raise WriteProtection(f"{name} inside STATICCALL")

    if name.startswith("PUSH"):
        states = _push(global_state, instr)
    elif name.startswith("DUP"):
        states = _dup(global_state, int(name[3:]))
    elif name.startswith("SWAP"):
        states = _swap(global_state, int(name[4:]))
    elif name.startswith("LOG"):
        states = _log(global_state, int(name[3:]))
    else:
        handler = HANDLERS.get(name)
        if handler is None:
            raise InvalidInstruction(f"unimplemented opcode {name}")
        states = handler(global_state)
    # opcode gas accrues on the states the handler RETURNED — halting ops
    # (STOP/RETURN/SELFDESTRUCT) raise a signal and never charge their own
    # cost, matching reference StateTransition.accumulate_gas
    # (instructions.py:163-172 runs after the handler)
    for state in states:
        state.mstate.min_gas_used += spec.gas_min
        state.mstate.max_gas_used += spec.gas_max
        state.mstate.check_gas()
    return states


def advance(global_state: GlobalState) -> List[GlobalState]:
    global_state.mstate.pc += 1
    return [global_state]


# ---------------------------------------------------------------------------
# stack ops


def _push(global_state: GlobalState, instr) -> List[GlobalState]:
    value = instr.argument_int if instr.argument is not None else 0
    if value is None:
        # symbolic operand (deploy-time-patched immutable): concat the
        # byte entries big-endian (reference instructions.py push_ tuple arm)
        parts = [
            symbol_factory.BitVecVal(b, 8) if isinstance(b, int) else b
            for b in instr.argument
        ]
        word = Concat(parts) if len(parts) > 1 else parts[0]
        if word.size < 256:
            word = Concat([symbol_factory.BitVecVal(0, 256 - word.size), word])
        global_state.mstate.stack.append(simplify(word))
    else:
        global_state.mstate.stack.append(bv(value))
    width = len(instr.argument) if instr.argument is not None else 0
    global_state.mstate.pc += 1 + width
    return [global_state]


def _dup(global_state: GlobalState, depth: int) -> List[GlobalState]:
    stack = global_state.mstate.stack
    if len(stack) < depth:
        raise VmException(f"DUP{depth} on stack of {len(stack)}")
    stack.append(stack[-depth])
    return advance(global_state)


def _swap(global_state: GlobalState, depth: int) -> List[GlobalState]:
    stack = global_state.mstate.stack
    if len(stack) < depth + 1:
        raise VmException(f"SWAP{depth} on stack of {len(stack)}")
    stack[-1], stack[-depth - 1] = stack[-depth - 1], stack[-1]
    return advance(global_state)


def _log(global_state: GlobalState, topics: int) -> List[GlobalState]:
    global_state.mstate.pop(2 + topics)
    return advance(global_state)


@op("POP")
def pop_(global_state):
    global_state.mstate.pop()
    return advance(global_state)


# ---------------------------------------------------------------------------
# arithmetic


@op("ADD")
def add_(global_state):
    s = global_state.mstate.stack
    s.append(s.pop() + s.pop())
    return advance(global_state)


@op("SUB")
def sub_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(a - b)
    return advance(global_state)


@op("MUL")
def mul_(global_state):
    s = global_state.mstate.stack
    s.append(s.pop() * s.pop())
    return advance(global_state)


@op("DIV")
def div_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(UDiv(a, b))
    return advance(global_state)


@op("SDIV")
def sdiv_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(SDiv(a, b))
    return advance(global_state)


@op("MOD")
def mod_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(URem(a, b))
    return advance(global_state)


@op("SMOD")
def smod_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(SRem(a, b))
    return advance(global_state)


@op("ADDMOD")
def addmod_(global_state):
    s = global_state.mstate.stack
    a, b, modulus = s.pop(), s.pop(), s.pop()
    # intermediate sum is NOT truncated to 256 bits
    wide = ZeroExt(1, a) + ZeroExt(1, b)
    result = URem(wide, ZeroExt(1, modulus))
    s.append(Extract(255, 0, result))
    return advance(global_state)


@op("MULMOD")
def mulmod_(global_state):
    s = global_state.mstate.stack
    a, b, modulus = s.pop(), s.pop(), s.pop()
    wide = ZeroExt(256, a) * ZeroExt(256, b)
    result = URem(wide, ZeroExt(256, modulus))
    s.append(Extract(255, 0, result))
    return advance(global_state)


@op("EXP")
def exp_(global_state):
    s = global_state.mstate.stack
    base, exponent = s.pop(), s.pop()
    result, condition = exponent_function_manager.create_condition(base, exponent)
    if not is_true(condition):
        global_state.world_state.constraints.append(condition)
    s.append(result)
    return advance(global_state)


@op("SIGNEXTEND")
def signextend_(global_state):
    s = global_state.mstate.stack
    position, value = s.pop(), s.pop()
    pos_concrete = concrete_or_none(position)
    if pos_concrete is not None:
        if pos_concrete >= 31:
            s.append(value)
        else:
            bits = 8 * (pos_concrete + 1)
            s.append(SignExt(256 - bits, Extract(bits - 1, 0, value)))
    else:
        result = value
        for k in range(31):
            bits = 8 * (k + 1)
            extended = SignExt(256 - bits, Extract(bits - 1, 0, value))
            result = If(position == bv(k), extended, result)
        s.append(result)
    return advance(global_state)


# ---------------------------------------------------------------------------
# comparison / bitwise


@op("LT")
def lt_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(bool_to_bv(ULT(a, b)))
    return advance(global_state)


@op("GT")
def gt_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(bool_to_bv(UGT(a, b)))
    return advance(global_state)


@op("SLT")
def slt_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(bool_to_bv(a.slt(b)))
    return advance(global_state)


@op("SGT")
def sgt_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(bool_to_bv(a.sgt(b)))
    return advance(global_state)


@op("EQ")
def eq_(global_state):
    s = global_state.mstate.stack
    a, b = s.pop(), s.pop()
    s.append(bool_to_bv(a == b))
    return advance(global_state)


@op("ISZERO")
def iszero_(global_state):
    s = global_state.mstate.stack
    s.append(bool_to_bv(s.pop() == bv(0)))
    return advance(global_state)


@op("AND")
def and_(global_state):
    s = global_state.mstate.stack
    s.append(s.pop() & s.pop())
    return advance(global_state)


@op("OR")
def or_(global_state):
    s = global_state.mstate.stack
    s.append(s.pop() | s.pop())
    return advance(global_state)


@op("XOR")
def xor_(global_state):
    s = global_state.mstate.stack
    s.append(s.pop() ^ s.pop())
    return advance(global_state)


@op("NOT")
def not_(global_state):
    s = global_state.mstate.stack
    s.append(~s.pop())
    return advance(global_state)


@op("BYTE")
def byte_(global_state):
    s = global_state.mstate.stack
    index, value = s.pop(), s.pop()
    result = If(
        ULT(index, bv(32)),
        LShR(value, (bv(31) - index) * bv(8)) & bv(0xFF),
        bv(0),
    )
    s.append(result)
    return advance(global_state)


@op("SHL")
def shl_(global_state):
    s = global_state.mstate.stack
    shift, value = s.pop(), s.pop()
    s.append(value << shift)
    return advance(global_state)


@op("SHR")
def shr_(global_state):
    s = global_state.mstate.stack
    shift, value = s.pop(), s.pop()
    s.append(LShR(value, shift))
    return advance(global_state)


@op("SAR")
def sar_(global_state):
    s = global_state.mstate.stack
    shift, value = s.pop(), s.pop()
    s.append(AShR(value, shift))
    return advance(global_state)


# ---------------------------------------------------------------------------
# keccak


@op("SHA3")
def sha3_(global_state):
    s = global_state.mstate.stack
    offset, length = s.pop(), s.pop()
    length_concrete = concrete_or_none(length)
    if length_concrete is None:
        length_concrete = concretize(global_state, length, "sha3_length")
    if length_concrete == 0:
        s.append(keccak_function_manager.get_empty_keccak_hash())
        return advance(global_state)
    offset_concrete = concrete_or_none(offset)
    if offset_concrete is None:
        offset_concrete = concretize(global_state, offset, "sha3_offset")
    global_state.mstate.mem_extend(offset_concrete, length_concrete)
    data_bytes = [
        global_state.mstate.memory.get_byte(offset_concrete + i)
        for i in range(length_concrete)
    ]
    data = Concat(data_bytes) if len(data_bytes) > 1 else data_bytes[0]
    data = simplify(data)
    s.append(keccak_function_manager.create_keccak(data))
    return advance(global_state)


# ---------------------------------------------------------------------------
# environment


@op("ADDRESS")
def address_(global_state):
    global_state.mstate.stack.append(global_state.environment.address)
    return advance(global_state)


@op("BALANCE")
def balance_(global_state):
    s = global_state.mstate.stack
    address = s.pop()
    s.append(global_state.world_state.balances[address])
    return advance(global_state)


@op("SELFBALANCE")
def selfbalance_(global_state):
    global_state.mstate.stack.append(
        global_state.world_state.balances[global_state.environment.address]
    )
    return advance(global_state)


@op("ORIGIN")
def origin_(global_state):
    global_state.mstate.stack.append(global_state.environment.origin)
    return advance(global_state)


@op("CALLER")
def caller_(global_state):
    global_state.mstate.stack.append(global_state.environment.sender)
    return advance(global_state)


@op("CALLVALUE")
def callvalue_(global_state):
    global_state.mstate.stack.append(global_state.environment.callvalue)
    return advance(global_state)


@op("CALLDATALOAD")
def calldataload_(global_state):
    s = global_state.mstate.stack
    offset = s.pop()
    s.append(global_state.environment.calldata.get_word_at(offset))
    return advance(global_state)


@op("CALLDATASIZE")
def calldatasize_(global_state):
    global_state.mstate.stack.append(
        global_state.environment.calldata.calldatasize
    )
    return advance(global_state)


APPROX_COPY_BYTES = 320  # bound for symbolic-length copies (keeps len FREE)


def _copy_to_memory(global_state, mem_offset, data_offset, length, reader):
    """Shared body of *COPY ops.

    A symbolic length must NOT be solver-concretized: pinning it (the model
    usually picks 0) contradicts later guards like require(len > 0) and
    silently kills every continuing path. Following the reference's
    approximation (instructions.py _calldata_copy_helper: "the excess size
    will get overwritten"), a bounded number of source bytes is copied
    unconditionally and `length` stays unconstrained."""
    mem_offset_c = concrete_or_none(mem_offset)
    if mem_offset_c is None:
        mem_offset_c = concretize(global_state, mem_offset, "copy_dest")
    length_c = concrete_or_none(length)
    memory = global_state.mstate.memory
    if length_c is None:
        length_c = APPROX_COPY_BYTES
    else:
        length_c = min(length_c, 0x10000)  # sanity cap
    global_state.mstate.mem_extend(mem_offset_c, length_c)
    for i in range(length_c):
        memory.write_byte(mem_offset_c + i, reader(data_offset, i))


def _calldata_copy(global_state, mem_offset, data_offset, length):
    calldata = global_state.environment.calldata

    def reader(base, i):
        if isinstance(base, BitVec) and base.symbolic:
            return calldata[base + i]
        base_c = base.concrete_value if isinstance(base, BitVec) else base
        return calldata[base_c + i]

    _copy_to_memory(global_state, mem_offset, data_offset, length, reader)


@op("CALLDATACOPY")
def calldatacopy_(global_state):
    s = global_state.mstate.stack
    mem_offset, data_offset, length = s.pop(), s.pop(), s.pop()
    if _in_creation_tx(global_state):
        # creation calldata is a modelling fiction holding constructor args;
        # a real CALLDATACOPY during creation copies nothing useful
        # (reference instructions.py:887-889)
        return advance(global_state)
    _calldata_copy(global_state, mem_offset, data_offset, length)
    return advance(global_state)


def _in_creation_tx(global_state) -> bool:
    from mythril_tpu_torch.laser.transaction.models import ContractCreationTransaction

    return isinstance(
        global_state.current_transaction, ContractCreationTransaction
    )


@op("CODESIZE")
def codesize_(global_state):
    code = global_state.environment.code
    code_size = len(code.bytecode)
    if _in_creation_tx(global_state):
        # constructor args sit past the init code: report init-code size plus
        # room for them, pinning symbolic calldata's size so selector reads
        # stay consistent (reference instructions.py:989-1000)
        calldata = global_state.environment.calldata
        from mythril_tpu_torch.laser.state.calldata import ConcreteCalldata

        if isinstance(calldata, ConcreteCalldata):
            code_size += calldata.size
        else:
            code_size += 0x200  # space for 16 32-byte constructor args
            global_state.world_state.constraints.append(
                calldata.calldatasize == bv(code_size)
            )
    global_state.mstate.stack.append(bv(code_size))
    return advance(global_state)


@op("CODECOPY")
def codecopy_(global_state):
    s = global_state.mstate.stack
    mem_offset, code_offset, length = s.pop(), s.pop(), s.pop()
    bytecode = global_state.environment.code.bytecode
    code_size = len(bytecode)

    if _in_creation_tx(global_state):
        # reads past the init code are constructor-argument reads; serve them
        # from the (symbolic) creation calldata (reference :1093-1127)
        from mythril_tpu_torch.laser.state.calldata import SymbolicCalldata

        code_offset_c = concrete_or_none(code_offset)
        if (
            isinstance(global_state.environment.calldata, SymbolicCalldata)
            and code_offset_c is not None
            and code_offset_c >= code_size
        ):
            _calldata_copy(
                global_state, mem_offset, bv(code_offset_c - code_size), length
            )
            return advance(global_state)

    def reader(base, i):
        base_c = concrete_or_none(base) if isinstance(base, BitVec) else base
        if base_c is None:
            return global_state.new_bitvec(f"codebyte_{i}", 8)
        index = base_c + i
        return bytecode[index] if index < len(bytecode) else 0

    _copy_to_memory(global_state, mem_offset, code_offset, length, reader)
    return advance(global_state)


@op("GASPRICE")
def gasprice_(global_state):
    global_state.mstate.stack.append(global_state.environment.gasprice)
    return advance(global_state)


@op("EXTCODESIZE")
def extcodesize_(global_state):
    s = global_state.mstate.stack
    address = s.pop()
    addr_c = concrete_or_none(address)
    if addr_c is not None and addr_c in global_state.world_state.accounts:
        code = global_state.world_state.accounts[addr_c].code
        s.append(bv(len(code.bytecode)))
    else:
        s.append(global_state.new_bitvec(f"extcodesize_{address}", 256))
    return advance(global_state)


@op("EXTCODECOPY")
def extcodecopy_(global_state):
    s = global_state.mstate.stack
    address, mem_offset, code_offset, length = s.pop(), s.pop(), s.pop(), s.pop()
    addr_c = concrete_or_none(address)
    if addr_c is not None and addr_c in global_state.world_state.accounts:
        bytecode = global_state.world_state.accounts[addr_c].code.bytecode
    else:
        bytecode = b""

    def reader(base, i):
        base_c = concrete_or_none(base) if isinstance(base, BitVec) else base
        if base_c is None:
            return 0
        index = base_c + i
        return bytecode[index] if index < len(bytecode) else 0

    _copy_to_memory(global_state, mem_offset, code_offset, length, reader)
    return advance(global_state)


@op("EXTCODEHASH")
def extcodehash_(global_state):
    s = global_state.mstate.stack
    address = s.pop()
    addr_c = concrete_or_none(address)
    if addr_c is not None and addr_c in global_state.world_state.accounts:
        code = global_state.world_state.accounts[addr_c].code
        s.append(bv(int.from_bytes(code.bytecode_hash, "big")))
    else:
        s.append(global_state.new_bitvec(f"extcodehash_{address}", 256))
    return advance(global_state)


@op("RETURNDATASIZE")
def returndatasize_(global_state):
    ret = global_state.last_return_data
    if ret is None:
        global_state.mstate.stack.append(bv(0))
    else:
        global_state.mstate.stack.append(ret.size)
    return advance(global_state)


@op("RETURNDATACOPY")
def returndatacopy_(global_state):
    s = global_state.mstate.stack
    mem_offset, data_offset, length = s.pop(), s.pop(), s.pop()
    ret = global_state.last_return_data

    def reader(base, i):
        if ret is None:
            return 0
        base_c = concrete_or_none(base) if isinstance(base, BitVec) else base
        if base_c is None:
            return 0
        index = base_c + i
        if index < len(ret.return_data):
            return ret.return_data[index]
        return 0

    _copy_to_memory(global_state, mem_offset, data_offset, length, reader)
    return advance(global_state)


# ---------------------------------------------------------------------------
# block context


@op("BLOCKHASH")
def blockhash_(global_state):
    s = global_state.mstate.stack
    block_number = s.pop()
    s.append(global_state.new_bitvec(f"blockhash_{block_number}", 256))
    return advance(global_state)


@op("COINBASE")
def coinbase_(global_state):
    global_state.mstate.stack.append(global_state.new_bitvec("coinbase", 256))
    return advance(global_state)


@op("TIMESTAMP")
def timestamp_(global_state):
    global_state.mstate.stack.append(global_state.new_bitvec("timestamp", 256))
    return advance(global_state)


@op("NUMBER")
def number_(global_state):
    global_state.mstate.stack.append(global_state.environment.block_number)
    return advance(global_state)


@op("PREVRANDAO")
def prevrandao_(global_state):
    global_state.mstate.stack.append(global_state.new_bitvec("prevrandao", 256))
    return advance(global_state)


@op("GASLIMIT")
def gaslimit_(global_state):
    global_state.mstate.stack.append(bv(global_state.mstate.gas_limit))
    return advance(global_state)


@op("CHAINID")
def chainid_(global_state):
    global_state.mstate.stack.append(global_state.environment.chainid)
    return advance(global_state)


@op("BASEFEE")
def basefee_(global_state):
    global_state.mstate.stack.append(global_state.environment.basefee)
    return advance(global_state)


@op("BLOBHASH")
def blobhash_(global_state):
    s = global_state.mstate.stack
    index = s.pop()
    s.append(global_state.new_bitvec(f"blobhash_{index}", 256))
    return advance(global_state)


@op("BLOBBASEFEE")
def blobbasefee_(global_state):
    global_state.mstate.stack.append(global_state.new_bitvec("blobbasefee", 256))
    return advance(global_state)


# ---------------------------------------------------------------------------
# memory / storage


@op("MLOAD")
def mload_(global_state):
    s = global_state.mstate.stack
    offset = s.pop()
    offset_c = concrete_or_none(offset)
    if offset_c is not None:
        global_state.mstate.mem_extend(offset_c, 32)
        s.append(global_state.mstate.memory.get_word_at(offset_c))
    else:
        s.append(global_state.mstate.memory.get_word_at(offset))
    return advance(global_state)


@op("MSTORE")
def mstore_(global_state):
    s = global_state.mstate.stack
    offset, value = s.pop(), s.pop()
    offset_c = concrete_or_none(offset)
    if offset_c is not None:
        global_state.mstate.mem_extend(offset_c, 32)
        global_state.mstate.memory.write_word_at(offset_c, value)
    else:
        global_state.mstate.memory.write_word_at(offset, value)
    return advance(global_state)


@op("MSTORE8")
def mstore8_(global_state):
    s = global_state.mstate.stack
    offset, value = s.pop(), s.pop()
    offset_c = concrete_or_none(offset)
    if offset_c is not None:
        global_state.mstate.mem_extend(offset_c, 1)
        global_state.mstate.memory.write_byte(offset_c, Extract(7, 0, value))
    else:
        global_state.mstate.memory.write_byte(offset, Extract(7, 0, value))
    return advance(global_state)


@op("MSIZE")
def msize_(global_state):
    global_state.mstate.stack.append(bv(global_state.mstate.memory_size))
    return advance(global_state)


@op("MCOPY")
def mcopy_(global_state):
    s = global_state.mstate.stack
    dest, src, length = s.pop(), s.pop(), s.pop()
    memory = global_state.mstate.memory

    def reader(base, i):
        base_c = concrete_or_none(base) if isinstance(base, BitVec) else base
        if base_c is None:
            return memory.get_byte(base + i)
        return memory.get_byte(base_c + i)

    # snapshot source region first (overlapping copy semantics)
    length_c = concrete_or_none(length)
    if length_c is None:
        length_c = concretize(global_state, length, "mcopy_len")
    src_bytes = [reader(src, i) for i in range(min(length_c, 0x10000))]
    dest_c = concrete_or_none(dest)
    if dest_c is None:
        dest_c = concretize(global_state, dest, "mcopy_dest")
    global_state.mstate.mem_extend(dest_c, length_c)
    for i, byte in enumerate(src_bytes):
        memory.write_byte(dest_c + i, byte)
    return advance(global_state)


@op("SLOAD")
def sload_(global_state):
    s = global_state.mstate.stack
    index = s.pop()
    s.append(global_state.environment.active_account.storage[index])
    return advance(global_state)


@op("SSTORE")
def sstore_(global_state):
    s = global_state.mstate.stack
    index, value = s.pop(), s.pop()
    global_state.environment.active_account.storage[index] = value
    return advance(global_state)


@op("TLOAD")
def tload_(global_state):
    s = global_state.mstate.stack
    index = s.pop()
    s.append(
        global_state.transient_storage.get(
            global_state.environment.address, index
        )
    )
    return advance(global_state)


@op("TSTORE")
def tstore_(global_state):
    s = global_state.mstate.stack
    index, value = s.pop(), s.pop()
    global_state.transient_storage.set(
        global_state.environment.address, index, value
    )
    return advance(global_state)


# ---------------------------------------------------------------------------
# control flow


@op("JUMP")
def jump_(global_state):
    s = global_state.mstate.stack
    destination = s.pop()
    dest_c = concrete_or_none(destination)
    if dest_c is None:
        raise InvalidJumpDestination("symbolic jump destination")
    if dest_c not in global_state.environment.code.valid_jump_destinations:
        raise InvalidJumpDestination(f"jump to non-JUMPDEST {dest_c}")
    global_state.mstate.pc = dest_c
    return [global_state]


@op("JUMPI")
def jumpi_(global_state):
    s = global_state.mstate.stack
    destination, condition = s.pop(), s.pop()
    dest_c = concrete_or_none(destination)
    if dest_c is None:
        raise InvalidJumpDestination("symbolic jump destination")

    branch_condition = simplify(condition != bv(0))
    negated_condition = simplify(condition == bv(0))
    successors = []

    # fall-through side. Depth counts branch decisions, not instructions —
    # max_depth bounds the number of JUMPIs on a path (reference
    # instructions.py:1636,1661 increments depth only here).
    if not is_false(negated_condition):
        fallthrough = global_state.clone()
        fallthrough.mstate.pc += 1
        fallthrough.mstate.depth += 1
        if not is_true(negated_condition):
            fallthrough.world_state.constraints.append(negated_condition)
        successors.append(fallthrough)

    # jump side
    if dest_c in global_state.environment.code.valid_jump_destinations:
        if not is_false(branch_condition):
            jump_state = global_state  # reuse the original for the taken side
            jump_state.mstate.pc = dest_c
            jump_state.mstate.depth += 1
            if not is_true(branch_condition):
                jump_state.world_state.constraints.append(branch_condition)
            successors.append(jump_state)

    return successors


@op("PC")
def pc_(global_state):
    global_state.mstate.stack.append(bv(global_state.mstate.pc))
    return advance(global_state)


@op("GAS")
def gas_(global_state):
    global_state.mstate.stack.append(global_state.new_bitvec("gas", 256))
    return advance(global_state)


@op("JUMPDEST")
def jumpdest_(global_state):
    return advance(global_state)


@op("STOP")
def stop_(global_state):
    transaction = global_state.current_transaction
    transaction.end(global_state, return_data=None, revert=False)


@op("RETURN")
def return_(global_state):
    s = global_state.mstate.stack
    offset, length = s.pop(), s.pop()
    length_c = concrete_or_none(length)
    if length_c is None:
        length_c = concretize(global_state, length, "return_length")
    length_c = min(length_c, 0x10000)
    offset_c = concrete_or_none(offset)
    if offset_c is None and length_c:
        offset_c = concretize(global_state, offset, "return_offset")
    if length_c:
        global_state.mstate.mem_extend(offset_c, length_c)
    data = [
        global_state.mstate.memory.get_byte(offset_c + i)
        for i in range(length_c)
    ]
    transaction = global_state.current_transaction
    transaction.end(global_state, return_data=ReturnData(data, length_c))


@op("REVERT")
def revert_(global_state):
    s = global_state.mstate.stack
    offset, length = s.pop(), s.pop()
    length_c = concrete_or_none(length) or 0
    length_c = min(length_c, 0x10000)
    offset_c = concrete_or_none(offset)
    data = []
    if offset_c is not None:
        if length_c:
            global_state.mstate.mem_extend(offset_c, length_c)
        data = [
            global_state.mstate.memory.get_byte(offset_c + i)
            for i in range(length_c)
        ]
    transaction = global_state.current_transaction
    transaction.end(
        global_state, return_data=ReturnData(data, length_c), revert=True
    )


@op("INVALID")
def invalid_(global_state):
    raise InvalidInstruction("INVALID / ASSERT_FAIL")


@op("SELFDESTRUCT")
def selfdestruct_(global_state):
    s = global_state.mstate.stack
    beneficiary = simplify(s.pop() & bv((1 << 160) - 1))  # address = low 160 bits
    world_state = global_state.world_state
    account = global_state.environment.active_account
    world_state.accounts_exist_or_load(beneficiary)  # materialize recipient
    balance = world_state.balances[account.address]
    world_state.balances[beneficiary] = (
        world_state.balances[beneficiary] + balance
    )
    world_state.balances[account.address] = bv(0)
    account.deleted = True
    transaction = global_state.current_transaction
    transaction.end(global_state, return_data=None, revert=False)


# calls / creation live in call_ops.py (registered on import)
from mythril_tpu_torch.laser import call_ops  # noqa: E402,F401  (registers handlers)
