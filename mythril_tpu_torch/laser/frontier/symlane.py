"""Symbolic-value lanes in the dense frontier representation.

The dense machine state (dense.py) is concrete byte limbs; before this
module, any run whose compute ops CONSUMED a symbolic or annotated stack
slot could not batch at all — on real contracts, whose dispatchers
consume symbolic calldata within an op or two of every block head, that
made the batchable surface near zero by construction. The lane fixes
this per ROW, not per run: each stack slot carries a tag (concrete
limbs vs. opaque term-handle), the per-row handle table is the original
BitVec objects themselves (held host-side, exactly like the
passthrough slots), and the compiled micro-op program doubles as a
STRUCTURAL OP LOG that decode replays into the ORIGINAL BitVec terms in
execution order — constructing, for every op that consumed an opaque
operand, the exact term the per-state interpreter's handler builds
(same helper calls, same operand objects, same eager constant folding),
while concrete lanes keep riding the kernel.

Admission is a per-row tag simulation (`admit`): abstract-interpret the
run over one bit per slot (opaque?) and decide
  "kernel"  no compute op consumes an opaque value — the existing
            kernel decode path is exact (passthrough slots included);
  "sym"     opaque values flow through computations — the kernel's
            limbs for those lanes are placeholders and decode takes
            the structural replay below;
  reject    an opaque value reaches a position the kernel (or the
            batch dialect) needs dynamically concrete: a memory
            offset, an MLOAD after a symbolic-valued store (the dense
            window bytes there are garbage), a guarded store about to
            write a word the hook predicate cannot judge, a JUMPI
            destination, a RETURN operand, a CALLDATALOAD offset.
            Rejected rows replay on the per-state interpreter, which
            handles every one of these today.

The kernel's `ok` mask, gas, and msize stay trustworthy for "sym" rows
by construction: taint only enters through opaque window slots and
CALLDATALOAD results, and every kernel computation that feeds ok/gas
(memory offsets and extension fees) is required concrete-tagged above.

The replay recomputes concrete intermediates with exact python-int EVM
semantics (the same semantics words.py implements limb-wise — held to
the interpreter by the differential property tests) so mixed terms like
`calldata_word + 4` embed the same constants eager folding would have
produced, and maintains a local overlay of the dense memory window so
MLOADs inside the run read what the kernel read.
"""

from typing import List, Optional, Tuple

from mythril_tpu_torch.laser.frontier.dense import encodable_word
from mythril_tpu_torch.laser.frontier.fastset import Run

M256 = 1 << 256
MASK256 = M256 - 1


def _opaque(entry) -> bool:
    """Does this shadow entry ride as a term handle? Mirrors
    dense.encodable_word: annotations are the taint channel, so an
    annotated constant is opaque too (its terms must carry the
    annotation exactly as the interpreter's would)."""
    if isinstance(entry, int):
        return False
    return encodable_word(entry) is None


# -- per-row admission (the tag simulation) ----------------------------------


def admit(state, run: Run) -> Tuple[Optional[str], Optional[str]]:
    """("kernel"|"sym", None) or (None, reason) for one state at `run`.
    Assumes the engine-level prechecks (dense.state_prechecks) already
    passed. reason in {"symbolic", "hook"} names the fallback-exit
    breakdown bucket for rejected rows."""
    stack = state.mstate.stack
    base = len(stack) - run.touch
    tags = [_opaque(stack[base + j]) for j in range(run.touch)]
    if not any(tags) and not run.has_calldataload:
        return "kernel", None
    guarded = {log_index for log_index, _predicates in run.mem_guards}
    needs_replay = run.has_calldataload
    sym_store = False
    mem_index = 0
    st = tags
    for op in run.ops:
        kind = op.kind
        if kind in ("push", "pc", "msize"):
            st.append(False)
        elif kind == "dup":
            st.append(st[-op.arg])
        elif kind == "swap":
            st[-1], st[-op.arg - 1] = st[-op.arg - 1], st[-1]
        elif kind == "pop":
            st.pop()
        elif kind in ("bin", "byte", "shl", "shr", "sar", "signextend"):
            a = st.pop()
            b = st.pop()
            result = a or b
            needs_replay = needs_replay or result
            st.append(result)
        elif kind in ("not", "iszero"):
            result = st.pop()
            needs_replay = needs_replay or result
            st.append(result)
        elif kind == "mload":
            if st.pop():
                return None, "symbolic"  # offset must be concrete
            if sym_store:
                # a symbolic word already entered the window: the
                # kernel's bytes under this load may be placeholders
                return None, "symbolic"
            st.append(False)
        elif kind in ("mstore", "mstore8"):
            if st.pop():
                return None, "symbolic"  # offset must be concrete
            if st.pop():
                if mem_index in guarded:
                    # the conditionally-transparent hook's predicate
                    # cannot judge a symbolic word: bail so the hook
                    # fires per-state, exactly as it always did
                    return None, "hook"
                sym_store = True
                needs_replay = True
            mem_index += 1
        elif kind == "calldataload":
            if st.pop():
                # only dynamically-concrete offsets promote; a fully
                # symbolic read stays on the per-state interpreter
                return None, "symbolic"
            st.append(True)
        elif kind == "jumpi":
            if st.pop():
                return None, "symbolic"  # symbolic jump destination
            st.pop()  # an opaque condition rides through (PendingFork)
        elif kind == "return":
            if st.pop() or st.pop():
                # the interpreter concretizes via the solver; that is
                # per-state work by definition
                return None, "symbolic"
        elif kind in ("stop", "nop"):
            pass
        else:  # pragma: no cover - compile and admit must stay in sync
            return None, "symbolic"
    return ("sym" if needs_replay else "kernel"), None


# -- exact python-int EVM semantics (concrete lanes of the replay) -----------


def _signed(value: int) -> int:
    return value - M256 if value >= (1 << 255) else value


def _sdiv(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _signed(a), _signed(b)
    quotient = abs(sa) // abs(sb)
    return (-quotient if (sa < 0) != (sb < 0) else quotient) % M256


def _smod(a: int, b: int) -> int:
    if b == 0:
        return 0
    sa, sb = _signed(a), _signed(b)
    remainder = abs(sa) % abs(sb)
    return (-remainder if sa < 0 else remainder) % M256


_INT_BIN = {
    "add": lambda a, b: (a + b) & MASK256,
    "sub": lambda a, b: (a - b) % M256,
    "mul": lambda a, b: (a * b) & MASK256,
    "div": lambda a, b: 0 if b == 0 else a // b,
    "mod": lambda a, b: 0 if b == 0 else a % b,
    "sdiv": _sdiv,
    "smod": _smod,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "lt": lambda a, b: int(a < b),
    "gt": lambda a, b: int(a > b),
    "slt": lambda a, b: int(_signed(a) < _signed(b)),
    "sgt": lambda a, b: int(_signed(a) > _signed(b)),
    "eq": lambda a, b: int(a == b),
}


def _int_byte(index: int, value: int) -> int:
    if index >= 32:
        return 0
    return (value >> (8 * (31 - index))) & 0xFF


def _int_shl(shift: int, value: int) -> int:
    return 0 if shift >= 256 else (value << shift) & MASK256


def _int_shr(shift: int, value: int) -> int:
    return 0 if shift >= 256 else value >> shift


def _int_sar(shift: int, value: int) -> int:
    signed = _signed(value)
    if shift >= 256:
        return MASK256 if signed < 0 else 0
    return (signed >> shift) % M256


def _int_signextend(position: int, value: int) -> int:
    if position >= 31:
        return value
    bits = 8 * (position + 1)
    low = value & ((1 << bits) - 1)
    if low >= 1 << (bits - 1):
        low |= M256 - (1 << bits)
    return low


# -- the structural replay ---------------------------------------------------


class Replay:
    """One row's structural-replay result: the final stack entries
    (python int for concrete lanes — interned as the same constants
    eager folding produces — or the constructed/original BitVec for
    opaque lanes), the per-store written values in mem-log order, and
    the popped terminal operands as the interpreter objects."""

    __slots__ = ("out", "mem_values", "terminal")

    def __init__(self, out: List, mem_values: List, terminal: Tuple):
        self.out = out
        self.mem_values = mem_values
        self.terminal = terminal


def to_term(entry):
    """Shadow entry -> the BitVec the interpreter's stack would hold:
    an int lane interns as BitVecVal (eager folding's constant), an
    opaque lane IS the original/constructed object."""
    if isinstance(entry, int):
        from mythril_tpu_torch.laser.instructions import bv

        return bv(entry)
    return entry


def to_int(entry) -> int:
    return entry if isinstance(entry, int) else entry.raw.value


def _sym_bin(arg: str, a, b):
    """Mirror of the interpreter's binary handlers for opaque operands
    (instructions.py): the exact helper calls, in the exact operand
    orientation (`a` was the top of the stack)."""
    from mythril_tpu_torch.laser.instructions import bool_to_bv
    from mythril_tpu_torch.smt import SDiv, SRem, UDiv, UGT, ULT, URem

    a, b = to_term(a), to_term(b)
    if arg == "add":
        return a + b
    if arg == "sub":
        return a - b
    if arg == "mul":
        return a * b
    if arg == "div":
        return UDiv(a, b)
    if arg == "sdiv":
        return SDiv(a, b)
    if arg == "mod":
        return URem(a, b)
    if arg == "smod":
        return SRem(a, b)
    if arg == "and":
        return a & b
    if arg == "or":
        return a | b
    if arg == "xor":
        return a ^ b
    if arg == "lt":
        return bool_to_bv(ULT(a, b))
    if arg == "gt":
        return bool_to_bv(UGT(a, b))
    if arg == "slt":
        return bool_to_bv(a.slt(b))
    if arg == "sgt":
        return bool_to_bv(a.sgt(b))
    if arg == "eq":
        return bool_to_bv(a == b)
    raise AssertionError(f"unknown bin op {arg}")


def _sym_signextend(position, value):
    """Mirror of signextend_ for an opaque operand pair — including the
    concrete_or_none branch, which an ANNOTATED concrete position takes
    exactly as the interpreter would."""
    from mythril_tpu_torch.laser.instructions import bv, concrete_or_none
    from mythril_tpu_torch.smt import If, SignExt, Extract

    position, value = to_term(position), to_term(value)
    pos_concrete = concrete_or_none(position)
    if pos_concrete is not None:
        if pos_concrete >= 31:
            return value
        bits = 8 * (pos_concrete + 1)
        return SignExt(256 - bits, Extract(bits - 1, 0, value))
    result = value
    for k in range(31):
        bits = 8 * (k + 1)
        extended = SignExt(256 - bits, Extract(bits - 1, 0, value))
        result = If(position == bv(k), extended, result)
    return result


def replay(state, run: Run, window: Optional[List] = None) -> Replay:
    """Replay `run`'s structural op log for one admitted "sym" row over
    the row's ORIGINAL stack window objects — `window` is the dense
    frame's per-row handle table (DenseFrontier.handles, snapshotted at
    encode; read from the live stack when absent) — building every
    opaque lane's term exactly as the interpreter's handlers would.
    Called on the untouched pre-decode state (kernel `ok` already True
    for the row, so gas/msize/oob cannot bail here by construction)."""
    from mythril_tpu_torch.laser.instructions import bool_to_bv, bv
    from mythril_tpu_torch.smt import AShR, If, LShR, ULT

    mstate = state.mstate
    stack = mstate.stack
    if window is None:
        window = stack[len(stack) - run.touch:] if run.touch else []
    shadow: List = list(window)
    overlay = None
    if run.has_mem:
        window = mstate.memory.dense_window(run.window)
        overlay = (bytearray(window) if window is not None
                   else bytearray(run.window))
    msize = mstate.memory.size
    mem_values: List = []
    terminal: Tuple = ()

    def extend(offset: int, size: int) -> None:
        nonlocal msize
        end = offset + size
        needed = ((end + 31) // 32) * 32
        if msize <= end and needed // 32 > msize // 32:
            msize = needed

    for op in run.ops:
        kind = op.kind
        if kind == "push":
            shadow.append(int.from_bytes(bytes(op.arg), "big"))
        elif kind == "dup":
            shadow.append(shadow[-op.arg])
        elif kind == "swap":
            n = op.arg
            shadow[-1], shadow[-n - 1] = shadow[-n - 1], shadow[-1]
        elif kind == "pop":
            shadow.pop()
        elif kind == "bin":
            a = shadow.pop()
            b = shadow.pop()
            if _opaque(a) or _opaque(b):
                shadow.append(_sym_bin(op.arg, a, b))
            else:
                shadow.append(_INT_BIN[op.arg](to_int(a), to_int(b)))
        elif kind == "not":
            a = shadow.pop()
            shadow.append(~to_term(a) if _opaque(a)
                          else to_int(a) ^ MASK256)
        elif kind == "iszero":
            a = shadow.pop()
            shadow.append(bool_to_bv(to_term(a) == bv(0)) if _opaque(a)
                          else int(to_int(a) == 0))
        elif kind == "byte":
            index = shadow.pop()
            value = shadow.pop()
            if _opaque(index) or _opaque(value):
                index_t, value_t = to_term(index), to_term(value)
                shadow.append(If(
                    ULT(index_t, bv(32)),
                    LShR(value_t, (bv(31) - index_t) * bv(8)) & bv(0xFF),
                    bv(0)))
            else:
                shadow.append(_int_byte(to_int(index), to_int(value)))
        elif kind in ("shl", "shr", "sar"):
            shift = shadow.pop()
            value = shadow.pop()
            if _opaque(shift) or _opaque(value):
                shift_t, value_t = to_term(shift), to_term(value)
                shadow.append(
                    value_t << shift_t if kind == "shl"
                    else LShR(value_t, shift_t) if kind == "shr"
                    else AShR(value_t, shift_t))
            else:
                fn = {"shl": _int_shl, "shr": _int_shr,
                      "sar": _int_sar}[kind]
                shadow.append(fn(to_int(shift), to_int(value)))
        elif kind == "signextend":
            position = shadow.pop()
            value = shadow.pop()
            if _opaque(position) or _opaque(value):
                shadow.append(_sym_signextend(position, value))
            else:
                shadow.append(
                    _int_signextend(to_int(position), to_int(value)))
        elif kind == "mload":
            offset = to_int(shadow.pop())
            extend(offset, 32)
            shadow.append(
                int.from_bytes(bytes(overlay[offset:offset + 32]), "big"))
        elif kind == "mstore":
            offset = to_int(shadow.pop())
            value = shadow.pop()
            extend(offset, 32)
            mem_values.append(value)
            if not _opaque(value):
                overlay[offset:offset + 32] = \
                    to_int(value).to_bytes(32, "big")
            # an opaque store leaves the overlay alone: admission
            # rejected any MLOAD ordered after it
        elif kind == "mstore8":
            offset = to_int(shadow.pop())
            value = shadow.pop()
            extend(offset, 1)
            mem_values.append(value)
            if not _opaque(value):
                overlay[offset] = to_int(value) & 0xFF
        elif kind == "calldataload":
            offset = shadow.pop()
            # the exact handler line: the popped object goes into
            # get_word_at, so the canonical calldata term (and any
            # annotations on the offset) come out bit-identical
            shadow.append(
                state.environment.calldata.get_word_at(to_term(offset)))
        elif kind == "msize":
            shadow.append(msize)
        elif kind == "pc":
            shadow.append(op.arg)
        elif kind == "nop":
            pass
        elif kind == "jumpi":
            dest = shadow.pop()
            cond = shadow.pop()
            terminal = (to_term(dest), to_term(cond))
        elif kind == "return":
            offset = shadow.pop()
            length = shadow.pop()
            terminal = (to_term(offset), to_term(length))
        elif kind == "stop":
            pass
        else:  # pragma: no cover - compile and replay must stay in sync
            raise AssertionError(f"unknown micro-op {kind}")
    return Replay(shadow, mem_values, terminal)


def decode_sym_state(global_state, run: Run, rep: Replay, mem_log,
                     msize, min_gas, max_gas, i: int) -> None:
    """Commit one "sym" row: the replayed stack entries replace the
    window (int lanes intern as constants — dense.decode_state's exact
    discipline — opaque lanes keep their objects), memory replays the
    kernel's store log in execution order with the REPLAYED value
    objects (so a symbolic stored word enters the SMT chain exactly as
    write_word_at would have taken it from the interpreter), and
    msize/gas/pc commit from the kernel row, which is exact for "sym"
    rows by the admission rules."""
    from mythril_tpu_torch.smt import Extract

    mstate = global_state.mstate
    stack = mstate.stack
    if run.touch:
        del stack[len(stack) - run.touch:]
    for entry in rep.out:
        stack.append(to_term(entry))
    if run.has_mem:
        memory = mstate.memory
        log_index = 0
        for op in run.ops:
            if op.kind == "mstore":
                off, _value = mem_log[log_index]
                value = rep.mem_values[log_index]
                log_index += 1
                memory.write_word_at(
                    int(off[i]),
                    value if _opaque(value) else to_int(value))
            elif op.kind == "mstore8":
                off, _value = mem_log[log_index]
                value = rep.mem_values[log_index]
                log_index += 1
                if _opaque(value):
                    memory.write_byte(int(off[i]),
                                      Extract(7, 0, to_term(value)))
                else:
                    memory.write_byte(int(off[i]), to_int(value) & 0xFF)
        new_msize = int(msize[i])
        if new_msize > memory.size:
            memory._msize = new_msize
    mstate.min_gas_used = int(min_gas[i])
    mstate.max_gas_used = int(max_gas[i])
    mstate.pc = run.end_pc
