"""Dense machine-state representation of a frontier batch.

N sibling GlobalStates (same code object, same pc) densify into padded
numpy arrays the batched kernel consumes:

  stack        (N, touch, 32) int32   big-endian byte limbs of the top
                                      `touch` stack entries the run can
                                      read (position 0 = deepest)
  depth        (N,)           int32   full per-state stack depth (the
                                      untouched part below the window
                                      stays host-side in python)
  mem          (N, W)         int32   dense byte window of memory
  mem_written  (N, W)         bool    kernel write mask (write-back set)
  msize        (N,)           int32   active memory size (extension gas)
  pc / min_gas / max_gas / gas_limit  (N,) int32
  live         (N,)           bool    real state vs padding

Encode never mutates a state; decode commits results only for states the
kernel finished (`ok`), writing the new stack slice (as interned constant
terms — the same values the per-state interpreter's eager constant
folding produces), the written memory bytes (through Memory.write_byte,
so the SMT store chain and the concrete shadow stay in sync), msize, gas,
and the run-end pc. States that bailed mid-run keep their original
objects untouched and replay on the per-state interpreter.
"""

from typing import List, Optional

import numpy as np

from mythril_tpu_torch.laser.frontier import words
from mythril_tpu_torch.laser.frontier.fastset import Run
from mythril_tpu_torch.laser.state.machine_state import STACK_LIMIT
from mythril_tpu_torch.smt import BitVec, symbol_factory

# encode-side gas guard: every kernel gas quantity must stay far from the
# int32 edge (the CUDA step holds gas in int32); runs add at most a
# few thousand units per opcode plus window-bounded memory fees
GAS_ENCODE_CAP = 1 << 30


def encodable_word(entry) -> Optional[int]:
    """Concrete, annotation-free 256-bit stack entry -> int, else None.
    Annotations are the taint channel — a dense round-trip would drop
    them, so tainted values keep the state on the per-state path."""
    if not isinstance(entry, BitVec):
        return None
    if entry.annotations or not entry.raw.is_const:
        return None
    return entry.raw.value


def state_prechecks(global_state, run: Run):
    """Engine-level admission checks shared by the kernel path and the
    symbolic lane: None when the state may enter a batch at all, else
    the fallback-reason bucket ("dynamic" for shape/gas refusals,
    "symbolic" when the memory window cannot densify)."""
    mstate = global_state.mstate
    stack = mstate.stack
    if len(stack) < run.touch:
        return "dynamic"  # underflow: per-state path raises the error
    if len(stack) - run.touch + run.capacity > STACK_LIMIT:
        return "dynamic"  # could overflow mid-run
    if (mstate.gas_limit > GAS_ENCODE_CAP
            or mstate.min_gas_used > GAS_ENCODE_CAP
            or mstate.max_gas_used > GAS_ENCODE_CAP
            or mstate.memory.size > GAS_ENCODE_CAP):
        return "dynamic"
    if run.has_mload and mstate.memory.dense_window(run.window) is None:
        return "symbolic"
    return None


def consumed_windows_concrete(global_state, run: Run) -> bool:
    """Only window slots some compute op CONSUMES must be concrete and
    taint-free; purely-shuffled slots pass through as opaque host
    values (decode reuses the original BitVec objects)."""
    stack = global_state.mstate.stack
    base = len(stack) - run.touch
    for j in run.consumed_windows:
        if encodable_word(stack[base + j]) is None:
            return False
    return True


def state_encodable(global_state, run: Run) -> bool:
    """Per-state KERNEL-path batch admission for `run` (the stepper has
    already checked engine-level and code-level conditions). The
    symbolic lane (symlane.admit) relaxes the consumed-window
    concreteness requirement per row; this predicate is the lane-off
    behavior and the "kernel" verdict's definition. (The stepper's
    _admit composes the two halves itself so the prechecks — and the
    dense-window build they imply — run once per sibling.)"""
    if state_prechecks(global_state, run) is not None:
        return False
    return consumed_windows_concrete(global_state, run)


class DenseFrontier:
    __slots__ = ("stack", "depth", "mem", "mem_written", "msize", "pc",
                 "min_gas", "max_gas", "gas_limit", "live", "sym_tags",
                 "handles")

    def __init__(self, n: int, touch: int, window: int):
        self.stack = np.zeros((n, touch, words.LIMBS), dtype=np.int32)
        self.depth = np.zeros(n, dtype=np.int32)
        self.mem = np.zeros((n, window), dtype=np.int32)
        self.mem_written = np.zeros((n, window), dtype=bool)
        self.msize = np.zeros(n, dtype=np.int32)
        self.pc = np.zeros(n, dtype=np.int32)
        self.min_gas = np.zeros(n, dtype=np.int32)
        self.max_gas = np.zeros(n, dtype=np.int32)
        self.gas_limit = np.zeros(n, dtype=np.int32)
        self.live = np.zeros(n, dtype=bool)
        # the symbolic-value lane (populated only under encode's `lane`
        # mode): per-slot tag (True = the limbs are a placeholder and
        # the slot's value is an opaque term handle) + the per-row
        # handle table — the row's window entries as the ORIGINAL
        # BitVec objects, snapshotted at encode time. The kernel never
        # reads them; the lane's structural replay initializes its
        # shadow stack from exactly this table.
        self.sym_tags = None
        self.handles = None

    @property
    def batch(self) -> int:
        return self.stack.shape[0]


def encode_frontier(states: List, run: Run,
                    lane: bool = False) -> DenseFrontier:
    """Densify `states` (all pre-checked with state_encodable or the
    symbolic lane's admit) for `run`, one row each: nothing compiles per
    batch shape, so the batch axis is never padded. With `lane`, each row
    additionally carries the symbolic-value lane's tag vector and handle
    table (the window's ORIGINAL BitVec objects) — what the structural
    replay decodes opaque rows from."""
    n = len(states)
    dense = DenseFrontier(n, run.touch, run.window)
    if lane:
        dense.sym_tags = np.zeros((n, run.touch), dtype=bool)
        dense.handles = [None] * n
    for i, global_state in enumerate(states):
        mstate = global_state.mstate
        stack = mstate.stack
        base = len(stack) - run.touch
        if lane:
            dense.handles[i] = list(stack[base:]) if run.touch else []
        for j in range(run.touch):
            value = encodable_word(stack[base + j])
            if value is None:
                # opaque lane: the limbs stay a placeholder; the tag
                # plus the per-row handle table carry the slot's real
                # value (the original BitVec object) host-side for the
                # passthrough/structural-replay decode
                if lane:
                    dense.sym_tags[i, j] = True
                continue
            dense.stack[i, j] = np.frombuffer(
                value.to_bytes(32, "big"), dtype=np.uint8)
        dense.depth[i] = len(stack)
        if run.has_mem:
            window = mstate.memory.dense_window(run.window)
            if window is not None:
                dense.mem[i] = np.frombuffer(bytes(window), dtype=np.uint8)
            # write-only runs on a non-densifiable memory: reads never
            # happen, writes ride the mask — window content is irrelevant
        dense.msize[i] = mstate.memory.size
        dense.pc[i] = mstate.pc
        dense.min_gas[i] = mstate.min_gas_used
        dense.max_gas[i] = mstate.max_gas_used
        dense.gas_limit[i] = mstate.gas_limit
        dense.live[i] = True
    return dense


def guard_tripped(run: Run, mem_log, i: int) -> bool:
    """Row `i` wrote a value some conditionally-transparent hook is NOT
    inert for (Run.mem_guards, e.g. the hevm assertion marker): the row
    must bail and replay per-state so the hook fires exactly as the
    interpreter would have fired it."""
    for log_index, predicates in run.mem_guards:
        value = words.int_from_limbs(mem_log[log_index][1][i])
        if any(predicate(value) for predicate in predicates):
            return True
    return False


def fork_operands(global_state, run: Run, fork_out, i: int):
    """Row `i`'s popped (destination, condition) BitVecs for a fork run,
    read from the UNTOUCHED pre-decode state: a window-sourced operand
    is the original stack object (identity + annotations, exactly what
    the interpreter's pops would see), a kernel-computed one interns the
    kernel's word — the same constant eager folding would have left."""
    stack = global_state.mstate.stack
    base = len(stack) - run.touch

    def operand(source, word):
        if source >= 0:
            return stack[base + source]
        return symbol_factory.BitVecVal(words.int_from_limbs(word[i]), 256)

    return (operand(run.fork.dest_source, fork_out[0]),
            operand(run.fork.cond_source, fork_out[1]))


def halt_operands(global_state, run: Run, term_out, i: int):
    """Row `i`'s popped (offset, length) BitVecs for a RETURN-halting
    run, with fork_operands' exact source discipline (original window
    object, or the kernel word interned). Both are dynamically concrete
    for admitted rows — the lane's tag sim bails opaque operands to the
    per-state interpreter, whose handler concretizes via the solver."""
    stack = global_state.mstate.stack
    base = len(stack) - run.touch

    def operand(source, word):
        if source >= 0:
            return stack[base + source]
        return symbol_factory.BitVecVal(words.int_from_limbs(word[i]), 256)

    return (operand(run.halt.offset_source, term_out[0]),
            operand(run.halt.length_source, term_out[1]))


class PendingFork:
    """One forked row's pending path-condition table entry: the exact
    BitVec literals the interpreter's JUMPI handler would append (same
    term identity and annotation discipline as the opaque-slot
    passthrough), held dense-side until the coalesced feasibility
    verdict decides which cohort materializes — an infeasible side is
    masked dead before it ever becomes a Python GlobalState."""

    __slots__ = ("state", "dest", "branch", "negated", "take_fall",
                 "take_jump", "fall_constrains", "jump_constrains")

    def __init__(self, state, dest, branch, negated, take_fall,
                 take_jump, fall_constrains, jump_constrains):
        self.state = state
        self.dest = dest
        self.branch = branch        # cond != 0 (taken-side literal)
        self.negated = negated      # cond == 0 (fall-through literal)
        self.take_fall = take_fall
        self.take_jump = take_jump
        self.fall_constrains = fall_constrains
        self.jump_constrains = jump_constrains

    @property
    def symbolic(self) -> bool:
        """Both sides live — the row genuinely forks and its sibling
        feasibility pair rides the coalesced fork bundle."""
        return self.take_fall and self.take_jump

    def side_constraints(self):
        """(fall-side, taken-side) full constraint lists for the
        feasibility bundle, built WITHOUT cloning the state — the base
        list plus the pending literal, exactly the set the interpreter
        path would hand the exec-loop fork pruner."""
        base = list(self.state.world_state.constraints.get_all_constraints())
        return base + [self.negated], base + [self.branch]

    def materialize(self, keep_fall: bool = True,
                    keep_jump: bool = True) -> List:
        """Commit the surviving sides, mirroring the interpreter's
        JUMPI handler object discipline: the fall-through side CLONES
        the row's state (pc is already at the fall-through address from
        decode), the taken side mutates the original in place; the
        pending literals append to each survivor's constraints."""
        successors = []
        state = self.state
        if self.take_fall and keep_fall:
            fallthrough = state.clone()
            fallthrough.mstate.depth += 1
            if self.fall_constrains:
                fallthrough.world_state.constraints.append(self.negated)
            successors.append(fallthrough)
        if self.take_jump and keep_jump:
            state.mstate.pc = self.dest
            state.mstate.depth += 1
            if self.jump_constrains:
                state.world_state.constraints.append(self.branch)
            successors.append(state)
        return successors


def build_pending_fork(global_state, dest_obj,
                       cond_obj) -> Optional[PendingFork]:
    """Mirror of the interpreter's JUMPI handler term construction for
    one decoded row, as a PENDING entry: which sides exist, which append
    a constraint, and the literal terms themselves — bit-identical to
    what jumpi_ would have produced. None when the destination is
    symbolic (the per-state replay raises the exact exception)."""
    from mythril_tpu_torch.laser.instructions import bv, concrete_or_none
    from mythril_tpu_torch.smt import is_false, is_true, simplify

    dest_c = concrete_or_none(dest_obj)
    if dest_c is None:
        return None
    branch = simplify(cond_obj != bv(0))
    negated = simplify(cond_obj == bv(0))
    take_fall = not is_false(negated)
    take_jump = (
        dest_c in global_state.environment.code.valid_jump_destinations
        and not is_false(branch))
    return PendingFork(
        global_state, dest_c, branch, negated,
        take_fall=take_fall, take_jump=take_jump,
        fall_constrains=not is_true(negated),
        jump_constrains=not is_true(branch))


def decode_state(global_state, run: Run, stack_out, mem, mem_written,
                 msize, min_gas, max_gas, i: int, mem_log=None) -> None:
    """Commit row `i` of the kernel result into `global_state`.

    Memory write-back prefers the kernel's per-store log (`mem_log`):
    replaying each MSTORE/MSTORE8 through write_word_at/write_byte in
    execution order rebuilds the SMT store chain byte-identically to the
    per-state interpreter — a later symbolic-index read over the chain
    then sees the same term structure on either path. Without a log
    (representation-level round-trips) the write mask is applied in
    index order instead."""
    mstate = global_state.mstate
    stack = mstate.stack
    old_window = list(stack[len(stack) - run.touch:]) if run.touch else []
    if run.touch:
        del stack[len(stack) - run.touch:]
    for j in range(run.out_len):
        source = run.out_sources[j]
        if source >= 0:
            # passthrough slot: the SAME object the interpreter's
            # shuffles would have left here (identity + annotations)
            stack.append(old_window[source])
        else:
            stack.append(symbol_factory.BitVecVal(
                words.int_from_limbs(stack_out[i, j]), 256))
    if run.has_mem:
        memory = mstate.memory
        if mem_log is not None:
            log_index = 0
            for op in run.ops:
                if op.kind == "mstore":
                    off, value = mem_log[log_index]
                    log_index += 1
                    memory.write_word_at(
                        int(off[i]), words.int_from_limbs(value[i]))
                elif op.kind == "mstore8":
                    off, value = mem_log[log_index]
                    log_index += 1
                    memory.write_byte(int(off[i]), int(value[i, 31]))
        else:
            for index in np.nonzero(mem_written[i])[0]:
                memory.write_byte(int(index), int(mem[i, index]))
        new_msize = int(msize[i])
        if new_msize > memory.size:
            memory._msize = new_msize
    mstate.min_gas_used = int(min_gas[i])
    mstate.max_gas_used = int(max_gas[i])
    mstate.pc = run.end_pc
