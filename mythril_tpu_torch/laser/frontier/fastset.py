"""Fast-set dispatch table and straight-line run extraction.

A *run* is the longest prefix of a pre-analysis CFG basic block starting at some
pc whose every opcode the batched kernel can execute: stack shuffles
(PUSH/DUP/SWAP/POP), add/sub/mul, bitwise ops, comparisons, shifts,
SIGNEXTEND/BYTE, MLOAD/MSTORE/MSTORE8 on (dynamically) concrete offsets,
and the PC/MSIZE/JUMPDEST bookkeeping ops. Runs stop before block
terminators (the fork points), before any opcode outside the fast set,
before any opcode with non-transparent engine hooks (detection modules,
pruners — those must see every state individually), and before a PUSH
with a symbolic (deploy-time-patched) operand.

Promoted INTO the fast set (per the JAX package's opcode wall
histogram): DIV/MOD/SDIV/SMOD as bit-serial
restoring division in words.py, and the block-terminating symbolic
JUMPI as a batched FORK — a run may end in a terminal `jumpi` micro-op
that pops the destination and condition and hands both words to the
host, where the stepper's fork epilogue splits every live row into
taken/fall-through cohorts with per-row pending path-condition literals
(dense.PendingFork).

Promoted on top of the symbolic-value lane
(laser/frontier/symlane.py, `allow_symbolic`): CALLDATALOAD — with a
dynamically-concrete offset it promotes to the canonical calldata term
handle in-batch (the micro-op pops the offset in the kernel and the
lane's structural replay builds `calldata.get_word_at(offset)` at
decode, the exact term the interpreter's handler appends) — and
RETURN/STOP as terminal `halt` micro-ops (`allow_halt`): the run ends
at the halting instruction and the stepper's halt epilogue rebuilds the
exact pre-halt state per row, fires the opcode's pre hooks host-side,
and drives the interpreter's own transaction-end machinery with
return-data built from the post-decode memory. Deliberately still
OUTSIDE the fast set, with the per-state interpreter as the oracle:
ADDMOD/MULMOD/EXP, SHA3/keccak (function-manager constraints), every
storage read (SLOAD/SSTORE carry detector and pruner hooks in every
shipped configuration), and the CALL/CREATE family.

Conditionally transparent hooks: an engine hook carrying a
`frontier_transparent_unless` value predicate (user_assertions' MSTORE
hook: inert unless the written word matches the hevm marker prefix) no
longer cuts runs — the op enters the batch with a compile-time guard
(Run.mem_guards) and any row whose dynamically-written value trips the
predicate bails to the per-state interpreter, where the hook fires
exactly as before.

Compilation statically derives the run's stack shape: `touch` (how many
entries of the caller's stack the run can read — all must be concrete and
annotation-free to enter a batch), `out_len` (slice length it leaves),
and `max_height` (peak growth, for the 1024-entry overflow pre-check).
All of this is per (code, pc), cached by the stepper — states only pay a
dictionary hit per step.
"""

from typing import Callable, List, Optional

from mythril_tpu_torch.laser.frontier import words
from mythril_tpu_torch.support.opcodes import BY_NAME

# shortest run worth a batch: below this the encode/decode term traffic
# cancels the saved interpreter steps
MIN_RUN_OPS = 3
# dense memory window (bytes) carried per state when a run touches
# memory; accesses past it exit the batch at run time
MEM_WINDOW = 2048

_BIN_OPS = {
    "ADD": "add", "SUB": "sub", "MUL": "mul",
    "DIV": "div", "MOD": "mod", "SDIV": "sdiv", "SMOD": "smod",
    "AND": "and", "OR": "or", "XOR": "xor",
    "LT": "lt", "GT": "gt", "SLT": "slt", "SGT": "sgt", "EQ": "eq",
}
_SHIFT_OPS = {"SHL": "shl", "SHR": "shr", "SAR": "sar"}
_SIMPLE_OPS = frozenset(
    ["POP", "NOT", "ISZERO", "BYTE", "SIGNEXTEND",
     "MLOAD", "MSTORE", "MSTORE8", "MSIZE", "PC", "JUMPDEST"])


def is_fast_op(name: str) -> bool:
    return (
        name in _BIN_OPS or name in _SHIFT_OPS or name in _SIMPLE_OPS
        or name.startswith("PUSH") or name.startswith("DUP")
        or name.startswith("SWAP")
    )


class MicroOp:
    """One compiled kernel instruction: kind + static argument + the
    opcode's static gas bounds (accrued after the op, mirroring
    instructions.execute)."""

    __slots__ = ("kind", "arg", "gas_min", "gas_max", "name")

    def __init__(self, kind, arg, gas_min, gas_max, name):
        self.kind = kind
        self.arg = arg
        self.gas_min = gas_min
        self.gas_max = gas_max
        self.name = name


class ForkInfo:
    """Static description of a run's terminal batched-JUMPI fork.

    `dest_source` / `cond_source` mirror Run.out_sources' encoding: the
    original window index the popped operand passes through from (decode
    reuses the ORIGINAL BitVec object — identical identity and
    annotations to the interpreter's pops), or -1 for a kernel-computed
    value (decode interns the kernel word, exactly the constant the
    interpreter's eager folding would have left on the stack)."""

    __slots__ = ("pc", "dest_source", "cond_source")

    def __init__(self, pc: int, dest_source: int, cond_source: int):
        self.pc = pc                  # the JUMPI instruction's address
        self.dest_source = dest_source
        self.cond_source = cond_source


class HaltInfo:
    """Static description of a run's terminal RETURN/STOP micro-op.

    `kind` is "return" or "stop"; for RETURN, `offset_source` /
    `length_source` use ForkInfo's encoding (original window index the
    popped operand passes through from, or -1 for a kernel-computed
    word surfaced in term_out). The operands must be dynamically
    concrete per row — a row popping an opaque offset/length bails to
    the per-state interpreter, whose handler concretizes via the
    solver exactly as before."""

    __slots__ = ("pc", "kind", "offset_source", "length_source")

    def __init__(self, pc: int, kind: str,
                 offset_source: int = -1, length_source: int = -1):
        self.pc = pc                  # the halting instruction's address
        self.kind = kind              # "return" | "stop"
        self.offset_source = offset_source
        self.length_source = length_source


class Run:
    """A compiled straight-line run shared by every sibling state at its
    start pc within one code object."""

    __slots__ = ("ops", "start_pc", "end_pc", "touch", "out_len",
                 "capacity", "max_height", "has_mem", "has_mload",
                 "window", "first_instr", "key", "op_names", "op_pcs",
                 "consumed_windows", "out_sources", "fork", "mem_guards",
                 "cut_at_jumpi", "halt", "has_calldataload",
                 "cut_at_halt", "cut_at_calldataload")

    def __init__(self, ops: List[MicroOp], start_pc: int, end_pc: int,
                 touch: int, out_len: int, max_height: int,
                 has_mem: bool, has_mload: bool, first_instr, key,
                 op_pcs=(), consumed_windows=None, out_sources=None,
                 fork: Optional[ForkInfo] = None, mem_guards=(),
                 cut_at_jumpi: bool = False,
                 halt: Optional[HaltInfo] = None,
                 has_calldataload: bool = False,
                 cut_at_halt: bool = False,
                 cut_at_calldataload: bool = False):
        self.ops = ops
        self.start_pc = start_pc
        self.end_pc = end_pc
        self.touch = touch          # entries read below the initial top
        self.out_len = out_len      # entries the run leaves in their place
        self.capacity = touch + max(max_height, 0)
        self.max_height = max_height  # peak net growth above the start
        self.has_mem = has_mem
        self.has_mload = has_mload
        self.window = MEM_WINDOW if has_mem else 1
        self.first_instr = first_instr
        self.key = key              # kernel program-cache identity
        self.op_names = tuple(op.name for op in ops)
        self.op_pcs = tuple(op_pcs)  # instruction addresses of the run
        # static slot provenance (stack shuffles are data-independent, so
        # the flow of every original window slot through the run is known
        # at compile time):
        #   consumed_windows  window indices some compute op reads — ONLY
        #                     these must be concrete and taint-free to
        #                     enter a batch; purely-shuffled slots ride
        #                     through as opaque host-side values
        #   out_sources       per output slot: the original window index
        #                     it passes through from (decode reuses the
        #                     ORIGINAL BitVec object — identical object
        #                     identity and annotations to an interpreter
        #                     shuffle), or -1 for kernel-computed values
        self.consumed_windows = (
            frozenset(range(touch)) if consumed_windows is None
            else frozenset(consumed_windows))
        self.out_sources = (
            tuple([-1] * out_len) if out_sources is None
            else tuple(out_sources))
        # terminal batched-JUMPI fork (None for straight-line runs)
        self.fork = fork
        # ((mem-log index, value predicates), ...) for memory stores
        # whose engine hooks are conditionally transparent: decode bails
        # any row whose written value trips a predicate, so the hook
        # fires on the per-state replay exactly as it always did
        self.mem_guards = tuple(mem_guards)
        # the run stops right before a JUMPI it did NOT fork (feature
        # off / no fork prefix): completed rows exit the batch dialect
        # to the interpreter's fork handler and count as fallback exits
        self.cut_at_jumpi = cut_at_jumpi
        # terminal RETURN/STOP (None for non-halting runs); mutually
        # exclusive with `fork`
        self.halt = halt
        # the run contains a promoted CALLDATALOAD: every row's decode
        # takes the symbolic lane's structural replay (the pushed word
        # is a term handle by construction)
        self.has_calldataload = has_calldataload
        # the run stops right before a RETURN/STOP (halt promotion off)
        # or a CALLDATALOAD (symbolic lane off): completed rows exit
        # the batch dialect and count as fallback exits — dialect and
        # symbolic-operand reasons respectively, the symlane on/off
        # comparator
        self.cut_at_halt = cut_at_halt
        self.cut_at_calldataload = cut_at_calldataload

    def __len__(self):
        return len(self.ops)

    def __repr__(self):
        return (f"<Run pc {self.start_pc}..{self.end_pc} "
                f"{len(self.ops)} ops touch={self.touch} "
                f"out={self.out_len}>")


def _compile_one(ins) -> Optional[MicroOp]:
    """Instr -> MicroOp, or None when the instruction cannot enter a
    batch (symbolic PUSH operand, op outside the fast set)."""
    name = ins.opcode
    spec = BY_NAME.get(name)
    if spec is None:
        return None
    gas = (spec.gas_min, spec.gas_max)
    if name.startswith("PUSH"):
        value = ins.argument_int if ins.argument is not None else 0
        if value is None:
            return None  # deploy-time-patched symbolic operand
        return MicroOp("push", tuple(words.word_from_int(value)), *gas,
                       name)
    if name.startswith("DUP"):
        return MicroOp("dup", int(name[3:]), *gas, name)
    if name.startswith("SWAP"):
        return MicroOp("swap", int(name[4:]), *gas, name)
    if name in _BIN_OPS:
        return MicroOp("bin", _BIN_OPS[name], *gas, name)
    if name in _SHIFT_OPS:
        return MicroOp(_SHIFT_OPS[name], None, *gas, name)
    if name == "POP":
        return MicroOp("pop", None, *gas, name)
    if name == "NOT":
        return MicroOp("not", None, *gas, name)
    if name == "ISZERO":
        return MicroOp("iszero", None, *gas, name)
    if name == "BYTE":
        return MicroOp("byte", None, *gas, name)
    if name == "SIGNEXTEND":
        return MicroOp("signextend", None, *gas, name)
    if name in ("MLOAD", "MSTORE", "MSTORE8"):
        return MicroOp(name.lower(), None, *gas, name)
    if name == "MSIZE":
        return MicroOp("msize", None, *gas, name)
    if name == "PC":
        return MicroOp("pc", ins.address, *gas, name)
    if name == "JUMPDEST":
        return MicroOp("nop", None, *gas, name)
    return None


# micro-op kinds that CONSUME their popped operands in a computation (the
# popped values feed limb arithmetic / memory indexing in the kernel, so
# the originating window slots must be concrete). POP discards, DUP/SWAP
# shuffle — their operands ride through opaquely.
_CONSUMING_POPS = {
    "bin": 2, "byte": 2, "shl": 2, "shr": 2, "sar": 2, "signextend": 2,
    "not": 1, "iszero": 1, "mload": 1, "mstore": 2, "mstore8": 2,
}


class _Provenance:
    """Compile-time abstract stack tracking where every slot comes from:
    ("o", d) = the original entry d below the run-start top (1-based),
    None = kernel-computed. Shuffles are data-independent, so this flow
    is exact, not approximate."""

    def __init__(self):
        self.virtual = []      # entries above the untouched stack region
        self.below = 0         # deepest original entry materialized
        self.consumed = set()  # original depths feeding computations
        self.max_height = 0    # peak of len(virtual) - below

    def _ensure(self, needed: int) -> None:
        while len(self.virtual) < needed:
            self.below += 1
            self.virtual.insert(0, ("o", self.below))

    def _pop(self):
        self._ensure(1)
        return self.virtual.pop()

    def apply(self, op: MicroOp) -> None:
        kind = op.kind
        consuming = _CONSUMING_POPS.get(kind, 0)
        if consuming:
            for _ in range(consuming):
                item = self._pop()
                if item is not None:
                    self.consumed.add(item[1])
            if BY_NAME[op.name].pushes:
                self.virtual.append(None)
        elif kind == "pop":
            self._pop()
        elif kind == "calldataload":
            # the popped offset rides opaquely (its concreteness is
            # judged per ROW by the symbolic lane's tag sim, not at
            # compile time); the pushed word is a term handle the
            # kernel never computes
            self._pop()
            self.virtual.append(None)
        elif kind == "dup":
            self._ensure(op.arg)
            self.virtual.append(self.virtual[-op.arg])
        elif kind == "swap":
            self._ensure(op.arg + 1)
            self.virtual[-1], self.virtual[-op.arg - 1] = \
                self.virtual[-op.arg - 1], self.virtual[-1]
        elif kind in ("push", "pc", "msize"):
            self.virtual.append(None)
        # "nop" (JUMPDEST): no stack effect
        self.max_height = max(self.max_height,
                              len(self.virtual) - self.below)


def _instr_width(ins) -> int:
    argument = ins.argument
    if argument is None:
        return 1
    return 1 + len(argument)


def extract_run(summary, pc: int,
                interior_blocked: Callable[[str], bool],
                first_post_blocked: Callable[[str], bool],
                guards_for: Optional[Callable] = None,
                allow_fork: bool = False,
                allow_halt: bool = False,
                allow_symbolic: bool = False) -> Optional[Run]:
    """Compile the straight-line run starting at `pc` inside its
    pre-analysis CFG basic block, or None when no batchable run (>= MIN_RUN_OPS) starts
    there. `interior_blocked(name)` must be True for opcodes carrying any
    non-transparent pre/post/instr hook; the FIRST opcode may carry pre
    hooks (the stepper fires them host-side per state) but its post hooks
    must be transparent (`first_post_blocked`). `guards_for(name)` may
    return value predicates when EVERY non-transparent hook on a memory
    store is conditionally transparent (frontier_transparent_unless) —
    the op then enters the run guarded instead of cutting it. With
    `allow_fork`, a run may terminate in the block's JUMPI as a batched
    fork (its own pre/post hooks fire host-side in the fork epilogue,
    exactly as the interpreter fires them); with `allow_halt`, in the
    block's RETURN/STOP as a terminal halt micro-op (same host-side
    hook discipline, in the stepper's halt epilogue). `allow_symbolic`
    (the symbolic-value lane) additionally promotes CALLDATALOAD into
    runs — its hooks gate it exactly like any other interior op."""
    block = summary.cfg.block_at(pc)
    if block is None:
        return None
    start_idx = None
    for i, ins in enumerate(block.instrs):
        if ins.address == pc:
            start_idx = i
            break
    if start_idx is None:
        return None

    ops: List[MicroOp] = []
    op_pcs: List[int] = []
    prov = _Provenance()
    has_mem = has_mload = False
    has_calldataload = False
    mem_log_count = 0
    mem_guards = []
    fork: Optional[ForkInfo] = None
    halt: Optional[HaltInfo] = None
    cut_name = None
    end_pc = pc
    for i in range(start_idx, len(block.instrs)):
        ins = block.instrs[i]
        name = ins.opcode
        cut_name = name
        if (allow_fork and name == "JUMPI" and ops):
            # terminal batched fork: pop destination then condition
            # (tracked, NOT consumed — a symbolic condition rides
            # through opaquely; decode rebuilds the exact constraint
            # terms the interpreter's JUMPI handler would append)
            spec = BY_NAME["JUMPI"]
            dest_item = prov._pop()
            cond_item = prov._pop()
            ops.append(MicroOp("jumpi", None, spec.gas_min, spec.gas_max,
                               "JUMPI"))
            op_pcs.append(ins.address)
            end_pc = ins.address + _instr_width(ins)
            fork = ForkInfo(ins.address, 0, 0)
            # stash raw provenance items; converted after the loop
            fork_items = (dest_item, cond_item)
            break
        if allow_halt and name in ("RETURN", "STOP"):
            # terminal halt: RETURN pops offset then length (tracked,
            # NOT consumed — the stepper's halt epilogue needs the
            # exact popped objects, and an opaque operand bails the
            # row per the lane's tag sim); STOP pops nothing. The
            # halting instruction's pre hooks fire host-side in the
            # epilogue on the reconstructed pre-halt state, and its
            # transaction-end path runs the interpreter's own
            # machinery — so no hook gating is needed here.
            spec = BY_NAME[name]
            kind = name.lower()
            halt_items = (None, None)
            if kind == "return":
                offset_item = prov._pop()
                length_item = prov._pop()
                halt_items = (offset_item, length_item)
            ops.append(MicroOp(kind, None, spec.gas_min, spec.gas_max,
                               name))
            op_pcs.append(ins.address)
            end_pc = ins.address + _instr_width(ins)
            halt = HaltInfo(ins.address, kind)
            break
        lane_op = (name == "CALLDATALOAD" and allow_symbolic)
        if not is_fast_op(name) and not lane_op:
            break
        guards = None
        if i == start_idx:
            if first_post_blocked(name):
                return None
        elif interior_blocked(name):
            guards = guards_for(name) if guards_for is not None else None
            if guards is None or name not in ("MSTORE", "MSTORE8"):
                # only value-writing stores are guardable: the predicate
                # needs a dynamically-known written word to judge
                break
        if lane_op:
            spec = BY_NAME["CALLDATALOAD"]
            op = MicroOp("calldataload", None, spec.gas_min,
                         spec.gas_max, name)
        else:
            op = _compile_one(ins)
        if op is None:
            break
        prov.apply(op)
        if op.kind == "mload":
            has_mem = has_mload = True
        elif op.kind in ("mstore", "mstore8"):
            if guards:
                mem_guards.append((mem_log_count, tuple(guards)))
            mem_log_count += 1
            has_mem = True
        elif op.kind == "calldataload":
            has_calldataload = True
        ops.append(op)
        op_pcs.append(ins.address)
        end_pc = ins.address + _instr_width(ins)
        cut_name = None
    # fork runs need one prefix op (the fork is the win even on short
    # runs); halt runs may be BARE — a cohort landing directly on a
    # STOP/RETURN settles through the halt epilogue with no kernel
    # work, which is exactly what removes the per-state STOP wall on
    # dispatch fall-throughs; calldataload-bearing runs are worth a
    # batch at 2 ops (the [PUSH offset, CALLDATALOAD] ladder shape)
    if fork is not None:
        min_ops = 2
    elif halt is not None:
        min_ops = 1
    elif has_calldataload:
        min_ops = 2
    else:
        min_ops = MIN_RUN_OPS
    if len(ops) < min_ops:
        return None
    touch = prov.below

    def _source(item):
        return -1 if item is None else touch - item[1]

    if fork is not None:
        dest_item, cond_item = fork_items
        fork.dest_source = _source(dest_item)
        fork.cond_source = _source(cond_item)
    if halt is not None and halt.kind == "return":
        offset_item, length_item = halt_items
        halt.offset_source = _source(offset_item)
        halt.length_source = _source(length_item)
    return Run(
        ops, pc, end_pc,
        touch=touch, out_len=len(prov.virtual),
        max_height=prov.max_height,
        has_mem=has_mem, has_mload=has_mload,
        first_instr=block.instrs[start_idx],
        op_pcs=op_pcs,
        consumed_windows=[touch - d for d in prov.consumed],
        out_sources=[-1 if item is None else touch - item[1]
                     for item in prov.virtual],
        fork=fork, mem_guards=mem_guards,
        cut_at_jumpi=(fork is None and cut_name == "JUMPI"),
        halt=halt, has_calldataload=has_calldataload,
        cut_at_halt=(halt is None and cut_name in ("RETURN", "STOP")),
        cut_at_calldataload=(cut_name == "CALLDATALOAD"),
        # process-unique token: the kernel's program cache keys
        # encoded programs by it (object ids would be unsafe — the allocator
        # recycles them, and a stale hit would run the WRONG program)
        key=next(_RUN_TOKENS),
    )


_RUN_TOKENS = iter(range(1, 1 << 62))
