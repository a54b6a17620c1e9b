"""Static CFG recovery over a Disassembly.

Basic blocks are cut at JUMPDESTs and after terminators; jump targets are
resolved by an abstract-stack dataflow pass (the TVM pattern of analysis
passes ahead of lowering): each block's transfer function tracks the
concrete values PUSH placed on the stack — through DUP/SWAP and arbitrary
pop/push arity of every other opcode — and the per-block input stacks are
joined to a fixpoint. This resolves the solc dispatcher ladder, plain
`PUSH target JUMP`, and single-call-site internal-function returns
(the return address is pushed by the caller and survives the join).

Anything the dataflow cannot pin (calldata-derived targets, multi-site
internal returns whose join conflicts) marks the jump — and the CFG —
UNRESOLVED. Consumers degrade soundly: an unresolved CFG means "every
opcode in the code is reachable" (see effects.CodeSummary), never a
refined claim.

Soundness note on linear-sweep alignment: EVM jumpdest validity is
computed by the same linear sweep execution uses (bytes inside PUSH
operands are never valid jump targets), so every pc the engine can
execute appears in `Disassembly.instruction_list` — block-level
reasoning over that list covers all executable code of the object.
"""

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.support.opcodes import BY_NAME

# opcodes that end a basic block with no fall-through
HALTING_OPS = frozenset(
    {"STOP", "RETURN", "REVERT", "SELFDESTRUCT", "INVALID"}
)
# deepest abstract stack tracked per block (EVM's limit is 1024; constants
# relevant to jump resolution live near the top)
STACK_TRACK_DEPTH = 48
# dataflow fixpoint bound. The join is monotone per top-aligned position
# (constant -> unknown happens at most once, lengths only shrink), so a
# block's input can change at most ~2 x STACK_TRACK_DEPTH times; each
# worklist entry corresponds to one such change (plus at most one stale
# duplicate already queued), so this cap sits far above the bound and
# should never be hit. If it IS hit, the whole recovery is declared
# failed (consumers degrade to "everything reachable"): silently skipping
# a propagation could leave a stale constant in a successor's input and
# resolve a jump to the wrong target, which would make gating unsound.
MAX_DATAFLOW_VISITS_PER_BLOCK = 16 * STACK_TRACK_DEPTH


class BasicBlock:
    __slots__ = ("start", "end", "instrs", "successors", "unresolved",
                 "halts")

    def __init__(self, instrs):
        self.instrs = instrs
        self.start = instrs[0].address
        self.end = instrs[-1].address
        # statically-resolved successor block start pcs
        self.successors: List[int] = []
        # ends in a JUMP/JUMPI whose target the dataflow could not pin
        self.unresolved = False
        self.halts = instrs[-1].opcode in HALTING_OPS

    def opcode_names(self) -> frozenset:
        return frozenset(i.opcode for i in self.instrs)

    def __repr__(self):
        return (f"<BasicBlock {self.start}..{self.end} "
                f"succ={self.successors}"
                f"{' UNRESOLVED' if self.unresolved else ''}>")


_UNKNOWN = None  # abstract stack entry: statically unknown value


def _join_stacks(a: Optional[list], b: list) -> Tuple[list, bool]:
    """Top-aligned join; returns (joined, changed_vs_a). Entries below the
    shallower stack's depth are dropped (reads past the tracked depth
    yield unknown anyway)."""
    if a is None:
        return list(b), True
    depth = min(len(a), len(b))
    joined = []
    for i in range(1, depth + 1):
        va, vb = a[-i], b[-i]
        joined.append(va if va == vb else _UNKNOWN)
    joined.reverse()
    return joined, joined != a


class ControlFlowGraph:
    """blocks: start pc -> BasicBlock; `resolved` is False when any block
    reachable from pc 0 ends in a jump the dataflow could not pin."""

    def __init__(self, disassembly):
        self.blocks: Dict[int, BasicBlock] = {}
        self.block_starts: List[int] = []
        self._block_of_pc: Dict[int, int] = {}
        self._next_block: Dict[int, Optional[int]] = {}
        self.resolved = False
        # the dataflow overran its fixpoint bound: no resolution claim
        # from this recovery may be trusted (degrade everywhere)
        self.recovery_failed = False
        # block starts the dataflow actually processed: a block OUTSIDE
        # this set kept its constructor defaults (successors=[],
        # unresolved=False) and must never support a bounded-cone claim —
        # the engine can still land there through an unresolved dynamic
        # jump elsewhere, and its real successors were never computed
        self._dataflow_visited: set = set()
        self.reachable_starts: frozenset = frozenset()
        self._build(disassembly)

    def block_at(self, pc: int) -> Optional[BasicBlock]:
        start = self._block_of_pc.get(pc)
        return self.blocks.get(start) if start is not None else None

    # -- construction --------------------------------------------------------

    def _build(self, disassembly) -> None:
        instrs = disassembly.instruction_list
        if not instrs:
            return
        valid_dests = disassembly.valid_jump_destinations

        leaders = {0}
        for i, ins in enumerate(instrs[:-1]):
            if ins.opcode in ("JUMP", "JUMPI") or ins.opcode in HALTING_OPS:
                leaders.add(i + 1)
        for i, ins in enumerate(instrs):
            if ins.opcode == "JUMPDEST":
                leaders.add(i)
        ordered = sorted(leaders)
        for idx, lead in enumerate(ordered):
            stop = ordered[idx + 1] if idx + 1 < len(ordered) else len(instrs)
            block = BasicBlock(instrs[lead:stop])
            self.blocks[block.start] = block
            for ins in block.instrs:
                self._block_of_pc[ins.address] = block.start
        self.block_starts = sorted(self.blocks)
        for idx, start in enumerate(self.block_starts):
            self._next_block[start] = (
                self.block_starts[idx + 1]
                if idx + 1 < len(self.block_starts) else None
            )

        self._solve_dataflow(valid_dests)
        self._compute_reachability()

    def _solve_dataflow(self, valid_dests) -> None:
        """Propagate abstract input stacks block-to-block to a fixpoint,
        resolving jump targets from the simulated stack at each exit."""
        entry = self.blocks.get(0)
        if entry is None:
            return
        in_stacks: Dict[int, Optional[list]] = {0: []}
        visits: Dict[int, int] = {}
        self._dataflow_visited.add(0)
        work = [0]
        while work:
            start = work.pop()
            visits[start] = visits.get(start, 0) + 1
            if visits[start] > MAX_DATAFLOW_VISITS_PER_BLOCK:
                # should be unreachable (see the bound's derivation above);
                # declaring the recovery failed is the only sound exit —
                # an unpropagated join may have left stale constants
                self.recovery_failed = True
                return
            block = self.blocks[start]
            out_stack, targets = self._transfer(
                block, list(in_stacks.get(start) or []), valid_dests)
            block.successors = []
            block.unresolved = False
            last = block.instrs[-1]
            if last.opcode == "JUMP":
                if targets is _UNRESOLVED_TARGET:
                    block.unresolved = True
                else:
                    block.successors.extend(targets)
            elif last.opcode == "JUMPI":
                if targets is _UNRESOLVED_TARGET:
                    block.unresolved = True
                else:
                    block.successors.extend(targets)
                fall = self._fallthrough(start)
                if fall is not None:
                    block.successors.append(fall)
            elif not block.halts:
                fall = self._fallthrough(start)
                if fall is not None:
                    block.successors.append(fall)
            for succ in block.successors:
                self._dataflow_visited.add(succ)
                joined, changed = _join_stacks(
                    in_stacks.get(succ), out_stack)
                if changed or succ not in in_stacks:
                    in_stacks[succ] = joined
                    work.append(succ)

    def _fallthrough(self, start: int) -> Optional[int]:
        return self._next_block.get(start)

    @staticmethod
    def _transfer(block: BasicBlock, stack: list, valid_dests):
        """Simulate the block over an abstract stack (entries: int or
        unknown). Returns (exit stack, jump targets) where targets is a
        list of resolved pcs for a trailing JUMP/JUMPI, the _UNRESOLVED
        sentinel when the target is unknown, or () otherwise."""

        def pop():
            return stack.pop() if stack else _UNKNOWN

        targets = ()
        for ins in block.instrs:
            name = ins.opcode
            if name.startswith("PUSH"):
                stack.append(ins.argument_int)  # None for symbolic operand
            elif name.startswith("DUP"):
                n = int(name[3:])
                stack.append(stack[-n] if len(stack) >= n else _UNKNOWN)
            elif name.startswith("SWAP"):
                n = int(name[4:])
                if len(stack) >= n + 1:
                    stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
                else:
                    # part of the swapped pair is below the tracked window:
                    # both become unknown
                    if stack:
                        stack[-1] = _UNKNOWN
                    while len(stack) < n + 1:
                        stack.insert(0, _UNKNOWN)
                    stack[-n - 1] = _UNKNOWN
            elif name in ("JUMP", "JUMPI"):
                target = pop()
                if name == "JUMPI":
                    pop()  # condition
                if target is _UNKNOWN:
                    targets = _UNRESOLVED_TARGET
                elif target in valid_dests:
                    targets = [target]
                else:
                    targets = []  # static jump to an invalid dest: halts
            else:
                spec = BY_NAME.get(name)
                pops = spec.pops if spec else 0
                pushes = spec.pushes if spec else 0
                for _ in range(pops):
                    pop()
                stack.extend([_UNKNOWN] * pushes)
            if len(stack) > STACK_TRACK_DEPTH:
                del stack[: len(stack) - STACK_TRACK_DEPTH]
        return stack, targets

    def _compute_reachability(self) -> None:
        """BFS from pc 0; an unresolved jump in a reachable block poisons
        the whole recovery (resolved=False)."""
        if 0 not in self.blocks or self.recovery_failed:
            return
        seen = {0}
        work = [0]
        resolved = True
        while work:
            block = self.blocks[work.pop()]
            if block.unresolved:
                resolved = False
            for succ in block.successors:
                if succ not in seen and succ in self.blocks:
                    seen.add(succ)
                    work.append(succ)
        self.reachable_starts = frozenset(seen)
        self.resolved = resolved

    # -- queries -------------------------------------------------------------

    def forward_closure(self, start_pc: int) -> Optional[frozenset]:
        """Block starts reachable from the block containing `start_pc`
        (inclusive); None when the closure touches an unresolved jump OR
        a block the dataflow never processed (its successors are just the
        constructor default, not a result — trusting them would declare
        cones bounded that aren't) — the cone cannot be bounded
        statically."""
        origin = self._block_of_pc.get(start_pc)
        if origin is None or self.recovery_failed:
            return None
        seen = {origin}
        work = [origin]
        while work:
            start = work.pop()
            if start not in self._dataflow_visited:
                return None
            block = self.blocks[start]
            if block.unresolved:
                return None
            for succ in block.successors:
                if succ not in seen and succ in self.blocks:
                    seen.add(succ)
                    work.append(succ)
        return frozenset(seen)


_UNRESOLVED_TARGET = object()


def build_cfg(disassembly) -> ControlFlowGraph:
    return ControlFlowGraph(disassembly)
