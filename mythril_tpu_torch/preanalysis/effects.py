"""Per-code effect summaries over the recovered CFG.

A CodeSummary answers two static questions consumers gate on:

  reachable_opcodes   which opcodes can execute at all, starting from
                      pc 0 (the entry of every message call and of the
                      creation frame). Exact over a RESOLVED CFG;
                      degrades to the linear-sweep opcode union when any
                      reachable jump is unresolved — still sound (the
                      engine can only execute pcs in instruction_list;
                      see cfg.py's alignment note), just unrefined.
  cone_opcodes(pc)    which opcodes the rest of the transaction can
                      execute from `pc` onward within this code object.
                      None when the forward cone touches an unresolved
                      jump (no static bound exists).

Per-function effect summaries project the dispatcher's selector map
(Disassembly.function_entries) through cone_opcodes and intersect with
EFFECT_OPCODES — the hint payload handed to the search strategies.
"""

from typing import Dict, Optional

from mythril_tpu_torch.preanalysis.cfg import ControlFlowGraph, build_cfg

# opcodes whose execution mutates world state, moves value, or leaves the
# current code object (the "effects" of a function summary)
EFFECT_OPCODES = frozenset({
    "SSTORE", "TSTORE",
    "CALL", "CALLCODE", "DELEGATECALL", "STATICCALL",
    "CREATE", "CREATE2",
    "SELFDESTRUCT",
})

# environment reads detectors key on (origin/timestamp/number/etc.):
# tracked in summaries so consumers can reason about "reads predictable
# state" separately from "writes state"
ENV_READ_OPCODES = frozenset({
    "ORIGIN", "TIMESTAMP", "NUMBER", "DIFFICULTY", "PREVRANDAO",
    "COINBASE", "GASLIMIT", "BLOCKHASH", "BALANCE", "SELFBALANCE",
    "BLOBHASH", "BLOBBASEFEE", "BASEFEE",
})


class FunctionEffects:
    """Static summary of one dispatcher entry."""

    __slots__ = ("selector", "entry_pc", "effects", "env_reads", "bounded")

    def __init__(self, selector: str, entry_pc: int,
                 effects: frozenset, env_reads: frozenset, bounded: bool):
        self.selector = selector
        self.entry_pc = entry_pc
        self.effects = effects        # EFFECT_OPCODES seen in the cone
        self.env_reads = env_reads    # ENV_READ_OPCODES seen in the cone
        self.bounded = bounded        # False: cone hit an unresolved jump

    @property
    def effect_free(self) -> bool:
        return self.bounded and not self.effects

    def __repr__(self):
        return (f"<FunctionEffects 0x{self.selector} @{self.entry_pc} "
                f"effects={sorted(self.effects)} bounded={self.bounded}>")


class CodeSummary:
    """Static pre-analysis of ONE code object (a Disassembly)."""

    def __init__(self, disassembly):
        self.cfg: ControlFlowGraph = build_cfg(disassembly)
        instrs = disassembly.instruction_list
        self.linear_opcodes = frozenset(i.opcode for i in instrs)
        self.resolved = self.cfg.resolved
        if self.resolved:
            reachable = set()
            for start in self.cfg.reachable_starts:
                reachable |= self.cfg.blocks[start].opcode_names()
            self.reachable_opcodes = frozenset(reachable)
        else:
            self.reachable_opcodes = self.linear_opcodes
        self._cone_cache: Dict[int, Optional[frozenset]] = {}
        self.function_effects: Dict[str, FunctionEffects] = {
            selector: self._summarize_function(selector, entry_pc)
            for selector, entry_pc in disassembly.function_entries.items()
        }

    # -- cones ---------------------------------------------------------------

    def cone_opcodes(self, pc: int) -> Optional[frozenset]:
        """Opcodes executable from `pc` to the end of the transaction
        within this code object; None when statically unboundable."""
        block = self.cfg.block_at(pc)
        if block is None:
            return None
        cached = self._cone_cache.get(block.start, _MISS)
        if cached is not _MISS:
            return cached
        closure = self.cfg.forward_closure(block.start)
        if closure is None:
            cone = None
        else:
            ops = set()
            for start in closure:
                ops |= self.cfg.blocks[start].opcode_names()
            cone = frozenset(ops)
        self._cone_cache[block.start] = cone
        return cone

    def inert_at(self, pc: int, interesting: frozenset) -> bool:
        """True iff every path from `pc` to transaction end provably avoids
        all of `interesting` (conservative: unresolved cones are never
        inert)."""
        cone = self.cone_opcodes(pc)
        return cone is not None and not (cone & interesting)

    def _summarize_function(self, selector: str,
                            entry_pc: int) -> FunctionEffects:
        cone = self.cone_opcodes(entry_pc)
        if cone is None:
            # unbounded cone: assume every effect (sound default)
            return FunctionEffects(selector, entry_pc, EFFECT_OPCODES,
                                   ENV_READ_OPCODES, bounded=False)
        return FunctionEffects(
            selector, entry_pc,
            cone & EFFECT_OPCODES, cone & ENV_READ_OPCODES, bounded=True)


_MISS = object()
