"""Disassembly: the code object carried by every account in the engine.

Parity with reference mythril/disassembler/disassembly.py:10 — holds the
bytecode, the instruction list, a pc->instruction index, JUMPDEST set, and
the function-selector -> entry-address map discovered from the solc
dispatcher pattern (reference disassembly.py:42-113).
"""

from typing import Dict, List, Optional

from mythril_tpu_torch.disasm.asm import Instr, disassemble, instrs_to_easm, strip_metadata
from mythril_tpu_torch.utils.keccak import keccak256


def _normalize(code):
    if isinstance(code, bytes):
        return code
    if isinstance(code, bytearray):
        return bytes(code)
    if isinstance(code, str):
        text = code.strip()
        if text.startswith("0x"):
            text = text[2:]
        return bytes.fromhex(text) if text else b""
    if isinstance(code, (tuple, list)):
        # deploy-time-patched code with symbolic bytes (immutables); keep
        # symbolic entries, collapse to bytes when fully concrete
        if all(isinstance(b, int) for b in code):
            return bytes(code)
        return tuple(code)
    raise TypeError(f"unsupported code type {type(code)!r}")


def _concrete_projection(bytecode) -> bytes:
    """Concrete view for hashing/reporting: symbolic bytes read as 0x00."""
    if isinstance(bytecode, bytes):
        return bytecode
    return bytes(b if isinstance(b, int) else 0 for b in bytecode)


class Disassembly:
    def __init__(self, code, enable_online_lookup: bool = False):
        self.bytecode = _normalize(code)
        # the CBOR metadata trailer is data, not code: sweep only the stripped
        # region (reference asm.py:119-122 trims the swarm-hash trailer too)
        self.instruction_list: List[Instr] = disassemble(strip_metadata(self.bytecode))
        self._index_by_address: Dict[int, int] = {
            ins.address: i for i, ins in enumerate(self.instruction_list)
        }
        self.valid_jump_destinations = frozenset(
            ins.address for ins in self.instruction_list if ins.opcode == "JUMPDEST"
        )
        # selector (hex str, no 0x) -> dispatch target pc
        self.function_entries: Dict[str, int] = _find_function_entries(
            self.instruction_list
        )
        # reverse index: entry pc -> selector (function_name_for_pc fires
        # per CFG node during execution, and the preanalysis effect
        # summaries project per-selector cones through it — a linear scan
        # per call was O(functions) on the engine's node-creation path).
        # setdefault keeps the FIRST selector when two selectors share an
        # entry pc, matching the replaced scan's first-match behavior
        self.entry_to_selector: Dict[int, str] = {}
        for selector, pc in self.function_entries.items():
            self.entry_to_selector.setdefault(pc, selector)
        # parity with reference func_hashes/function_name_to_address fields
        self.func_hashes: List[str] = list(self.function_entries)
        self.bytecode_hash: bytes = keccak256(_concrete_projection(self.bytecode))
        # preanalysis.get_code_summary memoizes its CodeSummary here (the
        # code object is immutable); absence of the attribute = not yet
        # computed, None = computed-and-unavailable (symbolic/empty code)

    def __len__(self) -> int:
        return len(self.bytecode)

    def instruction_at(self, pc: int) -> Optional[Instr]:
        idx = self._index_by_address.get(pc)
        return self.instruction_list[idx] if idx is not None else None

    def index_of_address(self, pc: int) -> Optional[int]:
        return self._index_by_address.get(pc)

    def get_easm(self) -> str:
        return instrs_to_easm(self.instruction_list)

    def function_name_for_pc(self, pc: int) -> Optional[str]:
        selector = self.entry_to_selector.get(pc)
        return f"_function_0x{selector}" if selector is not None else None


def _find_function_entries(instrs: List[Instr]) -> Dict[str, int]:
    """Scan the dispatcher: PUSH4 <sel> ... EQ ... PUSH <target> JUMPI.

    Recognizes both the classic `DUP1 PUSH4 EQ PUSH JUMPI` ladder and the
    `PUSH4 DUP2 EQ`-style variants by looking at small windows around each
    PUSH4 (reference disassembly.py:42-53 uses the same pattern idea).
    """
    entries: Dict[str, int] = {}
    for i, ins in enumerate(instrs):
        # symbolic (tuple) operands can't name a selector
        if ins.opcode != "PUSH4" or not isinstance(ins.argument, bytes):
            continue
        window = instrs[i + 1 : i + 5]
        names = [w.opcode for w in window]
        if "EQ" not in names:
            continue
        # find the jump target: the next PUSH before a JUMPI in the window+2
        tail = instrs[i + 1 : i + 6]
        target = None
        for j, w in enumerate(tail):
            if w.opcode == "JUMPI":
                for back in reversed(tail[:j]):
                    if back.opcode.startswith("PUSH") and back.argument is not None:
                        target = back.argument_int
                        break
                break
        if target is not None:
            entries[ins.argument.hex()] = target
    return entries
