"""Linear-sweep EVM disassembler.

Behavioral parity with reference mythril/disassembler/asm.py (bytes ->
instruction records with address/opcode/argument, EASM text). The record is
a NamedTuple rather than a dict so the engine can index it cheaply.
"""

import re
from typing import List, NamedTuple, Optional

from mythril_tpu_torch.support import opcodes


class Instr(NamedTuple):
    address: int          # byte offset in the code
    opcode: str           # mnemonic, e.g. "PUSH2"
    byte: int             # raw opcode byte
    # PUSH operand: bytes when fully concrete, tuple of int/BitVec(8) when
    # the code carries symbolic bytes (immutables patched at deploy time),
    # else None
    argument: Optional[object]

    @property
    def argument_int(self) -> Optional[int]:
        if self.argument is None:
            return None
        if isinstance(self.argument, bytes):
            return int.from_bytes(self.argument, "big")
        return None  # symbolic operand

    def to_easm(self) -> str:
        if isinstance(self.argument, bytes):
            return f"{self.address} {self.opcode} 0x{self.argument.hex()}"
        if self.argument is not None:
            return f"{self.address} {self.opcode} <symbolic>"
        return f"{self.address} {self.opcode}"


def strip_metadata(code):
    """Drop the CBOR metadata trailer solc appends (…a264…0033 / …a165…)."""
    if not isinstance(code, bytes):
        return code  # symbolic code: trailer scan needs concrete bytes
    if len(code) >= 2:
        trailer_len = int.from_bytes(code[-2:], "big")
        if 0 < trailer_len <= len(code) - 2:
            candidate = code[-(trailer_len + 2):-2]
            # CBOR map header 0xa1/0xa2 with 'ipfs'/'bzzr'/'solc' keys
            if candidate[:1] in (b"\xa1", b"\xa2") and (
                b"ipfs" in candidate or b"bzzr" in candidate or b"solc" in candidate
            ):
                return code[: -(trailer_len + 2)]
    return code


def disassemble(code) -> List[Instr]:
    """Linear sweep; PUSH operands are consumed (truncated operand is padded).

    `code` is bytes, or a sequence of int/BitVec(8) entries when deploy-time
    patching left symbolic bytes in the runtime code (solidity immutables —
    reference asm.py:109-141 threads tuples the same way). A symbolic byte
    in an *opcode* position disassembles as INVALID; symbolic bytes only
    ever appear in PUSH operands in practice."""
    out: List[Instr] = []
    pc = 0
    length = len(code)
    symbolic_code = not isinstance(code, (bytes, bytearray))
    while pc < length:
        byte = code[pc]
        if not isinstance(byte, int):
            out.append(Instr(pc, "INVALID", 0xFE, None))
            pc += 1
            continue
        name = opcodes.name_of(byte)
        width = opcodes.push_width(name)
        if width:
            operand = tuple(code[pc + 1 : pc + 1 + width])
            if len(operand) < width:
                operand = operand + (0,) * (width - len(operand))
            if not symbolic_code or all(isinstance(b, int) for b in operand):
                operand = bytes(operand)
            out.append(Instr(pc, name, byte, operand))
            pc += 1 + width
        else:
            out.append(Instr(pc, name, byte, None))
            pc += 1
    return out


def instrs_to_easm(instrs: List[Instr]) -> str:
    return "\n".join(i.to_easm() for i in instrs) + "\n"


_EASM_LINE = re.compile(
    r"^(?:(\d+)\s+)?([A-Z][A-Z0-9]*|UNKNOWN_0x[0-9a-fA-F]{2})"
    r"(?:\s+(0x[0-9a-fA-F]+|@[A-Za-z_][A-Za-z0-9_]*))?$"
)
_LABEL_LINE = re.compile(r"^:([A-Za-z_][A-Za-z0-9_]*)$")


def easm_to_code(easm: str) -> bytes:
    """Assemble EASM text to bytecode.

    Supports labels to avoid hand-counted jump offsets:
        :loop           defines a label at the next instruction
        PUSH2 @loop     references it (operand patched after layout)
    """
    blob = bytearray()
    labels = {}
    fixups = []  # (offset, width, label_name, source_line)
    for line in easm.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        label_match = _LABEL_LINE.match(line)
        if label_match:
            name = label_match.group(1)
            if name in labels:
                raise ValueError(f"duplicate label :{name}")
            labels[name] = len(blob)
            continue
        match = _EASM_LINE.match(line)
        if not match:
            raise ValueError(f"cannot parse EASM line: {line!r}")
        _, mnemonic, arg = match.groups()
        if mnemonic.startswith("UNKNOWN_0x"):
            if arg is not None:
                raise ValueError(f"{mnemonic} takes no operand: {line!r}")
            blob.append(int(mnemonic[10:], 16))
            continue
        spec = opcodes.BY_NAME.get(mnemonic)
        if spec is None:
            raise ValueError(f"unknown mnemonic {mnemonic!r}")
        blob.append(spec.byte)
        width = opcodes.push_width(mnemonic)
        if width:
            if arg is None:
                raise ValueError(f"{mnemonic} needs an operand")
            if arg.startswith("@"):
                fixups.append((len(blob), width, arg[1:], line))
                blob += b"\x00" * width
            else:
                try:
                    blob += int(arg, 16).to_bytes(width, "big")
                except OverflowError:
                    raise ValueError(
                        f"operand {arg} does not fit {mnemonic}: {line!r}"
                    ) from None
        elif arg is not None:
            raise ValueError(f"{mnemonic} takes no operand: {line!r}")
    for offset, width, name, line in fixups:
        if name not in labels:
            raise ValueError(f"undefined label @{name}: {line!r}")
        try:
            blob[offset:offset + width] = labels[name].to_bytes(width, "big")
        except OverflowError:
            raise ValueError(
                f"label @{name}={labels[name]} does not fit: {line!r}"
            ) from None
    return bytes(blob)
