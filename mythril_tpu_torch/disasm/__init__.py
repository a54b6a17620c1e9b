"""Bytecode -> instruction stream, EASM rendering, selector discovery."""

from mythril_tpu_torch.disasm.asm import Instr, disassemble, instrs_to_easm  # noqa: F401
from mythril_tpu_torch.disasm.disassembly import Disassembly  # noqa: F401
