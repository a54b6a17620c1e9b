"""EVMContract — bytecode holder (reference mythril/ethereum/evmcontract.py:115)."""

from typing import Optional

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.utils.keccak import keccak256


def _hex_to_bytes(code) -> bytes:
    if code is None:
        return b""
    if isinstance(code, bytes):
        return code
    text = code.strip()
    if text.startswith("0x"):
        text = text[2:]
    return bytes.fromhex(text) if text else b""


class EVMContract:
    def __init__(self, code="", creation_code="", name: str = "MAIN",
                 enable_online_lookup: bool = False):
        self.code_bytes = _hex_to_bytes(code)
        self.creation_code_bytes = _hex_to_bytes(creation_code)
        self.name = name
        self._disassembly: Optional[Disassembly] = None
        self._creation_disassembly: Optional[Disassembly] = None

    @property
    def code(self) -> str:
        return "0x" + self.code_bytes.hex()

    @property
    def creation_code(self) -> Optional[str]:
        if not self.creation_code_bytes:
            return None
        return "0x" + self.creation_code_bytes.hex()

    @property
    def is_create_mode(self) -> bool:
        return bool(self.creation_code_bytes) and not self.code_bytes

    @property
    def bytecode_hash(self) -> str:
        return "0x" + keccak256(self.code_bytes).hex()

    @property
    def disassembly(self) -> Disassembly:
        if self._disassembly is None:
            self._disassembly = Disassembly(self.code_bytes)
        return self._disassembly

    @property
    def creation_disassembly(self) -> Disassembly:
        if self._creation_disassembly is None:
            self._creation_disassembly = Disassembly(self.creation_code_bytes)
        return self._creation_disassembly

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()
