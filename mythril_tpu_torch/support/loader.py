"""DynLoader — cached on-chain reads for dynamic analysis
(reference mythril/support/loader.py:104: read_storage :30, read_balance
:50, dynld code fetch :66; consumed by Storage lazy load, account.py, and
the EXTCODE* handlers)."""

import functools
import logging
from typing import Optional

from mythril_tpu_torch.disasm.disassembly import Disassembly

log = logging.getLogger(__name__)


class DynLoader:
    def __init__(self, eth, active: bool = True):
        """eth: an EthJsonRpc-compatible client; active: fetch code of
        unknown callee contracts during execution (--no-onchain-data off).
        """
        self.eth = eth
        self.active = active

    @functools.lru_cache(2 ** 12)
    def read_storage(self, contract_address: str, index: int) -> str:
        if self.eth is None:
            raise ValueError("no RPC client configured")
        return self.eth.eth_getStorageAt(contract_address, index)

    @functools.lru_cache(2 ** 12)
    def read_balance(self, address: str) -> int:
        if self.eth is None:
            raise ValueError("no RPC client configured")
        return self.eth.eth_getBalance(address)

    @functools.lru_cache(2 ** 12)
    def dynld(self, dependency_address: str) -> Optional[Disassembly]:
        """Fetch and disassemble callee code for inter-contract analysis."""
        if not self.active or self.eth is None:
            return None
        log.debug("dynld %s", dependency_address)
        code = self.eth.eth_getCode(dependency_address)
        if code in (None, "", "0x"):
            return None
        return Disassembly(code[2:] if code.startswith("0x") else code)
