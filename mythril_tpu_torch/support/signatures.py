"""4-byte function-selector database (reference mythril/support/signatures.py:225).

Lookups resolve `_function_0x...` names in reports. The built-in selectors
below and any added at run time live in memory; a sqlite DB at
<MYTHRIL_GPU_CACHE_DIR>/signatures.db, when one exists, is read (never
written). There is no online lookup."""

import os
import sqlite3
import threading
from typing import List, Optional

from mythril_tpu_torch.utils.keccak import function_selector

_lock = threading.Lock()

# common selectors so reports are readable out of the box
_BUILTIN_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "totalSupply()",
    "allowance(address,address)",
    "owner()",
    "kill()",
    "withdraw()",
    "withdraw(uint256)",
    "deposit()",
    "mint(address,uint256)",
    "burn(uint256)",
    "fallback()",
    "setOwner(address)",
    "claimOwnership()",
    "transferOwnership(address)",
    "initialize()",
    "pause()",
    "unpause()",
]


class SignatureDB:
    _instance = None

    def __new__(cls, path: Optional[str] = None):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._init(path)
        return cls._instance

    def _init(self, path: Optional[str]):
        from mythril_tpu_torch.service import cache_dir

        self.path = path or os.path.join(cache_dir(), "signatures.db")
        self._added = {}  # byte sig -> set of text sigs
        self.add_signatures(_BUILTIN_SIGNATURES)

    def add(self, byte_sig: str, text_sig: str) -> None:
        with _lock:
            self._added.setdefault(byte_sig.lower(), set()).add(text_sig)

    def add_signatures(self, text_signatures: List[str]) -> None:
        for text_sig in text_signatures:
            self.add("0x" + function_selector(text_sig).hex(), text_sig)

    def get(self, byte_sig: str) -> List[str]:
        """Every text signature of `byte_sig`, sorted (the order of the
        reference's primary-key lookup)."""
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        byte_sig = byte_sig.lower()
        with _lock:
            found = set(self._added.get(byte_sig, ()))
        if os.path.isfile(self.path):
            conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
            try:
                found.update(row[0] for row in conn.execute(
                    "SELECT text_sig FROM signatures WHERE byte_sig = ?",
                    (byte_sig,)))
            finally:
                conn.close()
        return sorted(found)

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (support/model.clear_caches)."""
        cls._instance = None
