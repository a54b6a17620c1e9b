"""Account + Storage (reference laser/ethereum/state/account.py:228).

Storage is a functional SMT array: concrete-create contracts start from
K(0) (all slots zero); on-chain/unknown contracts get a free symbolic array.
`printable_storage` tracks writes for reports. A DynLoader hook lazily pulls
concrete slots for on-chain analysis (reference :43-75)."""

from typing import Dict, Optional

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.smt import BitVec, symbol_factory
from mythril_tpu_torch.smt.array_expr import Array, K


class Storage:
    def __init__(self, concrete: bool = False, address: Optional[BitVec] = None,
                 dynamic_loader=None):
        self.concrete = concrete
        self.address = address
        self.dynld = dynamic_loader
        if concrete:
            self._array = K(256, 256, 0)
        else:
            tag = (
                f"Storage{address.concrete_value}"
                if address is not None and not address.symbolic
                else f"Storage{id(self)}"
            )
            self._array = Array(tag, 256, 256)
        self.printable_storage: Dict = {}
        self._loaded_slots = set()

    def __getitem__(self, item: BitVec) -> BitVec:
        if (
            self.dynld is not None
            and self.address is not None
            and not self.address.symbolic
            and not item.symbolic
            and item.concrete_value not in self._loaded_slots
        ):
            self._lazy_load(item.concrete_value)
        return self._array[item]

    def _lazy_load(self, slot: int) -> None:
        self._loaded_slots.add(slot)
        try:
            value = self.dynld.read_storage(
                f"0x{self.address.concrete_value:040x}", slot
            )
        except Exception:
            return
        if value is not None:
            self._array[slot] = int(value, 16) if isinstance(value, str) else value
            self.printable_storage[slot] = self._array[slot]

    def __setitem__(self, key: BitVec, value: BitVec) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        self._array[key] = value
        self.printable_storage[
            key.concrete_value if not key.symbolic else key
        ] = value

    def clone(self) -> "Storage":
        dup = Storage.__new__(Storage)
        dup.concrete = self.concrete
        dup.address = self.address
        dup.dynld = self.dynld
        dup._array = self._array.clone()
        dup.printable_storage = dict(self.printable_storage)
        dup._loaded_slots = set(self._loaded_slots)
        return dup

    def __deepcopy__(self, memo):
        return self.clone()


class Account:
    def __init__(
        self,
        address,
        code: Optional[Disassembly] = None,
        contract_name: Optional[str] = None,
        balances: Optional["Array"] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        nonce: int = 0,
    ):
        if isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)
        self.address = address
        self.code = code or Disassembly(b"")
        self.contract_name = contract_name or "Unknown"
        self.nonce = nonce
        self.deleted = False
        self.storage = Storage(
            concrete=concrete_storage, address=address, dynamic_loader=dynamic_loader
        )
        # balance reads go through the world-state global balance array
        self._balances = balances

    def set_balance_array(self, balances) -> None:
        self._balances = balances

    @property
    def balance(self):
        """Callable kept for parity with reference account.balance()."""
        return lambda: self._balances[self.address]

    def add_balance(self, value) -> None:
        self._balances[self.address] = self._balances[self.address] + value

    def sub_balance(self, value) -> None:
        self._balances[self.address] = self._balances[self.address] - value

    @property
    def serialised_code(self) -> str:
        from mythril_tpu_torch.disasm.disassembly import _concrete_projection

        return _concrete_projection(self.code.bytecode).hex()

    def clone(self, balances=None) -> "Account":
        dup = Account.__new__(Account)
        dup.address = self.address
        dup.code = self.code  # immutable
        dup.contract_name = self.contract_name
        dup.nonce = self.nonce
        dup.deleted = self.deleted
        dup.storage = self.storage.clone()
        dup._balances = balances if balances is not None else self._balances
        return dup

    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code,
            "balance": self.balance(),
            "storage": self.storage,
        }
