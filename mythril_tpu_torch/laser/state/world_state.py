"""WorldState (reference laser/ethereum/state/world_state.py:259).

Holds the account registry, the GLOBAL balance array (one SMT array indexed
by address — the key trick enabling EtherThief/UnexpectedEther predicates),
the per-path constraints, and the transaction sequence."""

from typing import Dict, List, Optional

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser.state.account import Account
from mythril_tpu_torch.laser.state.constraints import Constraints
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.array_expr import Array
from mythril_tpu_torch.utils.keccak import keccak256


class WorldState:
    next_balance_id = 1

    def __init__(self, transaction_sequence=None, annotations=None):
        self._accounts: Dict[int, Account] = {}
        self.balances = Array(f"balance_{WorldState.next_balance_id}", 256, 256)
        WorldState.next_balance_id += 1
        self.starting_balances = self.balances.clone()
        self.constraints = Constraints()
        self.transaction_sequence: List = transaction_sequence or []
        self.annotations: List = list(annotations or [])
        self.node = None  # CFG bookkeeping

    @property
    def accounts(self) -> Dict[int, Account]:
        return self._accounts

    def put_account(self, account: Account) -> None:
        assert not account.address.symbolic
        self._accounts[account.address.concrete_value] = account
        account.set_balance_array(self.balances)

    def create_account(
        self,
        balance=0,
        address: Optional[int] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        creator: Optional[int] = None,
        code: Optional[Disassembly] = None,
        nonce: int = 0,
    ) -> Account:
        if address is None:
            address = self._generate_new_address(creator)
        account = Account(
            address,
            code=code,
            balances=self.balances,
            concrete_storage=concrete_storage,
            dynamic_loader=dynamic_loader,
            nonce=nonce,
        )
        if balance:
            account.add_balance(symbol_factory.BitVecVal(balance, 256)
                                if isinstance(balance, int) else balance)
        self.put_account(account)
        return account

    def accounts_exist_or_load(self, address, dynamic_loader=None) -> Account:
        """Fetch the account, lazily creating/loading unknown ones."""
        if isinstance(address, str):
            address = int(address, 16)
        if isinstance(address, int):
            addr_int = address
        elif not address.symbolic:
            addr_int = address.concrete_value
        else:
            # symbolic callee: fresh unconstrained account
            return Account(address, balances=self.balances)
        if addr_int in self._accounts:
            return self._accounts[addr_int]
        code = None
        if dynamic_loader is not None:
            try:
                code_hex = dynamic_loader.dynld(f"0x{addr_int:040x}")
                if code_hex:
                    code = (
                        code_hex
                        if isinstance(code_hex, Disassembly)
                        else Disassembly(code_hex)
                    )
            except Exception:
                code = None
        return self.create_account(
            address=addr_int, dynamic_loader=dynamic_loader, code=code
        )

    def _generate_new_address(self, creator: Optional[int]) -> int:
        """CREATE address: last 20 bytes of keccak(rlp([creator, nonce]))
        (reference world_state.py:239-251)."""
        if creator is None:
            # fresh pseudo-address for detached account creation
            seed = len(self._accounts).to_bytes(8, "big")
            return int.from_bytes(keccak256(seed)[12:], "big")
        nonce = self._accounts[creator].nonce if creator in self._accounts else 0
        rlp = _rlp_encode_pair(creator.to_bytes(20, "big"), nonce)
        return int.from_bytes(keccak256(rlp)[12:], "big")

    def __getitem__(self, item) -> Account:
        if hasattr(item, "symbolic"):
            assert not item.symbolic
            item = item.concrete_value
        return self._accounts[item]

    def clone(self) -> "WorldState":
        dup = WorldState.__new__(WorldState)
        dup.balances = self.balances.clone()
        dup.starting_balances = self.starting_balances.clone()
        dup._accounts = {}
        for addr, account in self._accounts.items():
            dup._accounts[addr] = account.clone(balances=dup.balances)
        dup.constraints = self.constraints.copy()
        dup.transaction_sequence = list(self.transaction_sequence)
        # per-path mutable metadata (traces, dependency maps) must not leak
        # between forks: prefer this codebase's clone() convention, fall
        # back to __copy__ (same form as GlobalState.copy)
        import copy as _copy

        dup.annotations = [
            a.clone() if hasattr(a, "clone") else _copy.copy(a)
            for a in self.annotations
        ]
        dup.node = self.node
        return dup

    __copy__ = clone

    def __deepcopy__(self, memo) -> "WorldState":
        return self.clone()

    def annotate(self, annotation) -> None:
        self.annotations.append(annotation)

    def get_annotations(self, annotation_type):
        return [a for a in self.annotations if isinstance(a, annotation_type)]


def _rlp_encode_pair(address_bytes: bytes, nonce: int) -> bytes:
    """Minimal RLP for [20-byte-address, small-int-nonce]."""

    def enc_bytes(b: bytes) -> bytes:
        if len(b) == 1 and b[0] < 0x80:
            return b
        assert len(b) < 56
        return bytes([0x80 + len(b)]) + b

    def enc_int(n: int) -> bytes:
        if n == 0:
            return b"\x80"
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        return enc_bytes(raw)

    payload = enc_bytes(address_bytes) + enc_int(nonce)
    assert len(payload) < 56
    return bytes([0xC0 + len(payload)]) + payload
