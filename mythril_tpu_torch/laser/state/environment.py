"""Execution environment of the active call frame
(reference laser/ethereum/state/environment.py:82)."""

from typing import Optional

from mythril_tpu_torch.laser.state.calldata import BaseCalldata
from mythril_tpu_torch.smt import BitVec, symbol_factory


class Environment:
    def __init__(
        self,
        active_account,
        sender: BitVec,
        calldata: BaseCalldata,
        gasprice: BitVec,
        callvalue: BitVec,
        origin: BitVec,
        code=None,
        static: bool = False,
        basefee: Optional[BitVec] = None,
    ):
        self.active_account = active_account
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.callvalue = callvalue
        self.origin = origin
        self.code = code if code is not None else active_account.code
        self.static = static
        self.basefee = basefee if basefee is not None else symbol_factory.BitVecSym(
            "basefee", 256
        )
        self.chainid = symbol_factory.BitVecVal(1, 256)
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.active_function_name = ""

    @property
    def address(self) -> BitVec:
        return self.active_account.address

    def clone(self, world_state=None) -> "Environment":
        """Rebind active_account into the given cloned world state."""
        dup = Environment.__new__(Environment)
        dup.__dict__.update(self.__dict__)
        if world_state is not None:
            addr = self.active_account.address
            if not addr.symbolic and addr.concrete_value in world_state.accounts:
                dup.active_account = world_state.accounts[addr.concrete_value]
        return dup
