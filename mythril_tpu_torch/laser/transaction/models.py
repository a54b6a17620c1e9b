"""Transaction models (reference laser/ethereum/transaction/transaction_models.py).

MessageCallTransaction / ContractCreationTransaction produce the initial
GlobalState of a call frame; `end()` raises TransactionEndSignal, caught by
the engine to pop the frame (reference :199-208, svm.py:475-519)."""

from typing import List, Optional

from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.state.environment import Environment
from mythril_tpu_torch.laser.state.global_state import GlobalState
from mythril_tpu_torch.laser.state.machine_state import MachineState
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, UGE, symbol_factory


class _TxIdManager:
    def __init__(self):
        self._next = 0

    def get_next_tx_id(self) -> str:
        self._next += 1
        return str(self._next)

    def restart_counter(self):
        self._next = 0


tx_id_manager = _TxIdManager()


class TransactionStartSignal(Exception):
    """Raised by call/create opcodes to push a new frame."""

    def __init__(self, transaction, op_code: str, global_state: GlobalState):
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class TransactionEndSignal(Exception):
    """Raised by STOP/RETURN/REVERT/SELFDESTRUCT to pop the frame."""

    def __init__(self, global_state: GlobalState, revert: bool = False):
        self.global_state = global_state
        self.revert = revert


class BaseTransaction:
    def __init__(
        self,
        world_state: WorldState,
        callee_account=None,
        caller: Optional[BitVec] = None,
        call_data: Optional[BaseCalldata] = None,
        gas_price=None,
        gas_limit=None,
        origin: Optional[BitVec] = None,
        code: Optional[Disassembly] = None,
        call_value=None,
        init_call_data: bool = True,
        static: bool = False,
        base_fee=None,
        block_number=None,
    ):
        self.id = tx_id_manager.get_next_tx_id()
        self.world_state = world_state
        self.callee_account = callee_account
        self.caller = caller if caller is not None else symbol_factory.BitVecVal(0, 256)
        self.origin = (
            origin
            if origin is not None
            else symbol_factory.BitVecSym(f"origin{self.id}", 256)
        )
        self.gas_price = (
            gas_price
            if gas_price is not None
            else symbol_factory.BitVecSym(f"gasprice{self.id}", 256)
        )
        self.gas_limit = gas_limit if gas_limit is not None else 8_000_000
        self.call_value = (
            call_value
            if call_value is not None
            else symbol_factory.BitVecSym(f"call_value{self.id}", 256)
        )
        self.base_fee = (
            base_fee
            if base_fee is not None
            else symbol_factory.BitVecSym(f"basefee{self.id}", 256)
        )
        self.block_number = block_number
        if call_data is not None:
            self.call_data = call_data
        elif init_call_data:
            # Default to symbolic calldata — the reference does this even for
            # creation txs ("easier to model the calldata symbolically",
            # transaction_models.py:112-113, symbolic.py:173-175) and
            # compensates in CODESIZE/CODECOPY/CALLDATACOPY.
            self.call_data = SymbolicCalldata(self.id)
        else:
            self.call_data = None
        self.code = code
        self.static = static
        self.return_data = None
        self.return_data_size = None

    def initial_global_state_from_environment(self, environment, active_function):
        world_state = self.world_state
        if self.block_number is not None:
            # concrete replay (concolic/VMTests): NUMBER is pinned for this
            # frame; inner frames inherit it in svm._start_inner_transaction
            environment.block_number = (
                self.block_number
                if isinstance(self.block_number, BitVec)
                else symbol_factory.BitVecVal(self.block_number, 256)
            )
        global_state = GlobalState(
            world_state, environment,
            machine_state=MachineState(gas_limit=self.gas_limit),
        )
        global_state.environment.active_function_name = active_function
        sender = environment.sender
        receiver = environment.active_account.address
        value = environment.callvalue
        # transfer constraint: sender must afford the value
        global_state.world_state.constraints.append(
            UGE(global_state.world_state.balances[sender], value)
        )
        global_state.world_state.balances[sender] = (
            global_state.world_state.balances[sender] - value
        )
        global_state.world_state.balances[receiver] = (
            global_state.world_state.balances[receiver] + value
        )
        return global_state

    def end(self, global_state: GlobalState, return_data=None, revert=False):
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)

    def __str__(self):
        return (
            f"{type(self).__name__} {self.id} from "
            f"{self.caller} to {getattr(self.callee_account, 'address', '?')}"
        )


class MessageCallTransaction(BaseTransaction):
    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code or self.callee_account.code,
            static=self.static,
            basefee=self.base_fee,
        )
        return self.initial_global_state_from_environment(
            environment, active_function="fallback"
        )


class ContractCreationTransaction(BaseTransaction):
    def __init__(self, *args, prev_world_state: Optional[WorldState] = None,
                 contract_name: Optional[str] = None, **kwargs):
        # snapshot the pre-tx world for exploit replay (reference :229)
        self.prev_world_state = prev_world_state
        self.contract_name = contract_name
        super().__init__(*args, **kwargs)

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code,
            basefee=self.base_fee,
        )
        return self.initial_global_state_from_environment(
            environment, active_function="constructor"
        )

    def end(self, global_state: GlobalState, return_data=None, revert=False):
        """Assign returned runtime bytecode to the new account
        (reference :283-290)."""
        if return_data is not None and not revert:
            if isinstance(return_data, bytes):
                self.callee_account.code = Disassembly(return_data)
            global_state.environment.active_account = self.callee_account
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)
