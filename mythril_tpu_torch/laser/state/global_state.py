"""GlobalState: one node of the exploration frontier
(reference laser/ethereum/state/global_state.py:185).

Bundles (world_state, environment, machine_state, tx stack, annotations).
Forks clone via `clone()` — explicit structural copy instead of the
reference's deepcopy (svm hot-spot, instructions.py:1629)."""

from typing import Iterable, List, Optional, Tuple

from mythril_tpu_torch.laser.state.environment import Environment
from mythril_tpu_torch.laser.state.machine_state import MachineState
from mythril_tpu_torch.laser.state.transient_storage import TransientStorage
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, symbol_factory


class GlobalState:
    def __init__(
        self,
        world_state: WorldState,
        environment: Environment,
        node=None,
        machine_state: Optional[MachineState] = None,
        transaction_stack: Optional[List[Tuple]] = None,
        last_return_data=None,
        annotations: Optional[Iterable] = None,
        transient_storage: Optional[TransientStorage] = None,
    ):
        self.world_state = world_state
        self.environment = environment
        self.node = node
        self.mstate = machine_state or MachineState(gas_limit=8_000_000)
        self.transaction_stack: List[Tuple] = transaction_stack or []
        self.last_return_data = last_return_data
        self.annotations: List = list(annotations or [])
        self.transient_storage = transient_storage or TransientStorage()
        # (start_pc, end_pc) span of the vmapped-frontier run this state
        # last exited mid-batch (laser/frontier/stepper.py): while its pc
        # is inside the span it replays on the per-state interpreter
        # instead of re-entering a batch at every interior pc of the same
        # run. Deliberately NOT copied by clone() — forks leave the span.
        self._frontier_skip_span = None

    @property
    def accounts(self):
        return self.world_state.accounts

    @property
    def current_transaction(self):
        try:
            return self.transaction_stack[-1][0]
        except IndexError:
            return None

    @property
    def instruction(self) -> dict:
        instr = self.environment.code.instruction_at(self.mstate.pc)
        if instr is None:
            # pc past end of code -> implicit STOP handled by caller
            return None
        return instr

    def get_current_instruction(self):
        return self.instruction

    def new_bitvec(self, name: str, size: int = 256, annotations=None) -> BitVec:
        """Fresh symbol namespaced by transaction id (reference :147)."""
        tx = self.current_transaction
        tx_id = tx.id if tx is not None else "pre"
        return symbol_factory.BitVecSym(f"{tx_id}_{name}", size, annotations)

    def clone(self) -> "GlobalState":
        import copy as _copy

        world_state = self.world_state.clone()
        environment = self.environment.clone(world_state)
        dup = GlobalState(
            world_state,
            environment,
            node=self.node,
            machine_state=self.mstate.clone(),
            transaction_stack=list(self.transaction_stack),
            last_return_data=self.last_return_data,
            # annotations are mutable per-path metadata (loop traces, taint):
            # each fork needs its own copies
            annotations=[
                a.clone() if hasattr(a, "clone") else _copy.deepcopy(a)
                for a in self.annotations
            ],
            transient_storage=self.transient_storage.clone(),
        )
        return dup

    def __copy__(self):
        return self.clone()

    def __deepcopy__(self, memo):
        return self.clone()

    # annotation API (reference global_state.py + annotation.py)
    def annotate(self, annotation) -> None:
        self.annotations.append(annotation)
        if getattr(annotation, "persist_to_world_state", False):
            self.world_state.annotate(annotation)

    def get_annotations(self, annotation_type):
        return [a for a in self.annotations if isinstance(a, annotation_type)]
