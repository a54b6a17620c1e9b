"""Concolic search strategy (reference laser/ethereum/strategy/concolic.py).

Follows a previously recorded concrete (pc, tx_id) trace; when it reaches a
JUMPI whose address the caller asked to flip, it negates the last path
constraint and concretizes a transaction sequence that drives execution
down the other side. States that wander off the trace are dropped.

Unlike the reference, pc here is the byte address itself (our Disassembly
indexes instructions by address), so no instruction_list indirection is
needed when matching flip addresses.
"""

import logging
from copy import copy
from typing import Any, Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.state.constraints import Constraints
from mythril_tpu_torch.laser.strategy import CriterionSearchStrategy
from mythril_tpu_torch.smt import Not
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class TraceAnnotation(StateAnnotation):
    """Per-world-state trace of executed (pc, tx_id) pairs."""

    def __init__(self, trace: Optional[List[Tuple[int, int]]] = None):
        self.trace = trace or []

    @property
    def persist_over_calls(self) -> bool:
        return True

    def __copy__(self):
        return TraceAnnotation(copy(self.trace))


class ConcolicStrategy(CriterionSearchStrategy):
    def __init__(self, work_list, max_depth,
                 trace: List[List[Tuple[int, int]]],
                 flip_branch_addresses: List[str], **kwargs):
        super().__init__(work_list, max_depth, **kwargs)
        self.trace: List[Tuple[int, int]] = [
            pair for tx_trace in trace for pair in tx_trace
        ]
        self.last_tx_count = len(trace)
        self.flip_branch_addresses = flip_branch_addresses
        self.results: Dict[str, Any] = {}

    def _annotation(self, state) -> TraceAnnotation:
        for annotation in state.world_state.get_annotations(TraceAnnotation):
            return annotation
        annotation = TraceAnnotation()
        state.world_state.annotate(annotation)
        return annotation

    def get_strategic_global_state(self):
        while self.work_list:
            state = self.work_list.pop()
            annotation = self._annotation(state)
            annotation.trace.append(
                (state.mstate.pc, state.current_transaction.id)
            )
            on_trace = annotation.trace == self.trace[: len(annotation.trace)]
            if len(annotation.trace) < 2:
                if not on_trace:
                    continue
                return state
            prev_pc = annotation.trace[-2][0]
            addr = str(prev_pc)
            seq_id = len(state.world_state.transaction_sequence)
            if (on_trace and seq_id == self.last_tx_count
                    and addr in self.flip_branch_addresses
                    and addr not in self.results):
                prev_instr = state.environment.code.instruction_at(prev_pc)
                if prev_instr is None or prev_instr.opcode != "JUMPI":
                    log.error("branch %s is not a JUMPI, skipping", addr)
                    continue
                self._flip(state, addr)
            elif not on_trace:
                continue
            if len(self.results) == len(self.flip_branch_addresses):
                self.set_criterion_satisfied()
            return state
        raise StopIteration

    def _flip(self, state, addr: str) -> None:
        from mythril_tpu_torch.analysis.solver import get_transaction_sequence

        constraints = Constraints(state.world_state.constraints[:-1])
        constraints.append(Not(state.world_state.constraints[-1]))
        try:
            self.results[addr] = get_transaction_sequence(state, constraints)
        except (UnsatError, SolverTimeOutException):
            self.results[addr] = None
