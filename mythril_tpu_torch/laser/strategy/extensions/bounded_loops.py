"""BoundedLoopsStrategy — skip states that keep repeating a jump-trace
suffix (reference laser/ethereum/strategy/extensions/bounded_loops.py)."""

import logging
from typing import List

from mythril_tpu_torch.laser.state.annotation import StateAnnotation

log = logging.getLogger(__name__)


class JumpdestCountAnnotation(StateAnnotation):
    """Per-state trace of executed JUMPDEST addresses (reference :13)."""

    def __init__(self):
        self._jumpdest_count = {}
        self.trace: List[int] = []

    def clone(self):
        dup = JumpdestCountAnnotation()
        dup.trace = list(self.trace)
        return dup


def _count_key_repetitions(trace: List[int]) -> int:
    """Detect a repeating suffix and count its repetitions
    (reference :84-102: find i<j with trace[i:j] repeating backwards)."""
    size = len(trace)
    if size < 2:
        return 0
    # find the shortest period p of the trace suffix
    for period in range(1, min(size // 2, 32) + 1):
        if trace[-period:] != trace[-2 * period:-period]:
            continue
        # count how many times this period repeats
        count = 2
        idx = size - 2 * period
        while idx - period >= 0 and trace[idx - period:idx] == trace[-period:]:
            count += 1
            idx -= period
        return count
    return 0


class BoundedLoopsStrategy:
    """Wraps another strategy; filters out states past the loop bound."""

    def __init__(self, super_strategy, loop_bound: int = 3, **kwargs):
        self.super_strategy = super_strategy
        self.bound = loop_bound
        self.work_list = super_strategy.work_list
        self.max_depth = super_strategy.max_depth

    def __iter__(self):
        return self

    def run_check(self):
        return self.super_strategy.run_check()

    def vet_state(self, state) -> bool:
        """Per-yield loop accounting: append the state's JUMPDEST trace
        and decide whether it stays under the loop bound. Shared by
        __next__ AND the vmapped frontier's sibling collection
        (laser/frontier/stepper.py) — states pulled into a batch bypass
        __next__, and skipping the accounting there would let loops run
        unbounded through back-to-back batched runs."""
        annotations = [
            a for a in state.annotations
            if isinstance(a, JumpdestCountAnnotation)
        ]
        if not annotations:
            annotation = JumpdestCountAnnotation()
            state.annotate(annotation)
        else:
            annotation = annotations[0]
        instruction = state.instruction
        if instruction is not None and instruction.opcode == "JUMPDEST":
            annotation.trace.append(state.mstate.pc)
            from mythril_tpu_torch.laser.transaction.models import (
                ContractCreationTransaction,
            )

            bound = self.bound
            if isinstance(
                state.current_transaction, ContractCreationTransaction
            ):
                # loops in constructors run real iterations (reference
                # :136-139 raises the bound for creation txs)
                bound = max(bound, 128)
            if _count_key_repetitions(annotation.trace) > bound:
                log.debug(
                    "loop bound %d exceeded at pc %d",
                    bound, state.mstate.pc,
                )
                return False
        return True

    def __next__(self):
        while True:
            state = self.super_strategy.__next__()
            if self.vet_state(state):
                return state
