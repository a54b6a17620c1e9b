"""State merging — collapse similar open world states after each tx
(reference laser/plugin/plugins/state_merge/, 368 LoC; off by default,
`--enable-state-merging`).

Two open states merge when their accounts agree structurally (nonce,
deleted flag, bytecode), their CFG nodes agree, every annotation pair is
merge-compatible, and their constraint sets differ in at most
CONSTRAINT_DIFFERENCE_LIMIT entries. The merged state keeps the shared
constraint prefix plus Or(d1, d2) of the two unique suffixes; storage and
balances become If(d1, v1, v2). A MergeAnnotation prevents re-merging
(each state merges at most once per round).
"""

import logging
from typing import List, Set

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.laser.state.annotation import (
    MergeableStateAnnotation,
    StateAnnotation,
)
from mythril_tpu_torch.laser.state.constraints import Constraints
from mythril_tpu_torch.laser.state.world_state import WorldState
from mythril_tpu_torch.smt import And, If, Or

log = logging.getLogger(__name__)

CONSTRAINT_DIFFERENCE_LIMIT = 15


class MergeAnnotation(StateAnnotation):
    """Marks a world state as already merged once."""


# -- mergeability ----------------------------------------------------------


def _accounts_mergeable(account1, account2) -> bool:
    return (account1.nonce == account2.nonce
            and account1.deleted == account2.deleted
            and account1.code.bytecode == account2.code.bytecode)


def _nodes_mergeable(node1, node2) -> bool:
    if node1 is None or node2 is None:
        return node1 is node2
    return (node1.function_name == node2.function_name
            and node1.contract_name == node2.contract_name
            and node1.start_addr == node2.start_addr)


def _constraints_mergeable(constraints1, constraints2) -> bool:
    set1 = {hash(c) for c in constraints1}
    set2 = {hash(c) for c in constraints2}
    diff = len(set1 - set2) + len(set2 - set1)
    return diff <= CONSTRAINT_DIFFERENCE_LIMIT


def _annotations_mergeable(state1: WorldState, state2: WorldState) -> bool:
    if len(state1.annotations) != len(state2.annotations):
        return False
    for a1, a2 in zip(state1.annotations, state2.annotations):
        if type(a1) is not type(a2):
            return False
        if isinstance(a1, MergeableStateAnnotation):
            if not a1.check_merge_annotation(a2):
                return False
        elif a1 is not a2 and not isinstance(a1, MergeAnnotation):
            # unmergeable distinct mutable annotations: refuse
            return False
    return True


def check_ws_merge_condition(state1: WorldState,
                             state2: WorldState) -> bool:
    if not _nodes_mergeable(state1.node, state2.node):
        return False
    if set(state1.accounts) != set(state2.accounts):
        return False
    for address, account2 in state2.accounts.items():
        if not _accounts_mergeable(state1.accounts[address], account2):
            return False
    if not _constraints_mergeable(state1.constraints, state2.constraints):
        return False
    return _annotations_mergeable(state1, state2)


# -- the merge -------------------------------------------------------------


def _split_constraints(constraints1, constraints2):
    """(shared, unique1, unique2) by structural hash."""
    hashes2 = {hash(c) for c in constraints2}
    hashes1 = {hash(c) for c in constraints1}
    shared = [c for c in constraints1 if hash(c) in hashes2]
    unique1 = [c for c in constraints1 if hash(c) not in hashes2]
    unique2 = [c for c in constraints2 if hash(c) not in hashes1]
    return shared, unique1, unique2


def merge_states(state1: WorldState, state2: WorldState) -> None:
    """Merge state2 into state1 (in place)."""
    shared, unique1, unique2 = _split_constraints(
        state1.constraints, state2.constraints)
    condition1 = And(*unique1) if unique1 else None
    merged = Constraints(shared)
    if unique1 or unique2:
        disjunct1 = And(*unique1) if unique1 else None
        disjunct2 = And(*unique2) if unique2 else None
        if disjunct1 is not None and disjunct2 is not None:
            merged.append(Or(disjunct1, disjunct2))
        # one side empty => its disjunct is True => Or is True: drop it
    state1.constraints = merged

    if condition1 is None:
        # state1's path subsumes state2's: keep state1's data as-is
        state1.annotate(MergeAnnotation())
        return

    state1.balances = If(condition1, state1.balances, state2.balances)
    state1.starting_balances = If(
        condition1, state1.starting_balances, state2.starting_balances)
    for address, account2 in state2.accounts.items():
        account1 = state1.accounts[address]
        account1.set_balance_array(state1.balances)
        _merge_storage(account1.storage, account2.storage, condition1)
    for a1, a2 in zip(state1.annotations, state2.annotations):
        if isinstance(a1, MergeableStateAnnotation):
            a1.merge_annotation(a2)
    state1.annotate(MergeAnnotation())
    if state1.node is not None and state2.node is not None:
        state1.node.states += state2.node.states
        state1.node.flags |= state2.node.flags
        state1.node.constraints = state1.constraints


def _merge_storage(storage1, storage2, condition1) -> None:
    storage1._array = If(condition1, storage1._array, storage2._array)
    storage1._loaded_slots |= storage2._loaded_slots
    for key, value in storage2.printable_storage.items():
        if key in storage1.printable_storage:
            storage1.printable_storage[key] = If(
                condition1, storage1.printable_storage[key], value)
        else:
            storage1.printable_storage[key] = If(condition1, 0, value)


# -- the plugin ------------------------------------------------------------


class StateMergePlugin(LaserPlugin):
    name = "state-merge"

    def initialize(self, symbolic_vm) -> None:
        def stop_sym_trans_hook():
            open_states = symbolic_vm.open_states
            if len(open_states) <= 1:
                return
            before = len(open_states)
            symbolic_vm.open_states = self._merge_round(open_states)
            log.info("state merge: %d -> %d open states",
                     before, len(symbolic_vm.open_states))

        symbolic_vm.register_laser_hooks("stop_sym_trans",
                                         stop_sym_trans_hook)

    def _merge_round(self, states: List[WorldState]) -> List[WorldState]:
        """Repeated pairwise merging until a fixpoint."""
        current = list(states)
        while True:
            merged_any = False
            result: List[WorldState] = []
            consumed: Set[int] = set()
            for i, state in enumerate(current):
                if i in consumed:
                    continue
                if list(state.get_annotations(MergeAnnotation)):
                    result.append(state)
                    continue
                for j in range(i + 1, len(current)):
                    if j in consumed:
                        continue
                    other = current[j]
                    if (not list(other.get_annotations(MergeAnnotation))
                            and check_ws_merge_condition(state, other)):
                        merge_states(state, other)
                        consumed.add(j)
                        merged_any = True
                        break
                result.append(state)
            current = result
            if not merged_any:
                return current


class StateMergePluginBuilder(PluginBuilder):
    name = "state-merge"

    def __call__(self, *args, **kwargs):
        return StateMergePlugin()
