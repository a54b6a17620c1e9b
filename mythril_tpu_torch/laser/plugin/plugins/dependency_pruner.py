"""Dependency pruner (reference laser/plugin/plugins/dependency_pruner.py:337).

Learns which storage slots each basic block's paths depend on during
transaction N-1. In transaction N, a path arriving at a JUMPDEST whose known
dependencies cannot alias any slot written by earlier transactions is
skipped — re-executing it cannot exhibit new behavior. Blocks containing
calls (or not yet learned) are never skipped."""

import logging
from typing import Dict, Set

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState
from mythril_tpu_torch.laser.state.annotation import StateAnnotation

log = logging.getLogger(__name__)


def _slot_key(slot):
    raw = slot.raw if hasattr(slot, "raw") else slot
    if raw.is_const:
        return raw.value
    return "sym"  # symbolic slots conservatively alias everything


class DependencyAnnotation(StateAnnotation):
    """Per-path record of blocks visited and slots read on the path."""

    def __init__(self):
        self.path_blocks: Set[int] = set()
        self.storage_loaded: Set = set()

    def clone(self):
        dup = DependencyAnnotation()
        dup.path_blocks = set(self.path_blocks)
        dup.storage_loaded = set(self.storage_loaded)
        return dup


def get_dependency_annotation(state) -> DependencyAnnotation:
    annotations = state.get_annotations(DependencyAnnotation)
    if annotations:
        return annotations[0]
    annotation = DependencyAnnotation()
    state.annotate(annotation)
    return annotation


class DependencyPruner(LaserPlugin):
    def __init__(self):
        self.iteration = 0
        # block pc -> slot keys any path through the block has loaded
        self.block_dependencies: Dict[int, Set] = {}
        # blocks whose paths performed calls/creates (never skip those)
        self.blocks_with_calls: Set[int] = set()
        # slots written by any transaction so far
        self.all_writes: Set = set()
        self._learned_blocks: Set[int] = set()

    def initialize(self, symbolic_vm):
        self.__init__()

        def start_sym_trans_hook():
            self.iteration += 1

        def sstore_hook(global_state):
            self.all_writes.add(_slot_key(global_state.mstate.stack[-1]))

        def sload_hook(global_state):
            key = _slot_key(global_state.mstate.stack[-1])
            annotation = get_dependency_annotation(global_state)
            annotation.storage_loaded.add(key)
            # attribute the read to every block on the current path: any of
            # them re-executed leads here again
            for block in annotation.path_blocks:
                self.block_dependencies.setdefault(block, set()).add(key)

        def call_hook(global_state):
            annotation = get_dependency_annotation(global_state)
            for block in annotation.path_blocks:
                self.blocks_with_calls.add(block)

        def jumpdest_hook(global_state):
            block = global_state.mstate.pc
            annotation = get_dependency_annotation(global_state)
            annotation.path_blocks.add(block)
            if self.iteration < 2:
                self._learned_blocks.add(block)
                return
            if block not in self._learned_blocks:
                self._learned_blocks.add(block)
                return  # never seen: must explore
            if block in self.blocks_with_calls:
                return
            deps = self.block_dependencies.get(block, set())
            if "sym" in deps or "sym" in self.all_writes:
                return
            if deps & self.all_writes:
                return
            # the block's storage dependencies were not touched by any
            # previous transaction: the paths from here are redundant
            log.debug(
                "dependency pruning block %d in tx %d", block, self.iteration
            )
            raise PluginSkipState

        symbolic_vm.register_laser_hooks(
            "start_sym_trans", start_sym_trans_hook
        )
        symbolic_vm.register_hooks(
            "pre",
            {
                "SSTORE": [sstore_hook],
                "SLOAD": [sload_hook],
                "CALL": [call_hook],
                "STATICCALL": [call_hook],
                "DELEGATECALL": [call_hook],
                "CALLCODE": [call_hook],
                "CREATE": [call_hook],
                "CREATE2": [call_hook],
                "SELFDESTRUCT": [call_hook],
            },
        )
        symbolic_vm.register_hooks("pre", {"JUMPDEST": [jumpdest_hook]})


class DependencyPrunerBuilder(PluginBuilder):
    name = "dependency_pruner"

    def __call__(self, *args, **kwargs):
        return DependencyPruner()
