"""Coverage plugin — per-bytecode pc bitmap + per-tx new-coverage logging
(reference laser/plugin/plugins/coverage/coverage_plugin.py:116)."""

import logging
from typing import Dict, List, Tuple

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class InstructionCoveragePlugin(LaserPlugin):
    def __init__(self):
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.initial_coverage = 0
        self.tx_id = 0

    def initialize(self, symbolic_vm):
        self.coverage = {}
        self.tx_id = 0

        def execute_state_hook(global_state):
            # keyed by the precomputed bytecode hash: the hook runs for
            # every instruction, hex-encoding the bytecode here would be
            # O(code size) in the engine's hottest loop
            code = global_state.environment.code.bytecode_hash
            if code not in self.coverage:
                number_of_instrs = len(
                    global_state.environment.code.instruction_list
                )
                self.coverage[code] = (
                    number_of_instrs,
                    [False] * number_of_instrs,
                )
            index = global_state.environment.code.index_of_address(
                global_state.mstate.pc
            )
            if index is not None:
                self.coverage[code][1][index] = True

        def stop_sym_exec_hook():
            for code, (total, seen) in self.coverage.items():
                if total == 0:
                    continue
                covered = sum(seen)
                log.info(
                    "achieved %.2f%% coverage for code hash: %s...",
                    covered / total * 100,
                    code[:5].hex(),
                )

        def start_sym_trans_hook():
            self.tx_id += 1
            self.initial_coverage = self._total_covered()

        def stop_sym_trans_hook():
            end_coverage = self._total_covered()
            log.info(
                "number of new instructions covered in tx %d: %d",
                self.tx_id,
                end_coverage - self.initial_coverage,
            )

        def frontier_batch_hook(states, run):
            # batched straight-line runs skip the per-instruction hook;
            # every pc of the run executed for the completed states, so
            # marking the whole run keeps the bitmap exact (the run-start
            # pc was already marked by the once-per-run firing)
            code_obj = states[0].environment.code
            entry = self.coverage.get(code_obj.bytecode_hash)
            if entry is None:
                return
            for pc in run.op_pcs:
                index = code_obj.index_of_address(pc)
                if index is not None:
                    entry[1][index] = True

        # frontier contract (laser/frontier/stepper.py): firing once per
        # batched run is fine — the batch companion repaints the interior
        execute_state_hook.frontier_once_ok = True
        execute_state_hook.frontier_batch = frontier_batch_hook

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_sym_exec_hook)
        symbolic_vm.register_laser_hooks("start_sym_trans", start_sym_trans_hook)
        symbolic_vm.register_laser_hooks("stop_sym_trans", stop_sym_trans_hook)

    def _total_covered(self) -> int:
        return sum(sum(seen) for _total, seen in self.coverage.values())


class CoverageStrategy:
    """Strategy wrapper preferring states whose pc is not yet covered
    (reference plugin/plugins/coverage/coverage_strategy.py:6)."""

    def __init__(self, super_strategy, coverage_plugin:
                 InstructionCoveragePlugin):
        self.super_strategy = super_strategy
        self.coverage_plugin = coverage_plugin
        self.work_list = super_strategy.work_list
        self.max_depth = super_strategy.max_depth

    def __iter__(self):
        return self

    def run_check(self):
        return self.super_strategy.run_check()

    def _is_covered(self, state) -> bool:
        code = state.environment.code
        entry = self.coverage_plugin.coverage.get(code.bytecode_hash)
        if entry is None:
            return False
        index = code.index_of_address(state.mstate.pc)
        return index is not None and entry[1][index]

    def __next__(self):
        for i, state in enumerate(self.work_list):
            if not self._is_covered(state):
                if state.mstate.depth < self.max_depth:
                    del self.work_list[i]
                    return state
        return next(self.super_strategy)


class CoveragePluginBuilder(PluginBuilder):
    name = "coverage"

    def __call__(self, *args, **kwargs):
        return InstructionCoveragePlugin()
