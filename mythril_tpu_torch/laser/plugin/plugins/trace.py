"""Trace finder plugin — records the (pc, tx_id) stream of each transaction
(reference laser/plugin/plugins/trace.py:49). The concrete pass of concolic
mode replays txs with this plugin on, and the symbolic flip pass then
follows the recorded trace (concolic/runner.py)."""

from typing import List, Tuple

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder


class TraceFinder(LaserPlugin):
    name = "trace-finder"

    def __init__(self):
        self.tx_trace: List[List[Tuple[int, int]]] = []

    def initialize(self, symbolic_vm) -> None:
        self.tx_trace = []

        def start_exec_hook():
            # one exec() call == one transaction in the concolic replay flow
            self.tx_trace.append([])

        def execute_state_hook(global_state):
            self.tx_trace[-1].append(
                (global_state.mstate.pc, global_state.current_transaction.id)
            )

        symbolic_vm.register_laser_hooks("start_exec", start_exec_hook)
        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)


class TraceFinderBuilder(PluginBuilder):
    name = "trace-finder"

    def __call__(self, *args, **kwargs):
        return TraceFinder()
