"""Coverage metrics plugin — instruction + branch coverage time series
written to data.json (reference laser/plugin/plugins/coverage_metrics/,
203 LoC, MythX format)."""

import json
import logging
import time
from typing import Dict

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class CoverageMetricsPlugin(LaserPlugin):
    name = "coverage-metrics"

    def __init__(self, output_path: str = "data.json"):
        self.output_path = output_path
        self.begin = None
        # bytecode hash -> {"instructions": set pcs, "branches": set (pc, taken)}
        self.per_code: Dict = {}
        self.time_series = []

    def initialize(self, symbolic_vm) -> None:
        self.begin = time.monotonic()
        self.per_code = {}
        self.time_series = []

        def execute_state_hook(global_state):
            code = global_state.environment.code
            entry = self.per_code.setdefault(
                code.bytecode_hash,
                {"total": len(code.instruction_list),
                 "instructions": set(), "branches": set()},
            )
            entry["instructions"].add(global_state.mstate.pc)

        def jumpi_post_hook(global_state):
            # a successor of JUMPI: record which side was reached
            code = global_state.environment.code
            entry = self.per_code.get(code.bytecode_hash)
            if entry is not None:
                entry["branches"].add(global_state.mstate.pc)

        def stop_sym_trans_hook():
            self.time_series.append(self._snapshot())

        def stop_sym_exec_hook():
            self.time_series.append(self._snapshot())
            self._write()

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_instr_hooks("post", "JUMPI", jumpi_post_hook)
        symbolic_vm.register_laser_hooks("stop_sym_trans",
                                         stop_sym_trans_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_sym_exec_hook)

    def _snapshot(self) -> dict:
        per_code = {}
        for code_hash, entry in self.per_code.items():
            total = entry["total"] or 1
            per_code[code_hash.hex()] = {
                "instruction_coverage": len(entry["instructions"]) / total,
                "branches_covered": len(entry["branches"]),
            }
        return {
            "seconds": time.monotonic() - self.begin,
            "coverage": per_code,
        }

    def _write(self) -> None:
        try:
            with open(self.output_path, "w") as handle:
                json.dump({"time_series": self.time_series}, handle)
        except OSError:
            log.warning("could not write %s", self.output_path)


class CoverageMetricsPluginBuilder(PluginBuilder):
    name = "coverage-metrics"

    def __call__(self, *args, **kwargs):
        return CoverageMetricsPlugin(**kwargs)
