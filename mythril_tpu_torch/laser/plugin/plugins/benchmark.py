"""Benchmark plugin — coverage-over-time and executed-instruction counts
(reference laser/plugin/plugins/benchmark.py:96; off by default).

Records a (wall_seconds, covered_instructions) time series plus the total
executed-instruction count; writes `<name>.json` at stop, and a PNG plot
when matplotlib is importable (it is optional — the data file is the
contract)."""

import json
import logging
import time

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class BenchmarkPlugin(LaserPlugin):
    name = "benchmark"

    def __init__(self, name: str = "benchmark"):
        self.out_name = name
        self.begin = None
        self.coverage_series = []  # (seconds, unique pcs covered)
        self.instructions_executed = 0
        self._covered = set()

    def initialize(self, symbolic_vm) -> None:
        self.begin = time.monotonic()
        self.coverage_series = []
        self.instructions_executed = 0
        self._covered = set()

        def execute_state_hook(global_state):
            self.instructions_executed += 1
            key = (global_state.environment.code.bytecode_hash,
                   global_state.mstate.pc)
            if key not in self._covered:
                self._covered.add(key)
                self.coverage_series.append(
                    (time.monotonic() - self.begin, len(self._covered))
                )

        def stop_sym_exec_hook():
            self._write_output()

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_sym_exec_hook)

    def _write_output(self) -> None:
        data = {
            "instructions_executed": self.instructions_executed,
            "unique_instructions_covered": len(self._covered),
            "coverage_over_time": self.coverage_series,
            "total_seconds": time.monotonic() - self.begin,
        }
        path = f"{self.out_name}.json"
        try:
            with open(path, "w") as handle:
                json.dump(data, handle)
        except OSError:
            log.warning("could not write %s", path)
            return
        self._maybe_plot()

    def _maybe_plot(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        if not self.coverage_series:
            return
        xs, ys = zip(*self.coverage_series)
        plt.figure()
        plt.plot(xs, ys)
        plt.xlabel("seconds")
        plt.ylabel("instructions covered")
        plt.savefig(f"{self.out_name}.png")
        plt.close()


class BenchmarkPluginBuilder(PluginBuilder):
    name = "benchmark"

    def __call__(self, *args, **kwargs):
        return BenchmarkPlugin(**kwargs)
