"""Instruction profiler — per-opcode wall-time min/avg/max
(reference laser/plugin/plugins/instruction_profiler.py:115)."""

import logging
import time
from collections import defaultdict

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class InstructionProfiler(LaserPlugin):
    def __init__(self):
        self.records = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
        # single pending slot: the engine is single-threaded and post-hooks
        # fire immediately after the instruction (possibly on successor
        # objects, so keying by state identity would leak/misattribute)
        self._pending = None

    def initialize(self, symbolic_vm):
        def pre_hook(global_state):
            instr = global_state.instruction
            if instr is not None:
                self._pending = (time.monotonic(), instr.opcode)

        def post_hook(global_state):
            mark = self._pending
            self._pending = None
            if mark is None:
                return
            started, opcode = mark
            duration = time.monotonic() - started
            record = self.records[opcode]
            record[0] += 1
            record[1] += duration
            record[2] = min(record[2], duration)
            record[3] = max(record[3], duration)

        def stop_hook():
            if not self.records:
                return
            lines = []
            total = 0.0
            for opcode, (count, total_op, mn, mx) in sorted(self.records.items()):
                total += total_op
                lines.append(
                    f"[{opcode:14}] count: {count:6d}, "
                    f"avg: {total_op / count * 1e6:8.1f}us, "
                    f"min: {mn * 1e6:8.1f}us, max: {mx * 1e6:8.1f}us"
                )
            log.info(
                "Instruction profile (total %.2fs):\n%s", total, "\n".join(lines)
            )

        # frontier contract: purely observational per-instruction timing.
        # Batched runs skip both hooks as a PAIR (firing only the pre
        # side would leak a pending slot into the next instruction); the
        # profile then covers exactly the per-state fallback path, which
        # is also what the interp_opcode_wall_top histogram reports.
        pre_hook.frontier_transparent = True
        post_hook.frontier_transparent = True
        symbolic_vm.register_instr_hooks("pre", "", pre_hook)
        symbolic_vm.register_instr_hooks("post", "", post_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_hook)


class InstructionProfilerBuilder(PluginBuilder):
    name = "instruction_profiler"

    def __call__(self, *args, **kwargs):
        return InstructionProfiler()
