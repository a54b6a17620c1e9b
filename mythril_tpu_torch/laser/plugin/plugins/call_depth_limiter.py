"""Call-depth limiter plugin (reference laser/plugin/plugins/
call_depth_limiter.py:30). The engine also enforces args.call_depth_limit
directly in call_ops; this plugin makes the limit strategy-visible by
skipping states that exceed it."""

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int = 3):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm):
        def execute_state_hook(global_state):
            inner = sum(
                1 for _tx, snap in global_state.transaction_stack
                if snap is not None
            )
            if inner > self.call_depth_limit:
                raise PluginSkipState

        # frontier contract: the depth check reads only the transaction
        # stack, which straight-line runs never change — once per batched
        # run is equivalent to once per instruction
        execute_state_hook.frontier_once_ok = True
        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)


class CallDepthLimitBuilder(PluginBuilder):
    name = "call_depth_limiter"

    def __call__(self, *args, **kwargs):
        return CallDepthLimit(**kwargs)
