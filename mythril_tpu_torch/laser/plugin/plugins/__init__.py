"""The engine plugins the analyze path loads (the state-merge, summary and
trace plugins of the JAX package wait for a later slice)."""

from mythril_tpu_torch.laser.plugin.plugins.coverage import (  # noqa: F401
    CoveragePluginBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.mutation_pruner import (  # noqa: F401
    MutationPrunerBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.instruction_profiler import (  # noqa: F401
    InstructionProfilerBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.call_depth_limiter import (  # noqa: F401
    CallDepthLimitBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.dependency_pruner import (  # noqa: F401
    DependencyPrunerBuilder,
)
