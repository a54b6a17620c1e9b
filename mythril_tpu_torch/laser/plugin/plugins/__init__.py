"""The engine plugins the analyze path loads; the summary plugin
(summary.py) is imported where --enable-summaries loads it."""

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
from mythril_tpu_torch.laser.plugin.plugins.state_merge import (  # noqa: F401
    StateMergePluginBuilder,
)
from mythril_tpu_torch.laser.plugin.plugins.trace import (  # noqa: F401
    TraceFinderBuilder,
)
