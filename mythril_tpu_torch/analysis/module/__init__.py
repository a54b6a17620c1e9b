from mythril_tpu_torch.analysis.module.base import (  # noqa: F401
    DetectionModule,
    EntryPoint,
)
from mythril_tpu_torch.analysis.module.loader import ModuleLoader  # noqa: F401
from mythril_tpu_torch.analysis.module.util import (  # noqa: F401
    get_detection_module_hooks,
    reset_callback_modules,
)
