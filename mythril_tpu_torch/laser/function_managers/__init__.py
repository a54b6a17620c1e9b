from mythril_tpu_torch.laser.function_managers.keccak import (  # noqa: F401
    keccak_function_manager,
)
from mythril_tpu_torch.laser.function_managers.exponent import (  # noqa: F401
    exponent_function_manager,
)
