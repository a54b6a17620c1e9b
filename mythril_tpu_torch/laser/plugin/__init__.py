from mythril_tpu_torch.laser.plugin.signals import (  # noqa: F401
    PluginSignal,
    PluginSkipState,
    PluginSkipWorldState,
)
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder  # noqa: F401
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader  # noqa: F401
