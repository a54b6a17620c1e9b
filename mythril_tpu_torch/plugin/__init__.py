from mythril_tpu_torch.plugin.discovery import PluginDiscovery
from mythril_tpu_torch.plugin.interface import (
    MythrilCLIPlugin,
    MythrilLaserPlugin,
    MythrilPlugin,
)
from mythril_tpu_torch.plugin.loader import MythrilPluginLoader, UnsupportedPluginType

__all__ = [
    "PluginDiscovery",
    "MythrilPlugin",
    "MythrilCLIPlugin",
    "MythrilLaserPlugin",
    "MythrilPluginLoader",
    "UnsupportedPluginType",
]
