"""Package-level plugin loader (reference mythril/plugin/loader.py):
validates a plugin's type and dispatches it to the matching subsystem —
detection modules into the ModuleLoader, laser plugins into the
LaserPluginLoader."""

import logging
from typing import Dict

from mythril_tpu_torch.analysis.module.base import DetectionModule
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.laser.plugin.loader import LaserPluginLoader
from mythril_tpu_torch.plugin.discovery import PluginDiscovery
from mythril_tpu_torch.plugin.interface import MythrilLaserPlugin, MythrilPlugin

log = logging.getLogger(__name__)


class UnsupportedPluginType(Exception):
    """Raised when a plugin with an unsupported type is loaded."""


class MythrilPluginLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.loaded_plugins = []
            cls._instance.plugin_args = {}
            cls._instance._load_default_enabled()
        return cls._instance

    def set_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin: MythrilPlugin) -> None:
        if not isinstance(plugin, MythrilPlugin):
            raise ValueError("passed plugin is not a MythrilPlugin")
        log.info("loading plugin %s", plugin)
        if isinstance(plugin, DetectionModule):
            ModuleLoader().register_module(plugin)
        elif isinstance(plugin, MythrilLaserPlugin):
            LaserPluginLoader().load(plugin)
        else:
            raise UnsupportedPluginType(
                f"plugin type of {plugin!r} is not supported")
        self.loaded_plugins.append(plugin)

    def _load_default_enabled(self) -> None:
        for name in PluginDiscovery().get_plugins(default_enabled=True):
            try:
                plugin = PluginDiscovery().build_plugin(
                    name, self.plugin_args.get(name, {}))
                self.load(plugin)
            except Exception:
                log.exception("failed to load default-enabled plugin %s", name)
