"""Singleton plugin loader (reference laser/plugin/loader.py:12-75)."""

import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.laser.plugin.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class LaserPluginLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.laser_plugin_builders = {}
            cls._instance.plugin_args = {}
            cls._instance.plugin_list = {}
        return cls._instance

    def reset(self):
        self.laser_plugin_builders = {}
        self.plugin_args = {}
        self.plugin_list = {}

    def load(self, builder: PluginBuilder) -> None:
        if builder.name in self.laser_plugin_builders:
            log.warning("plugin %s already loaded", builder.name)
            return
        self.laser_plugin_builders[builder.name] = builder

    def is_enabled(self, name: str) -> bool:
        builder = self.laser_plugin_builders.get(name)
        return builder is not None and builder.enabled

    def add_args(self, name: str, **kwargs) -> None:
        self.plugin_args[name] = kwargs

    def enable(self, name: str) -> None:
        if name in self.laser_plugin_builders:
            self.laser_plugin_builders[name].enabled = True

    def disable(self, name: str) -> None:
        if name in self.laser_plugin_builders:
            self.laser_plugin_builders[name].enabled = False

    def instrument_virtual_machine(self, symbolic_vm, with_plugins: Optional[List[str]] = None):
        for name, builder in self.laser_plugin_builders.items():
            if not builder.enabled:
                continue
            if with_plugins is not None and name not in with_plugins:
                continue
            plugin = builder(**self.plugin_args.get(name, {}))
            plugin.initialize(symbolic_vm)
            self.plugin_list[name] = plugin
