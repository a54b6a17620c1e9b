"""Entry-point plugin discovery (reference mythril/plugin/discovery.py:26).

Scans installed python packages for ``mythril_tpu_torch.plugins`` entry
points via importlib.metadata: `pip install` a package exposing that group
and its plugins load without any repo change. The group is the port's own,
so a plugin written for the JAX package (group ``mythril_tpu.plugins``,
built on that package's classes) never loads here."""

from typing import Any, Dict, List, Optional

from mythril_tpu_torch.plugin.interface import MythrilPlugin

ENTRY_POINT_GROUP = "mythril_tpu_torch.plugins"


class PluginDiscovery:
    _instance = None
    _installed_plugins: Optional[Dict[str, Any]] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def init_installed_plugins(self) -> None:
        import logging
        from importlib.metadata import entry_points

        eps = entry_points()
        if hasattr(eps, "select"):  # python >= 3.10
            group = eps.select(group=ENTRY_POINT_GROUP)
        else:
            group = [ep for ep in eps if ep.group == ENTRY_POINT_GROUP]
        # one broken installed package must not take down the CLI
        self._installed_plugins = {}
        for ep in group:
            try:
                self._installed_plugins[ep.name] = ep.load()
            except Exception:
                logging.getLogger(__name__).exception(
                    "failed to load plugin entry point %r", ep.name)

    @property
    def installed_plugins(self) -> Dict[str, Any]:
        if self._installed_plugins is None:
            self.init_installed_plugins()
        return self._installed_plugins

    def is_installed(self, plugin_name: str) -> bool:
        return plugin_name in self.installed_plugins

    def build_plugin(self, plugin_name: str,
                     plugin_args: Optional[Dict] = None) -> MythrilPlugin:
        if not self.is_installed(plugin_name):
            raise ValueError(f"plugin {plugin_name!r} is not installed")
        plugin = self.installed_plugins[plugin_name]
        if plugin is None or not (
            isinstance(plugin, type) and issubclass(plugin, MythrilPlugin)
        ):
            raise ValueError(f"no valid plugin found for {plugin_name!r}")
        return plugin(**(plugin_args or {}))

    def get_plugins(self, default_enabled: Optional[bool] = None) -> List[str]:
        if default_enabled is None:
            return list(self.installed_plugins)
        return [
            name for name, cls in self.installed_plugins.items()
            if getattr(cls, "plugin_default_enabled", False) == default_enabled
        ]
