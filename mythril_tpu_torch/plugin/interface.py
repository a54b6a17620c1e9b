"""Package-level plugin interfaces (reference mythril/plugin/interface.py).

Third-party pip packages extend the framework by exposing entry points in
the ``mythril_tpu_torch.plugins`` group; each entry point resolves to a subclass
of one of these interfaces."""

from abc import ABC

from mythril_tpu_torch.laser.plugin.interface import PluginBuilder as LaserPluginBuilder


class MythrilPlugin:
    """Base interface for package-level plugins.

    Plugins extend the framework in one of these ways:
    1. instrument LASER (implement MythrilLaserPlugin),
    2. add a search strategy,
    3. add a detection module (subclass analysis.module.DetectionModule),
    4. add CLI commands (implement MythrilCLIPlugin).
    """

    author = "Default Author"
    name = "Plugin Name"
    plugin_license = "All rights reserved."
    plugin_type = "Mythril Plugin"
    plugin_version = "0.0.1"
    plugin_description = "Example plugin description"
    plugin_default_enabled = False

    def __init__(self, **kwargs):
        pass

    def __repr__(self):
        return f"{type(self).__name__} - {self.plugin_version} - {self.author}"


class MythrilCLIPlugin(MythrilPlugin):
    """Plugins that add commands to the CLI."""


class MythrilLaserPlugin(MythrilPlugin, LaserPluginBuilder, ABC):
    """Plugins that instrument the LASER EVM."""
