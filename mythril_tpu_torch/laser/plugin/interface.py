"""Plugin interfaces (reference laser/plugin/interface.py + builder.py)."""


class LaserPlugin:
    def initialize(self, symbolic_vm) -> None:
        """Register hooks on the virtual machine."""
        raise NotImplementedError


class PluginBuilder:
    name = "plugin"
    author = "mythril_tpu_torch"
    plugin_default_enabled = True

    def __init__(self):
        self.enabled = self.plugin_default_enabled

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        raise NotImplementedError
