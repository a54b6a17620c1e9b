"""Plugin control-flow signals (reference laser/plugin/signals.py)."""


class PluginSignal(Exception):
    pass


class PluginSkipState(PluginSignal):
    """Drop the current global state from exploration."""


class PluginSkipWorldState(PluginSignal):
    """Drop the current world state (do not open it for the next tx)."""
