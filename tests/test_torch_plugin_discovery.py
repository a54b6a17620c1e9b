"""The port's package-level plugin system (mythril_tpu_torch/plugin/): the
three cases of tests/test_plugin_discovery.py on the port's classes, and
the port's own entry-point group, which a plugin built on the JAX
package's classes never passes."""

from types import SimpleNamespace

import pytest

from mythril_tpu.analysis.module.base import DetectionModule as RefDetectionModule
from mythril_tpu.plugin import MythrilPlugin as RefMythrilPlugin
from mythril_tpu.plugin import discovery as ref_discovery
from mythril_tpu_torch.analysis.module.base import DetectionModule
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.plugin import (
    MythrilPlugin,
    MythrilPluginLoader,
    PluginDiscovery,
    UnsupportedPluginType,
)
from mythril_tpu_torch.plugin import discovery as port_discovery


class _DemoDetector(MythrilPlugin, DetectionModule):
    name = "DemoDetector"
    swc_id = "000"
    description = "demo"
    entry_point = None
    pre_hooks = []
    post_hooks = []
    plugin_default_enabled = True

    def _execute(self, state):
        return []


class _ReferenceDetector(RefMythrilPlugin, RefDetectionModule):
    """A plugin written for the JAX package."""

    name = "ReferenceDetector"
    swc_id = "000"
    description = "built on mythril_tpu"
    entry_point = None
    pre_hooks = []
    post_hooks = []
    plugin_default_enabled = True

    def _execute(self, state):
        return []


@pytest.fixture(autouse=True)
def fresh_singletons():
    """Neither singleton, nor the module list, outlives a test."""
    disc = PluginDiscovery()
    saved = (disc._installed_plugins, MythrilPluginLoader._instance,
             list(ModuleLoader()._modules))
    yield
    disc._installed_plugins, MythrilPluginLoader._instance, modules = saved
    ModuleLoader()._modules[:] = modules


@pytest.fixture
def discovery():
    disc = PluginDiscovery()
    disc._installed_plugins = {"demo-detector": _DemoDetector}
    return disc


def test_discovery_lists_and_builds(discovery):
    assert discovery.is_installed("demo-detector")
    assert not discovery.is_installed("absent")
    assert discovery.get_plugins() == ["demo-detector"]
    assert discovery.get_plugins(default_enabled=True) == ["demo-detector"]
    assert discovery.get_plugins(default_enabled=False) == []
    plugin = discovery.build_plugin("demo-detector")
    assert isinstance(plugin, _DemoDetector)
    with pytest.raises(ValueError):
        discovery.build_plugin("absent")


def test_loader_registers_detection_module(discovery):
    MythrilPluginLoader._instance = None
    loader = MythrilPluginLoader()
    # the default-enabled plugin loaded when the loader was made
    assert [type(p) for p in loader.loaded_plugins] == [_DemoDetector]
    before = len(ModuleLoader().get_detection_modules())
    plugin = discovery.build_plugin("demo-detector")
    loader.load(plugin)
    modules = ModuleLoader().get_detection_modules()
    assert any(m.name == "DemoDetector" for m in modules)
    assert plugin in loader.loaded_plugins
    ModuleLoader()._modules.remove(plugin)
    assert len(ModuleLoader().get_detection_modules()) == before


def test_loader_rejects_untyped_plugins():
    loader = MythrilPluginLoader()
    with pytest.raises(ValueError):
        loader.load(object())
    with pytest.raises(UnsupportedPluginType):
        loader.load(MythrilPlugin())


def test_a_reference_plugin_never_loads_into_the_port():
    disc = PluginDiscovery()
    disc._installed_plugins = {"reference-detector": _ReferenceDetector}
    with pytest.raises(ValueError):
        disc.build_plugin("reference-detector")
    MythrilPluginLoader._instance = None
    loader = MythrilPluginLoader()  # its default-enabled load logs, skips
    assert loader.loaded_plugins == []
    with pytest.raises(ValueError):
        loader.load(_ReferenceDetector())
    assert not any(m.name == "ReferenceDetector"
                   for m in ModuleLoader().get_detection_modules())


def test_discovery_reads_the_ports_group_only(monkeypatch):
    """The installed entry points of both groups: the port's discovery
    loads its group's, the JAX package's its own."""
    assert port_discovery.ENTRY_POINT_GROUP == "mythril_tpu_torch.plugins"
    assert ref_discovery.ENTRY_POINT_GROUP == "mythril_tpu.plugins"
    points = [
        SimpleNamespace(name="port-demo", group="mythril_tpu_torch.plugins",
                        load=lambda: _DemoDetector),
        SimpleNamespace(name="jax-demo", group="mythril_tpu.plugins",
                        load=lambda: _ReferenceDetector),
    ]

    class _Points(list):
        def select(self, group):
            return [point for point in self if point.group == group]

    import importlib.metadata

    monkeypatch.setattr(importlib.metadata, "entry_points",
                        lambda: _Points(points))
    disc = PluginDiscovery()
    disc._installed_plugins = None
    assert disc.installed_plugins == {"port-demo": _DemoDetector}
    reference = ref_discovery.PluginDiscovery()
    saved = reference._installed_plugins
    reference._installed_plugins = None
    try:
        assert reference.installed_plugins == {
            "jax-demo": _ReferenceDetector}
    finally:
        reference._installed_plugins = saved
