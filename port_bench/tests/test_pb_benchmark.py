"""BENCHMARK.json against the benchmark's contract: keys, names, units and
lengths; every file it names is there; every cell reports set-up, another
end-to-end metric and a per-layer metric; every per-layer metric has its
reader; and nothing the harness runs imports JAX or the JAX package."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from port_bench import spec

ROOT = spec.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "mythril_tpu"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        return json.load(handle)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert all(_line(word) for word in bench["command"])
    for path in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path)
        assert os.path.isdir(os.path.join(ROOT, path))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_lines(bench):
    names = []
    for config in bench["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(config["name"])
        assert _line(config["source"]) and _line(config["why"])
        assert len(config["reduced"]) <= 16
        assert all(NAME.fullmatch(key) for key in config["reduced"])
        names.append(config["name"])
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.fullmatch(cell[key])
        assert cell["chips"] in (1, 4) and _line(cell["why"])
        names.append(cell["name"])
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(
            metric["unit"])
        assert metric["better"] in ("lower", "higher")
        names.append(metric["name"])
    assert len(names) == len(set(names))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in bench["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in bench["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"]) and metric["moves"] in e2e
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
        assert os.path.isfile(os.path.join(
            ROOT, "port_bench", "layers", metric["name"] + ".py"))


def test_cells(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    pairs = set()
    for cell in bench["workloads"]:
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        assert cell["config"] in configs
        assert os.path.isfile(os.path.join(
            ROOT, "port_bench", "traffic", cell["traffic"] + ".json"))
        loaded = spec.load_cell(cell["name"])
        reported = [m["name"] for m in loaded.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert loaded.per_layer
    used = {cell["config"] for cell in bench["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for config in bench["configs"]:
        assert config["file"].startswith("port_bench/")
        with open(os.path.join(ROOT, config["file"])) as handle:
            data = json.load(handle)
        assert all(key in data["envelope"] for key in config["reduced"])


def test_files_under_the_paths_are_named_from_name_characters(bench):
    for path in bench["paths"]:
        for folder, dirs, files in os.walk(os.path.join(ROOT, path)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for name in dirs + files:
                assert re.fullmatch(r"[A-Za-z0-9_.\-]+", name), name


def test_the_manifests_hold():
    spec.check_manifests()


def _imports(path):
    with open(path) as handle:
        tree = ast.parse(handle.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _harness_files():
    for folder, _dirs, files in os.walk(os.path.join(ROOT, "port_bench")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(folder, name)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _harness_files():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "port_bench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            imported = set(_imports(os.path.join(folder, name)))
            assert not imported & (FORBIDDEN | {"mythril_tpu_torch",
                                                "torch"}), name
    code = ("import sys, port_bench.reference.words, "
            "port_bench.reference.findings, port_bench.reference.bounds; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mythril_tpu', 'mythril_tpu_torch'}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.stdout.strip() == "[]", done.stderr
