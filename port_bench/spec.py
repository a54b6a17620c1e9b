"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the readers of its per-layer metrics
(layers/<metric>.py), and the sha256 manifests of the frozen inputs
(data/MANIFEST*.json), checked before a run."""

import glob
import hashlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]   # the cell's end-to-end metrics
    per_layer: List[dict]    # the cell's per-layer metrics


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        return json.load(handle)


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_benchmark()
    cells = {cell["name"]: cell for cell in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"port_bench: no workload {name!r} in "
                         f"BENCHMARK.json ({', '.join(sorted(cells))})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, config["file"])) as handle:
        config_data = json.load(handle)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) \
            as handle:
        mix = json.load(handle)
    end_to_end = [m for m in bench["end_to_end"] if _reported_in(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _reported_in(m, name) and m["moves"] in reported]
    return Cell(name, int(cell["chips"]), config_data, mix, end_to_end,
                per_layer)


def reader(metric: str) -> Callable:
    """The `read(run)` function of layers/<metric>.py."""
    path = os.path.join(HERE, "layers", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.layers." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def check_manifests() -> None:
    """Every file a manifest under data/ pins must hash to its entry."""
    for manifest in sorted(glob.glob(os.path.join(HERE, "data",
                                                  "MANIFEST*.json"))):
        with open(manifest) as handle:
            pinned: Dict[str, str] = json.load(handle)["sha256"]
        for path, digest in pinned.items():
            with open(os.path.join(ROOT, path), "rb") as handle:
                if hashlib.sha256(handle.read()).hexdigest() != digest:
                    raise SystemExit(f"port_bench: {path} differs from "
                                     f"its pin in {manifest}")
