"""The port stands alone: no file of mythril_tpu_torch/, and not
chip_smoke.py, imports JAX or anything of the JAX package mythril_tpu."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mythril_tpu\b(?!_torch)"
    r"|from\s+mythril_tpu(\.|\s)(?!_torch))", re.MULTILINE)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for folder, _dirs, files in os.walk(os.path.join(ROOT,
                                                     "mythril_tpu_torch")):
        paths.extend(os.path.join(folder, name) for name in files
                     if name.endswith((".py", ".cu", ".cuh")))
    return sorted(paths)


def test_the_port_has_sources():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("mythril_tpu_torch", "csrc",
                        "ragged_round.cu") in names
    for module in ("flightrec", "metrics", "roofline", "stats_keys",
                   "tracer"):
        assert os.path.join("mythril_tpu_torch", "observe",
                            module + ".py") in names
    assert len(names) > 20


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as fd:
        source = fd.read()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(source)]
    assert not hits, f"{os.path.relpath(path, ROOT)} imports {hits}"


def test_the_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import lax",
                 "import mythril_tpu", "from mythril_tpu.smt import terms",
                 "    from mythril_tpu import preanalysis"):
        assert FORBIDDEN.search(line), line
    for line in ("import mythril_tpu_torch",
                 "from mythril_tpu_torch.smt import terms",
                 "# replaces mythril_tpu/tpu/pallas_kernel.py"):
        assert not FORBIDDEN.search(line), line


def test_every_reference_module_has_a_counterpart():
    """Every .py file of the JAX package has one in the port at the same
    path (tpu/ read as gpu/), apart from tpu/pallas_kernel.py, K1, which
    lives in csrc/ragged_round.cu and gpu/ragged_kernel.py."""
    reference = os.path.join(ROOT, "mythril_tpu")
    missing = []
    for folder, _dirs, files in os.walk(reference):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(folder, name), reference)
            parts = rel.split(os.sep)
            if parts[0] == "tpu":
                parts[0] = "gpu"
            if parts == ["gpu", "pallas_kernel.py"]:
                continue
            if not os.path.isfile(os.path.join(ROOT, "mythril_tpu_torch",
                                               *parts)):
                missing.append(rel)
    assert not missing, f"no counterpart in the port: {sorted(missing)}"
    for path in (("csrc", "ragged_round.cu"), ("gpu", "ragged_kernel.py")):
        assert os.path.isfile(os.path.join(ROOT, "mythril_tpu_torch",
                                           *path))
