"""The device solver fires, and shows, on the port's production path (the
stats cases of tests/test_analyze_routing.py): the stats line after a
device window names the dispatches and their occupancy, and
`python -m mythril_tpu_torch analyze --torch-device cpu` on a corpus
contract writes a stats JSON (MYTHRIL_GPU_STATS_JSON) with device hits,
no cap rejects, and the JAX package's sections."""

import json
import os
import subprocess
import sys

import pytest

from mythril_tpu.smt.solver.statistics import (
    SolverStatistics as ReferenceStatistics,
)
from mythril_tpu_torch.observe import roofline
from mythril_tpu_torch.smt import Extract, ULT, symbol_factory
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import get_models_batch
from tests.test_torch_stats_keys import NOT_PORTED, PORT_ONLY, RENAMED

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = os.path.join(REPO_ROOT, "bench_inputs", "corpus",
                        "xc_dispatch_a.hex")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    model_mod.clear_caches()
    yield
    model_mod.clear_caches()
    stats.reset()
    args.reset()


def _production_shape_queries(n):
    """256-bit selector dispatch, a callvalue guard and an adder
    inequality: the constraint mix of analyze's JUMPI forks."""
    queries = []
    for qi in range(n):
        data = symbol_factory.BitVecSym(f"route_data_{qi}", 256)
        value = symbol_factory.BitVecSym(f"route_value_{qi}", 256)
        sender = symbol_factory.BitVecSym(f"route_sender_{qi}", 256)
        selector = (0xAB125858 ^ (qi * 0x01010101)) & 0xFFFFFFFF
        queries.append([
            Extract(255, 224, data) == symbol_factory.BitVecVal(selector, 32),
            ULT(value, symbol_factory.BitVecVal(1 << 40, 256)),
            sender != symbol_factory.BitVecVal(0, 256),
            value + data != sender,
        ])
    return queries


def test_stats_line_reports_routing():
    stats = SolverStatistics()
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    outcomes = get_models_batch(_production_shape_queries(2))
    assert all(status == "sat" for status, _model in outcomes)
    assert stats.device_dispatches >= 1, "the router never dispatched"
    text = repr(stats)
    assert "device dispatches" in text
    assert "occupancy" in text


def test_analyze_cli_device_hits_and_stats_json(tmp_path):
    """The whole production path through the CLI on K1's plain version:
    device hits, zero cap rejects, and a completed stats JSON with the
    JAX package's key set (less the named unported keys), every roofline
    stage, the per-site resilience section and the opcode histogram."""
    stats_path = tmp_path / "stats.json"
    env = {**os.environ, "MYTHRIL_GPU_CALIBRATE": "0",
           "MYTHRIL_GPU_STATS_JSON": str(stats_path),
           "MYTHRIL_GPU_FLIGHTREC_DIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze",
         "--torch-device", "cpu", "-f", CONTRACT, "-t", "1", "-o", "json"],
        capture_output=True, text=True, timeout=600, cwd=REPO_ROOT, env=env)
    assert proc.returncode in (0, 1), proc.stderr[-2000:]
    stats = json.loads(stats_path.read_text())
    assert stats["device_batch_hits"] > 0, stats
    assert stats["cap_rejects"] == 0
    assert stats["completed"] is True
    assert stats["platform"] == "cpu"
    assert stats["kernel_backend"] == "plain"
    assert stats["kernel_launches"] > 0
    assert set(stats["roofline"]["stages"]) == set(roofline.STAGES)
    # no fault armed: the JAX package's empty spec
    assert stats["resilience"]["faults_active"] == ""
    assert isinstance(stats["resilience"]["sites"], dict)
    assert sum(count for count, _s in stats["interp_opcode_wall"].values())
    reference = set(ReferenceStatistics().as_dict())
    stamp = {"completed", "schema_version", "git_rev", "platform"}
    expected = ((reference - set(NOT_PORTED) - set(RENAMED))
                | set(RENAMED.values()) | PORT_ONLY | stamp)
    assert set(stats) == expected
