"""The UNSAT second opinion and its provenance in the port's persistent
tier (the counterparts of tests/test_unsat_crosscheck.py): detection-path
UNSATs are crosschecked, engine-path ones are not, a memory-tier UNSAT is
final while a disk entry from another run is trusted on the detection
path only with confirmed provenance, and a second `analyze` process on a
warm disk tier hits it with the same findings and fewer settles."""

import contextlib
import json
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver import sat_backend
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import detection_context, get_model
from tests.test_analysis import KILLBILLY, wrap_creation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("MYTHRIL_GPU_UNSAT_CROSSCHECK", raising=False)
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    args.reset()
    args.solver_backend = "cpu"
    model_mod.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield
    args.reset()
    model_mod.clear_caches()
    stats.reset()


def _unsat_constraints(tag: str):
    x = symbol_factory.BitVecSym(f"xc_{tag}", 64)
    # not eliminable by word-level preprocessing: two interval bounds
    return [x * x > 100, x < 2, x > 0]


def _count_crosschecks(monkeypatch):
    calls = {"n": 0}
    original = sat_backend._crosscheck_unsat

    def counting(*c_args, **c_kwargs):
        calls["n"] += 1
        return original(*c_args, **c_kwargs)

    monkeypatch.setattr(sat_backend, "_crosscheck_unsat", counting)
    return calls


def test_engine_path_unsat_is_not_crosschecked_by_default(monkeypatch):
    calls = _count_crosschecks(monkeypatch)
    with pytest.raises(UnsatError):
        get_model(_unsat_constraints("b"))
    assert calls["n"] == 0


def test_cached_unsat_is_final_in_detection_context(monkeypatch):
    calls = _count_crosschecks(monkeypatch)
    constraints = _unsat_constraints("c")
    with pytest.raises(UnsatError):
        get_model(constraints)  # engine path: a plain memory-tier UNSAT
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # cache hit: no re-solve, no crosscheck
    assert calls["n"] == 0


@pytest.mark.parametrize("env,detection,expected", [
    pytest.param("0", True, 0, id="zero-force-disables"),
    pytest.param("1", False, 1, id="one-force-enables-engine-path"),
])
def test_env_knob(monkeypatch, env, detection, expected):
    monkeypatch.setenv("MYTHRIL_GPU_UNSAT_CROSSCHECK", env)
    monkeypatch.setenv("MYTHRIL_TPU_UNSAT_CROSSCHECK", str(1 - int(env)))
    calls = _count_crosschecks(monkeypatch)
    scope = detection_context() if detection else contextlib.nullcontext()
    with scope:
        with pytest.raises(UnsatError):
            get_model(_unsat_constraints(f"env{env}"))
    assert calls["n"] == expected


def test_crosscheck_confirmation_is_recorded(monkeypatch):
    """A crosscheck that ran and re-proved UNSAT is a confirmation; a
    cap-skipped one is not (provenance as confirmed, never as
    requested)."""
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(_unsat_constraints("ran"))
    assert sat_backend.last_crosscheck_confirmed()
    assert SolverStatistics().crosscheck_runs >= 1
    monkeypatch.setattr(sat_backend, "CROSSCHECK_CLAUSE_CAP", 1)
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(_unsat_constraints("skipped"))
    assert not sat_backend.last_crosscheck_confirmed()
    assert SolverStatistics().crosscheck_cap_skips >= 1


def test_cached_unsat_policy_memory_vs_persistent(monkeypatch):
    """The memory tier's UNSAT is final even in a detection context; a
    disk entry from another run is trusted there only with crosscheck
    provenance, otherwise re-solved, and the re-store upgrades it."""
    args.solve_cache = "disk"
    calls = _count_crosschecks(monkeypatch)
    constraints = _unsat_constraints("2tier")
    with pytest.raises(UnsatError):
        get_model(constraints)  # engine path: no crosscheck
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # memory tier, same process: final
    assert calls["n"] == 0
    model_mod.clear_caches()  # a "new process": only the disk tier is left
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # the unprovenanced entry: re-solved
    assert calls["n"] == 1
    model_mod.clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    with detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # the upgraded entry: trusted
    assert calls["n"] == 1
    assert stats.persistent_hits == 1


def _analyze_cli(tmp_path, label, backend_args):
    stats_path = str(tmp_path / f"stats_{label}.json")
    code_path = tmp_path / "killbilly.hex"
    code_path.write_text(wrap_creation(KILLBILLY))
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze",
         "-f", str(code_path), "-t", "1", "-o", "json",
         "--solver-timeout", "10000", "--solve-cache", "disk",
         "--execution-timeout", "120", "--pruning-factor", "1",
         *backend_args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "MYTHRIL_GPU_CALIBRATE": "0",
             "MYTHRIL_GPU_CACHE_DIR": str(tmp_path / "cli-cache"),
             "MYTHRIL_GPU_STATS_JSON": stats_path})
    assert proc.returncode == 1, proc.stderr[-2000:]
    output = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(stats_path) as fd:
        return sorted(i["swc-id"] for i in output["issues"]), json.load(fd)


@pytest.mark.parametrize("backend_args", [
    pytest.param(("--solver-backend", "cpu"), id="host"),
    pytest.param(("--torch-device", "cpu"), id="device"),
])
def test_persistent_cache_across_invocations(tmp_path, backend_args):
    """A second identical `analyze` process on the disk tier reports
    persistent_hits > 0 and fewer CDCL settles than the cold one, with
    the same findings; on the device backend K1's models are among what
    the first run stored."""
    cold_issues, cold = _analyze_cli(tmp_path, "cold", backend_args)
    warm_issues, warm = _analyze_cli(tmp_path, "warm", backend_args)
    assert cold_issues == warm_issues == ["106"]
    assert cold["persistent_stores"] > 0
    assert warm["persistent_hits"] > 0
    assert warm["cdcl_settles"] < cold["cdcl_settles"]
    if "--torch-device" in backend_args:
        assert cold["kernel_launches"] > 0
