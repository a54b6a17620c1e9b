"""The port's support layers: env knob resolution, the span tracer, the
Solver -> sat_backend device seam, and the package layout."""

import json

import pytest

import mythril_tpu_torch.smt as smt
from mythril_tpu_torch.gpu import backend as backend_mod
from mythril_tpu_torch.observe import tracer
from mythril_tpu_torch.smt.solver import sat_backend
from mythril_tpu_torch.smt.solver.frontend import Solver
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import env
from mythril_tpu_torch.support.args import args


def test_env_precedence_env_over_cli_over_default(monkeypatch):
    name = "MYTHRIL_GPU_TEST_KNOB"
    monkeypatch.delenv(name, raising=False)
    env.clear_overrides()
    assert env.env_int(name, 3) == 3
    env.set_cli(name, "7")
    assert env.resolve_source(name, 3, kind="int") == (7, "cli")
    monkeypatch.setenv(name, "11")
    assert env.env_int(name, 3) == 11
    monkeypatch.setenv(name, "not-a-number")
    # a present-but-malformed env var pins the default, never the cli value
    assert env.resolve_source(name, 3, kind="int") == (3, "default")
    env.clear_overrides()


def test_tracer_is_a_shared_noop_until_enabled(tmp_path):
    """With the flight recorder's ring detached (MYTHRIL_GPU_FLIGHTREC=0),
    span() is the shared no-op until tracing is enabled, and again after
    a reset."""
    trace = tracer.get_tracer()
    trace.reset()
    ring = trace._ring
    trace.attach_ring(None)
    try:
        assert tracer.span("x") is tracer.NULL_SPAN
        trace.enable(str(tmp_path / "trace.json"))
        with tracer.span("device.kernel", cat="device", cones=3) as sp:
            sp.set(rounds=2)
        assert trace.summary()["device.kernel"][0] == 1
        path = trace.write()
        events = json.load(open(path))["traceEvents"]
        kernel = [e for e in events if e["name"] == "device.kernel"]
        assert kernel[0]["args"] == {"cones": 3, "rounds": 2}
        trace.reset()
        assert tracer.span("x") is tracer.NULL_SPAN
    finally:
        trace.reset()
        trace.attach_ring(ring)


def test_solver_seam_sends_a_probe_miss_to_the_device(monkeypatch):
    """With solver_backend "gpu", a query the conflict-budgeted CDCL probe
    cannot settle goes to the device backend; its model comes back
    through the word-level validation."""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "16384")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setattr(backend_mod, "_backends", {})
    real_solve = sat_backend.PrepSession.solve

    def probe_gives_up(self, assumptions, timeout_seconds=0.0,
                       conflict_budget=0):
        if conflict_budget == 20000:
            return sat_backend.UNKNOWN, None
        return real_solve(self, assumptions, timeout_seconds,
                          conflict_budget)

    monkeypatch.setattr(sat_backend.PrepSession, "solve", probe_gives_up)
    monkeypatch.setattr(args, "solver_backend", "gpu")
    monkeypatch.setattr(args, "torch_device", "cpu")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    try:
        a = smt.symbol_factory.BitVecSym("seam_a", 256)
        b = smt.symbol_factory.BitVecSym("seam_b", 256)
        solver = Solver(timeout=30)
        solver.add(smt.ULT(a + b, a))
        assert solver.check() == "sat"
        model = solver.model()
        assert model.eval_int(a + b) < model.eval_int(a)
        assert stats.device_batch_queries == 1
        assert stats.device_batch_hits == 1
        assert stats.kernel_launches >= 1
    finally:
        stats.reset()
        stats.enabled = False


def test_backend_device_default_is_cuda_or_raise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend_mod.get_device_backend()
    assert backend_mod.get_device_backend("cpu").device.type == "cpu"
