"""The port's router on its bucketed path (MYTHRIL_GPU_RAGGED=0 or
--no-ragged): the bucketed half of tests/test_router.py against a scripted
backend (caps and their env overrides, counted oversize cones, the tiny
host shortcut, the cost model and its floor exemption, the evidence
dispatch cap and slot trim, level-bucketed groups, the flag and env gate),
K3's calibration against a stubbed timer, and one parity case: with
calibration off in both packages, the port's bucket groups and admission
counters on the sibling window equal the JAX package's router's.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu.smt.solver.statistics import (
    SolverStatistics as RefStatistics,
)
from mythril_tpu.support import model as ref_model
from mythril_tpu.tpu import router as ref_router_mod
from mythril_tpu_torch.gpu import backend as port_backend
from mythril_tpu_torch.gpu import circuit_kernel, ragged_kernel
from mythril_tpu_torch.gpu import router as router_mod
from mythril_tpu_torch.gpu.router import LEVEL_CAP_FLOOR, QueryRouter
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from tests.test_torch_router import _prepared, _unit_key


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_TPU_CALIBRATE", "0")
    for name in ("MYTHRIL_GPU_PREANALYSIS", "MYTHRIL_TPU_PREANALYSIS",
                 "MYTHRIL_GPU_COALESCE_MAX", "MYTHRIL_GPU_LEVEL_CAP",
                 "MYTHRIL_GPU_CELL_CAP", "MYTHRIL_GPU_VAR_CAP"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_backend, "_backends", {})
    port_model.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    port_model.clear_caches()
    port_args.reset()


class FakePC:
    def __init__(self, levels, v1=100, width=4, ok=True):
        self.num_levels = levels
        self.v1 = v1
        self.max_width = width
        self.ok = ok
        self.num_roots = 1
        self.level_rows = np.full((levels,), width, dtype=np.int64)


class FakeBackend:
    """Scripted DeviceSolverBackend: `answers` maps id(pc) -> model bits
    (or None); each problem's aig_roots slot carries its FakePC."""

    num_restarts = 16
    CIRCUIT_STEPS = 64

    def __init__(self, answers=None):
        self.device = torch.device("cpu")
        self.answers = answers or {}
        self.dispatch_log = []  # (pc ids, budget, kwargs) per dispatch
        self.cap_rejects = 0
        self.pack_hits = self.pack_misses = 0
        self.pack_seconds = self.ship_seconds = 0.0

    def count_cap_reject(self, count=1, under_floor=False):
        self.cap_rejects += count
        SolverStatistics().add_cap_reject(count, under_floor=under_floor)

    def pack_problem(self, problem, v1_cap):
        pc = problem[2]
        if pc.v1 > v1_cap:
            self.count_cap_reject()
            return None
        return pc

    def padded_query_slots(self, n, single_device=False):
        q = 1
        while q < n:
            q *= 2
        return q

    def try_solve_batch_circuit(self, problems, budget_seconds=4.0,
                                size_caps=None, **kwargs):
        self.dispatch_log.append(
            ([id(p[2]) for p in problems], budget_seconds, kwargs))
        return [self.answers.get(id(p[2])) for p in problems]

    def try_solve_batch_ragged(self, problems, **kwargs):
        pytest.fail("the bucketed mode never launches a ragged stream")


def problem(pc):
    return (pc.v1 - 1, [], pc)


def test_caps_admit_analyze_scale_cones_by_default():
    level, cell, var = QueryRouter(FakeBackend()).resolve_caps()
    assert level >= LEVEL_CAP_FLOOR >= 640
    assert cell >= 540 * 1040
    assert var >= 5546


def test_cap_env_overrides(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_LEVEL_CAP", "123")
    monkeypatch.setenv("MYTHRIL_GPU_CELL_CAP", "789")
    monkeypatch.setenv("MYTHRIL_GPU_VAR_CAP", "456")
    assert QueryRouter(FakeBackend()).resolve_caps() == (123, 789, 456)


def test_oversize_cones_counted_not_silent(fresh_state):
    backend = FakeBackend()
    router = QueryRouter(backend)
    deep = FakePC(5000)             # past any level cap
    wide = FakePC(500, v1=1 << 20)  # past the var cap: pre-pack reject
    results = router.dispatch([problem(deep), problem(wide)],
                              timeout_s=10.0, stats=fresh_state)
    assert results == [None, None]
    assert backend.cap_rejects == fresh_state.cap_rejects == 2
    assert fresh_state.cap_rejects_floor == 0
    assert backend.dispatch_log == []


def test_tiny_cones_host_direct(fresh_state):
    backend = FakeBackend()
    router = QueryRouter(backend)
    assert router.dispatch([problem(FakePC(8))], timeout_s=10.0,
                           stats=fresh_state) == [None]
    assert fresh_state.router_host_direct == 1
    assert backend.dispatch_log == []


def test_cost_model_deadline_fallback():
    """An above-floor cone whose one round already busts the round budget
    is never shipped, and counted as a cap reject."""
    backend = FakeBackend()
    router = QueryRouter(backend)
    router._rates["per_cell_s"] = 1.0
    assert router.dispatch([problem(FakePC(700))], timeout_s=10.0) == [None]
    assert backend.cap_rejects == 1
    assert backend.dispatch_log == []


def test_floor_cones_exempt_from_cost_model():
    backend = FakeBackend()
    router = QueryRouter(backend)
    router._rates["per_cell_s"] = 1.0
    router.dispatch([problem(FakePC(540))], timeout_s=10.0)
    assert backend.cap_rejects == 0
    assert len(backend.dispatch_log) == 1


def test_cost_model_charges_k3_latency_and_prep_overhead():
    backend = FakeBackend()
    router = QueryRouter(backend)
    steps2 = router._profile_steps() * 2
    assert router.est_round_seconds(10, 100) == pytest.approx(
        1e-7 * steps2 * 1000)
    router._rates["per_cell_s"] = 2e-9
    assert router.est_round_seconds(10, 100) == pytest.approx(
        2e-9 * steps2 * 1000)
    assert router.prep_overhead_seconds() == 0.0
    backend.pack_hits, backend.pack_misses = 3, 1
    backend.pack_seconds, backend.ship_seconds = 0.3, 0.1
    assert router.prep_overhead_seconds() == pytest.approx(0.1)
    # the roofline's kernel stage ranks against K3's rate here
    assert router.attainable_rates() == {
        "kernel_cells_s": pytest.approx(5e8)}


def test_dispatch_budget_bounded_by_deadline_and_timeout():
    backend = FakeBackend()
    router = QueryRouter(backend)
    router.dispatch([problem(FakePC(500))], timeout_s=1.0)
    assert backend.dispatch_log[-1][1] <= 0.6 * 1.0 + 1e-6
    router.dispatch([problem(FakePC(500))], timeout_s=100.0)
    assert backend.dispatch_log[-1][1] <= router.dispatch_deadline() + 1e-6


def test_evidence_mode_dispatch_cap(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CPU_DISPATCH_CAP", "2")
    pcs = [FakePC(500) for _ in range(3)]
    backend = FakeBackend(answers={id(pc): [True] for pc in pcs})
    router = QueryRouter(backend)
    assert router.dispatch([problem(pcs[0])], timeout_s=10.0) == [[True]]
    assert router.dispatch([problem(pcs[1])], timeout_s=10.0) == [[True]]
    assert router.dispatch([problem(pcs[2])], timeout_s=10.0) == [None]
    assert len(backend.dispatch_log) == 2
    assert router.ragged_windows == 0 and router.dispatches == 2


def test_evidence_mode_trims_dispatch_to_slot_cap(monkeypatch, fresh_state):
    monkeypatch.setenv("MYTHRIL_GPU_CPU_BATCH_SLOTS", "2")
    pcs = [FakePC(500) for _ in range(5)]
    backend = FakeBackend(answers={id(pc): [True] for pc in pcs})
    router = QueryRouter(backend)
    results = router.dispatch([problem(pc) for pc in pcs], timeout_s=10.0,
                              stats=fresh_state)
    assert [len(ids) for ids, _b, _k in backend.dispatch_log] == [2]
    assert sum(1 for r in results if r is not None) == 2
    assert fresh_state.router_slot_overflow == 3
    assert fresh_state.router_host_direct == 0


def test_evidence_profile_shrinks_device_work():
    backend = FakeBackend()
    QueryRouter(backend).dispatch([problem(FakePC(500))], timeout_s=10.0)
    _ids, _budget, kwargs = backend.dispatch_log[0]
    assert kwargs["num_restarts"] == QueryRouter.CPU_PROFILE_RESTARTS
    assert kwargs["steps"] == QueryRouter.CPU_PROFILE_STEPS


def test_level_bucketed_dispatch_groups(monkeypatch, fresh_state):
    """Mixed depths split into per-bucket dispatches, the fullest first."""
    monkeypatch.setenv("MYTHRIL_GPU_CPU_DISPATCH_CAP", "10")
    monkeypatch.setenv("MYTHRIL_GPU_CPU_BATCH_SLOTS", "8")
    shallow = [FakePC(130), FakePC(140), FakePC(135)]
    deep = [FakePC(540)]
    backend = FakeBackend(answers={id(pc): [True] for pc in shallow + deep})
    router = QueryRouter(backend)
    results = router.dispatch([problem(pc) for pc in shallow + deep],
                              timeout_s=10.0, stats=fresh_state)
    assert results == [[True]] * 4
    assert [len(ids) for ids, _b, _k in backend.dispatch_log] == [3, 1]
    assert fresh_state.device_dispatches == 2
    assert fresh_state.device_dispatched_queries == 4
    assert fresh_state.device_slots == 4 + 1  # pow2 padding: 3->4, 1->1


def test_flag_and_env_gate(monkeypatch):
    """--no-ragged selects the bucketed path; MYTHRIL_GPU_RAGGED wins over
    the flag in both directions."""
    monkeypatch.delenv("MYTHRIL_GPU_RAGGED", raising=False)
    monkeypatch.setattr(port_args, "no_ragged", False)
    assert router_mod.ragged_enabled()
    monkeypatch.setattr(port_args, "no_ragged", True)
    assert not router_mod.ragged_enabled()
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "1")
    assert router_mod.ragged_enabled()
    monkeypatch.setattr(port_args, "no_ragged", False)
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0")
    assert not router_mod.ragged_enabled()
    # the JAX package's knob steers nothing here
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "1")
    monkeypatch.setenv("MYTHRIL_TPU_RAGGED", "0")
    assert router_mod.ragged_enabled()


def test_scheduler_window_stays_narrow_on_the_bucketed_path(monkeypatch):
    from mythril_tpu_torch.service import scheduler as sched_mod

    monkeypatch.setattr(port_args, "solver_backend", "gpu")
    assert (sched_mod.CoalescingScheduler().max_batch
            == sched_mod.DEFAULT_COALESCE_MAX == 16)
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "1")
    assert (sched_mod.CoalescingScheduler().max_batch
            == sched_mod.DEFAULT_COALESCE_MAX_RAGGED)


# -- K3's calibration ---------------------------------------------------------


class _Clock:
    """perf_counter stand-in: each call advances by `step` seconds."""

    def __init__(self, step):
        self.now = 0.0
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


def test_k3_calibration_times_the_round_and_persists(monkeypatch, tmp_path):
    """per_cell_s is the timed launch (after one warm-up) over CAL_STEPS x
    2 x the calibration cone's levels x width; it raises the level cap
    at most 4x and never below the floor; the ship rate comes with it; a
    persisted entry with per_cell_s skips the measurement, and one with
    K1's rate alone measures K3 and nothing else. K1 never launches."""
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel",
                        lambda *a, **k: pytest.fail("K1 launched"))
    shapes = []
    real = circuit_kernel.run_round_circuit_kernel

    def recorded(tensors, *args, **kwargs):
        shapes.append(tuple(tensors["out_idx"].shape))
        return real(tensors, *args, **kwargs)

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel", recorded)
    monkeypatch.setattr(router_mod, "time", SimpleNamespace(
        perf_counter=_Clock(0.5), monotonic=time.monotonic))
    router = router_mod.get_router("cpu")
    level, _cell, _var = router.resolve_caps()
    assert len(shapes) == 2, "one warm-up launch, one timed launch"
    _q, levels, width = shapes[0]
    per_cell = router._rates["per_cell_s"]
    assert per_cell == pytest.approx(
        0.5 / (router_mod.CAL_STEPS * 2 * levels * width))
    want = int(router.round_budget_s
               / (per_cell * router._profile_steps() * 2 * 1024))
    assert level == max(LEVEL_CAP_FLOOR,
                        min(want, router_mod.DEFAULT_LEVEL_CAP_CPU * 4))
    rates = router.attainable_rates()
    assert rates["kernel_cells_s"] == pytest.approx(1 / per_cell)
    assert {"ship_bytes_s", "pack_bytes_s", "settle_clauses_s"} <= set(rates)
    assert not (tmp_path / "calibration.json").exists()

    from mythril_tpu_torch.service.calibration import (
        load_profile,
        save_profile,
    )

    port_args.solve_cache = "disk"
    router_mod.reset_router()
    router = router_mod.get_router("cpu")
    key = (router._platform(), router._profile_restarts(),
           router._profile_steps())
    save_profile(*key, {"kernel_cells_s": 7e6, "pack_bytes_s": 1e8,
                        "ragged_bytes_s": 2e8, "settle_clauses_s": 3e6})
    monkeypatch.setattr(QueryRouter, "_measure_stage_rates", lambda self:
                        pytest.fail("the stage rates were persisted"))
    shapes.clear()
    router.resolve_caps()
    assert len(shapes) == 2, "an entry without per_cell_s measures K3"
    stored = load_profile(*key)
    assert stored["kernel_cells_s"] == pytest.approx(7e6)
    assert stored["per_cell_s"] > 0 and stored["ship_bytes_s"] > 0
    router_mod.reset_router()
    shapes.clear()
    router_mod.get_router("cpu").resolve_caps()
    assert shapes == [], "a persisted per_cell_s skips the measurement"


def test_ragged_path_never_calibrates_k3(monkeypatch):
    """With the ragged path live the router resolves no bucketed caps: K3
    is neither built nor launched, and its rate is not in the ceilings."""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel",
                        lambda *a, **k: pytest.fail("K3 launched"))
    monkeypatch.setattr(QueryRouter, "resolve_caps",
                        lambda self: pytest.fail("bucketed caps resolved"))
    router = router_mod.get_router("cpu")
    router._calibrate()
    assert "per_cell_s" not in router._rates
    assert "ship_bytes_s" not in router.attainable_rates()


# -- against the JAX package's router -----------------------------------------


ADMISSION_COUNTERS = ("router_host_direct", "cap_rejects",
                      "router_slot_overflow", "device_dispatches",
                      "device_dispatched_queries", "device_slots",
                      "aig_device_components",
                      "router_dispatched_clauses")


@pytest.mark.parametrize("slots", [2, 64])
def test_bucket_groups_equal_the_reference_router(monkeypatch, fresh_state,
                                                  slots):
    monkeypatch.setenv("MYTHRIL_TPU_RAGGED", "0")
    for prefix in ("MYTHRIL_TPU_", "MYTHRIL_GPU_"):
        monkeypatch.setenv(prefix + "CPU_DISPATCH_CAP", "100")
        monkeypatch.setenv(prefix + "CPU_BATCH_SLOTS", str(slots))
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    ref_model.clear_caches()
    ref_router_mod.reset_router()
    ref_stats = RefStatistics()
    ref_stats.reset()
    ref_stats.enabled = True
    try:
        ref_problems, _pairs = _prepared(ref_frontend, ref_smt, "sibling")
        problems, _pairs = _prepared(port_frontend, port_smt, "sibling")
        ref_router = ref_router_mod.get_router()
        ref_groups = []

        def ref_record(group, remaining, caps, profile):
            ref_groups.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(ref_router, "_guarded_dispatch", ref_record)
        ref_router.dispatch(ref_problems, 20.0, ref_stats)

        router = router_mod.get_router("cpu")
        groups = []

        def record(group, remaining, caps, profile):
            groups.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(router, "_guarded_dispatch", record)
        router.dispatch(problems, 20.0, fresh_state)

        assert groups == ref_groups
        assert groups, "the window reached the device"
        port_counts, ref_counts = fresh_state.as_dict(), ref_stats.as_dict()
        for key in ADMISSION_COUNTERS:
            assert port_counts.get(key, 0) == ref_counts.get(key, 0), key
        if slots == 2:
            assert port_counts["router_slot_overflow"] > 0
    finally:
        ref_stats.reset()
        ref_model.clear_caches()
        ref_router_mod.reset_router()
