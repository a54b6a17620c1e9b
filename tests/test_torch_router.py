"""The port's adaptive router (mythril_tpu_torch/gpu/router.py), ragged path.

Two halves:

- Against the JAX package's router (mythril_tpu/tpu/router.py) run under
  its Pallas rules (MYTHRIL_TPU_KERNEL=pallas), whose round K1 ports: the
  same window prepared with pre-analysis on in both packages, the same
  kernel rate injected into both routers, and a recording stub in place of
  each one's stream dispatch. The admission counters and the streams
  (which cones, components and fork sides ride each one, in which order)
  must be equal.
- The ragged half of tests/test_router.py against a scripted backend
  (admission, chunking, the evidence caps, the breaker),
  plus the real backend on device "cpu": fork-pair packing, component
  dispatch and recomposition, calibration against a stubbed timer, and a
  kernel error that must reach the caller.
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
from mythril_tpu_torch.gpu import ragged_kernel
from mythril_tpu_torch.gpu import router as router_mod
from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
from mythril_tpu_torch.gpu.router import QueryRouter
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import fork_window, sibling_window


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_TPU_CALIBRATE", "0")
    for name in ("MYTHRIL_GPU_PREANALYSIS",
                 "MYTHRIL_TPU_PREANALYSIS", "MYTHRIL_GPU_COALESCE_MAX"):
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


# -- the scripted backend -----------------------------------------------------


class FakePC:
    def __init__(self, levels, v1=100, width=4, ok=True, roots=1):
        self.num_levels = levels
        self.v1 = v1
        self.max_width = width
        self.ok = ok
        self.num_roots = roots
        self.level_rows = np.full((levels,), width, dtype=np.int64)


class FakeBackend:
    """Scripted DeviceSolverBackend: `answers` maps id(pc) -> model bits
    (or None); each problem's aig_roots slot carries its FakePC."""

    num_restarts = 16
    CIRCUIT_STEPS = 64

    def __init__(self, answers=None):
        self.device = torch.device("cpu")
        self.answers = answers or {}
        self.ragged_log = []  # (pc ids, budget, kwargs) per stream
        self.cap_rejects = 0
        self.ragged_windows = 0
        self.ragged_seconds = 0.0

    def count_cap_reject(self, count=1, under_floor=False):
        self.cap_rejects += count
        SolverStatistics().add_cap_reject(count, under_floor=under_floor)

    def pack_problem(self, problem, v1_cap):
        pc = problem[2]
        if pc.v1 > v1_cap:
            self.count_cap_reject()
            return None
        return pc

    def try_solve_batch_ragged(self, problems, budget_seconds=4.0, **kwargs):
        self.ragged_log.append(
            ([id(p[2]) for p in problems], budget_seconds, kwargs))
        return [self.answers.get(id(p[2])) for p in problems]


def problem(pc):
    return (pc.v1 - 1, [], pc)


def test_deep_cone_is_admitted_without_a_level_cap():
    """A 600-level cone is past any bucketed level cap; ragged admission
    checks bytes, so it packs like any other."""
    deep = FakePC(600)
    backend = FakeBackend(answers={id(deep): [True]})
    router = QueryRouter(backend)
    assert router.dispatch([problem(deep)], timeout_s=10.0) == [[True]]
    assert backend.cap_rejects == 0
    assert len(backend.ragged_log) == 1


def test_one_launch_covers_mixed_shapes(fresh_state):
    pcs = [FakePC(130), FakePC(140), FakePC(135), FakePC(540)]
    backend = FakeBackend(answers={id(pc): [True] for pc in pcs})
    router = QueryRouter(backend)
    results = router.dispatch([problem(pc) for pc in pcs], timeout_s=10.0,
                              stats=fresh_state)
    assert results == [[True]] * 4
    assert len(backend.ragged_log) == 1, "one flat stream, one launch"
    assert fresh_state.device_dispatches == 1
    assert fresh_state.device_slots == 4, "ragged slots == cones"


def test_tiny_cones_go_host_direct(fresh_state):
    backend = FakeBackend()
    router = QueryRouter(backend)
    assert router.dispatch([problem(FakePC(8))], timeout_s=10.0,
                           stats=fresh_state) == [None]
    assert fresh_state.router_host_direct == 1
    assert backend.ragged_log == []


def test_memory_budget_is_the_admission_cap(monkeypatch):
    small = FakePC(300)
    huge = FakePC(300, width=400)
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_STREAM_BYTES",
                       str(DeviceSolverBackend.ragged_entry_bytes(small) + 1))
    backend = FakeBackend(answers={id(small): [True], id(huge): [True]})
    router = QueryRouter(backend)
    results = router.dispatch([problem(small), problem(huge)],
                              timeout_s=10.0)
    assert results == [[True], None]
    assert backend.cap_rejects == 1, "over-budget cone counted, not silent"
    assert [len(ids) for ids, _b, _k in backend.ragged_log] == [1]


@pytest.mark.parametrize("bound", ["stream_bytes", "var_cap", "cone_cap"])
def test_windows_chunk_to_each_stream_bound(monkeypatch, bound):
    """Admission is per cone, chunking per window: two cones per stream
    under each bound in turn (the stream's bytes, the kernel's variable
    space with var 0 shared, its cone slots)."""
    pcs = [FakePC(300, v1=100) for _ in range(4)]
    if bound == "stream_bytes":
        entry = DeviceSolverBackend.ragged_entry_bytes(pcs[0])
        monkeypatch.setenv("MYTHRIL_GPU_RAGGED_STREAM_BYTES",
                           str(2 * entry + 1))
    elif bound == "var_cap":
        # two 99-var pages fit 250 variables (1 + 198), three do not
        monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "250")
    else:
        monkeypatch.setenv("MYTHRIL_GPU_RAGGED_CONE_CAP", "2")
    backend = FakeBackend(answers={id(pc): [True] for pc in pcs})
    router = QueryRouter(backend)
    results = router.dispatch([problem(pc) for pc in pcs], timeout_s=10.0)
    assert results == [[True]] * 4
    assert [len(ids) for ids, _b, _k in backend.ragged_log] == [2, 2]


def test_cone_past_a_kernel_capacity_is_a_cap_reject(monkeypatch):
    """A cone whose roots or variables alone exceed K1's slots is no
    longer a cap reject (mythril_tpu admits it and falls back to its XLA
    round): in the pallas mode it rides the device in a chunk of its own,
    so the cone beside it stays on K1. Nothing is counted as a cap
    reject. (The name dates from before K2, when it was one; it is kept
    so that the test's history reads on.)"""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_ROOT_CAP", "4")
    many_roots = FakePC(300, roots=5)
    fits = FakePC(300, roots=4)
    backend = FakeBackend(answers={id(fits): [True]})
    router = QueryRouter(backend)
    results = router.dispatch([problem(many_roots), problem(fits)],
                              timeout_s=10.0)
    assert results == [None, [True]]
    assert backend.cap_rejects == 0
    assert [ids for ids, _b, _k in backend.ragged_log] == [
        [id(many_roots)], [id(fits)]]


def test_admission_has_no_cost_veto_and_the_round_budget_chunks():
    """The JAX package's Pallas rules: a cone whose one round alone busts
    the chunk budget is still admitted (only "tiny" and the memory budget
    turn a cone away), and the chunker's round budget splits the window."""
    router = QueryRouter(FakeBackend())
    deep = FakePC(700, width=256)
    caps = ragged_kernel.kernel_caps()
    cells = router_mod.shape_bucket(700) * router_mod.shape_bucket(256)
    # a rate at which one round over this cone costs twice the budget
    router._rates["kernel_cells_s"] = (
        router._profile_steps() * 2 * cells
        / (2.0 * router.ragged_chunk_budget_s()))
    assert router._admission_ragged(deep) == "device"
    assert (router._admission_ragged(FakePC(router.host_direct_levels))
            == "tiny")
    window = [router_mod._Unit(i, None, FakePC(700, width=256), None)
              for i in range(3)]
    assert [len(c) for c in router._chunk_ragged(window, caps)] == [1, 1, 1]


def test_cost_model_charges_the_measured_kernel_rate():
    router = QueryRouter(FakeBackend())
    steps2 = router._profile_steps() * 2
    # uncalibrated: the evidence-mode constant
    assert router.est_ragged_round_seconds(1000) == pytest.approx(
        1e-7 * steps2 * 1000)
    router._rates["kernel_cells_s"] = 4e7
    assert router.est_ragged_round_seconds(1000) == pytest.approx(
        steps2 * 1000 / 4e7)
    assert router.attainable_rates() == {"kernel_cells_s": 4e7}


def test_mixed_origin_windows_interleave_and_are_not_cone_capped():
    """The JAX package's mixed-origin cone cap is an XLA compile guard and
    retires under its Pallas rules; the window still round-robins origins
    before chunking."""
    router = QueryRouter(FakeBackend())
    pcs = [FakePC(300) for _ in range(6)]
    window = [router_mod._Unit(i, None, pc, problem(pc),
                               origin="even" if i < 3 else "odd")
              for i, pc in enumerate(pcs)]
    ordered = router._order_window(window)
    assert [unit.qi for unit in ordered] == [0, 3, 1, 4, 2, 5]
    chunks = router._chunk_ragged(ordered, ragged_kernel.kernel_caps())
    assert [len(c) for c in chunks] == [6]


def test_evidence_profile_and_window_cap(monkeypatch):
    """On device "cpu" the router runs the evidence profile (8 lanes,
    32-step rounds, cube width 3) and at most RAGGED_WINDOW_CAP streams
    per process; past it the host takes everything."""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "2")
    pcs = [FakePC(500) for _ in range(3)]
    backend = FakeBackend(answers={id(pc): [True] for pc in pcs})
    router = QueryRouter(backend)
    assert router.dispatch([problem(pcs[0])], timeout_s=10.0) == [[True]]
    assert router.dispatch([problem(pcs[1])], timeout_s=10.0) == [[True]]
    assert router.dispatch([problem(pcs[2])], timeout_s=10.0) == [None]
    assert len(backend.ragged_log) == 2
    kwargs = backend.ragged_log[0][2]
    assert kwargs["num_restarts"] == QueryRouter.CPU_PROFILE_RESTARTS
    assert kwargs["steps"] == QueryRouter.CPU_PROFILE_STEPS
    assert kwargs["cube_vars"] == 3
    assert router.dispatch_deadline() == 2.5


def test_dispatch_budget_bounded_by_deadline_and_timeout():
    backend = FakeBackend()
    router = QueryRouter(backend)
    router.dispatch([problem(FakePC(500))], timeout_s=1.0)
    assert backend.ragged_log[-1][1] <= 0.6 * 1.0 + 1e-6
    router.dispatch([problem(FakePC(500))], timeout_s=100.0)
    assert backend.ragged_log[-1][1] <= router.dispatch_deadline() + 1e-6


def test_breaker_opens_after_fruitless_device_time(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_MAX_WASTE", "0.5")
    backend = FakeBackend()
    router = QueryRouter(backend)
    router.record_dispatch(hits=0, seconds=0.6)
    assert not router.device_usable()
    assert router.dispatch([problem(FakePC(500))], timeout_s=10.0) == [None]
    assert backend.ragged_log == []


def test_a_hit_resets_the_waste_meter(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_MAX_WASTE", "1.0")
    router = QueryRouter(FakeBackend())
    router.record_dispatch(hits=0, seconds=0.7)
    router.record_dispatch(hits=2, seconds=0.7)
    router.record_dispatch(hits=0, seconds=0.7)
    assert router.device_usable()


def test_scheduler_window_widens_with_the_ragged_device_path(monkeypatch):
    from mythril_tpu_torch.service import scheduler as sched_mod

    monkeypatch.setattr(port_args, "solver_backend", "gpu")
    assert (sched_mod.CoalescingScheduler().max_batch
            == sched_mod.DEFAULT_COALESCE_MAX_RAGGED == 64)
    monkeypatch.setattr(port_args, "solver_backend", "cpu")
    assert (sched_mod.CoalescingScheduler().max_batch
            == sched_mod.DEFAULT_COALESCE_MAX)
    monkeypatch.setattr(port_args, "solver_backend", "gpu")
    monkeypatch.setenv("MYTHRIL_GPU_COALESCE_MAX", "5")
    assert sched_mod.CoalescingScheduler().max_batch == 5


# -- against the JAX package's router -----------------------------------------


def _prepared(frontend, smt, workload):
    """(problems, fork pairs) of the workload, prepared with pre-analysis
    on into a fresh global blaster (fork sides under deferred forcing, as
    get_models_batch prepares them)."""
    if workload == "fork":
        sets, pairs = fork_window(smt, 3, seed=11)
    else:
        sets, pairs = sibling_window(smt, 12, seed=3), None
    if smt is ref_smt:
        from mythril_tpu.preanalysis import aig_opt
    else:
        from mythril_tpu_torch.preanalysis import aig_opt
    problems = []
    for constraints in sets:
        solver = frontend.Solver(timeout=20)
        solver.add(constraints)
        scope = aig_opt.deferred_forcing() if pairs else _null()
        with scope:
            prep = solver._prepare([])
        if prep.trivial is None:
            problems.append((prep.num_vars, prep.clauses, prep.aig_roots))
        else:
            problems.append((0, prep.clauses, None))
    return problems, pairs


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _unit_key(unit):
    component = (tuple(unit.component.roots)
                 if unit.component is not None else None)
    return (unit.qi, component, tuple(unit.extra), unit.pc.num_levels,
            unit.pc.v1)


ADMISSION_COUNTERS = ("router_host_direct", "cap_rejects",
                      "device_dispatches", "device_dispatched_queries",
                      "device_slots", "aig_device_components",
                      "fork_pair_pack_attempts", "fork_pair_pack_hits",
                      "fork_stream_dispatches", "router_dispatched_clauses")


@pytest.mark.parametrize("workload, rate, min_streams", [
    ("sibling", 1e13, 1), ("sibling", 3e7, 3), ("fork", 1e13, 1)])
def test_admission_and_chunks_equal_the_reference_router(
        monkeypatch, fresh_state, workload, rate, min_streams):
    from mythril_tpu.tpu import pallas_kernel

    monkeypatch.setenv("MYTHRIL_TPU_KERNEL", "pallas")
    pallas_kernel.reset_kernel_mode()
    for prefix in ("MYTHRIL_TPU_", "MYTHRIL_GPU_"):
        monkeypatch.setenv(prefix + "RAGGED_WINDOW_CAP", "100")
    # the kernel's variable space at the JAX package's MAX_VARS
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", str(1 << 18))
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    ref_model.clear_caches()
    ref_router_mod.reset_router()
    ref_stats = RefStatistics()
    ref_stats.reset()
    ref_stats.enabled = True
    try:
        ref_problems, pairs = _prepared(ref_frontend, ref_smt, workload)
        problems, port_pairs = _prepared(port_frontend, port_smt, workload)
        assert pairs == port_pairs

        ref_router = ref_router_mod.get_router()
        ref_router._stage_rates["pallas_cells_s"] = rate
        ref_streams = []

        def ref_record(group, remaining, profile):
            ref_streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(ref_router, "_guarded_ragged_dispatch",
                            ref_record)
        ref_router.dispatch(ref_problems, 20.0, ref_stats, fork_pairs=pairs)

        router = router_mod.get_router("cpu")
        router._rates["kernel_cells_s"] = rate
        streams = []

        def record(group, remaining, profile):
            streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(router, "_ragged_dispatch", record)
        router.dispatch(problems, 20.0, fresh_state, fork_pairs=pairs)

        assert streams == ref_streams
        assert len(streams) >= min_streams
        port_counts = fresh_state.as_dict()
        ref_counts = ref_stats.as_dict()
        for key in ADMISSION_COUNTERS:
            assert port_counts.get(key, 0) == ref_counts.get(key, 0), key
        if workload == "fork":
            assert port_counts["fork_pair_pack_hits"] == len(pairs)
    finally:
        ref_stats.reset()
        ref_model.clear_caches()
        ref_router_mod.reset_router()
        pallas_kernel.reset_kernel_mode()


# -- the real backend on device "cpu" -----------------------------------------


@pytest.fixture
def gpu_solver(monkeypatch):
    """The port's gpu backend on device "cpu", small enough to be quick."""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "16384")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "32")
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    port_args.solver_backend = "gpu"
    port_args.torch_device = "cpu"


def _host_verdicts(queries):
    port_args.solver_backend = "cpu"
    try:
        return [s for s, _m in port_model.get_models_batch(queries)]
    finally:
        port_args.solver_backend = "gpu"


def test_fork_pairs_pack_one_shared_cone(gpu_solver, fresh_state):
    """Each JUMPI fork's two sides ride one shared cone with the fork
    literal pinned as an extra root, on one stream."""
    from mythril_tpu_torch.service.scheduler import get_scheduler

    sets, pairs = fork_window(port_smt, 2, seed=7)
    stream_pins = []
    backend = port_backend.get_device_backend("cpu")
    backend.on_stream = lambda stream, entries: stream_pins.append(
        [len(extra) for _pc, extra in entries])
    results = get_scheduler().solve_fork_batch(sets, pairs)
    counters = fresh_state.as_dict()
    assert counters["fork_pair_pack_attempts"] == 2
    assert counters["fork_pair_pack_hits"] == 2
    assert counters["fork_stream_dispatches"] > 0
    assert stream_pins and all(pins and min(pins) >= 1
                               for pins in stream_pins)
    port_model.clear_caches()
    assert [s for s, _m in results] == _host_verdicts(sets)
    for (status, model), constraints in zip(results, sets):
        if status == "sat":
            assert model.satisfies(constraints)


def test_components_dispatch_and_recompose(gpu_solver, fresh_state):
    """A query that splits into variable-disjoint components rides the
    device component by component; its merged model satisfies the query."""
    queries = sibling_window(port_smt, 3, seed=4)
    results = port_model.get_models_batch(queries)
    counters = fresh_state.as_dict()
    assert counters["aig_components"] > len(queries)
    assert counters["aig_device_components"] > 0
    assert 0 < counters["aig_device_component_hits"] \
        <= counters["aig_device_components"]
    assert counters["device_batch_hits"] > 0
    assert counters["router_device_found"] > 0
    assert (counters["router_device_found"] + counters["router_host_settled"]
            + counters["router_trivial_settled"]
            == counters["device_batch_hits"])
    for (status, model), constraints in zip(results, queries):
        if status == "sat":
            assert model.satisfies(constraints)


def test_host_settled_components_are_not_counted_as_device_finds(
        gpu_solver, fresh_state, monkeypatch):
    """With every component too shallow for the device, the router still
    returns merged models, settled on the host inside it: they count as
    host-settled, not as K1's finds, and no component rides a stream."""
    monkeypatch.setenv("MYTHRIL_GPU_HOST_DIRECT_LEVELS", "100000")
    launches = []
    real = ragged_kernel.run_round_ragged_kernel
    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel",
                        lambda *a, **k: launches.append(1) or real(*a, **k))
    queries = sibling_window(port_smt, 3, seed=4)
    results = port_model.get_models_batch(queries)
    counters = fresh_state.as_dict()
    assert counters["aig_host_components"] > 0
    assert counters["aig_device_components"] == 0
    assert counters["aig_device_component_hits"] == 0
    assert counters["router_device_found"] == 0
    assert counters["router_host_settled"] > 0
    assert (counters["router_host_settled"]
            + counters["router_trivial_settled"]
            == counters["device_batch_hits"])
    assert launches == []
    assert [s for s, _m in results] == _host_verdicts(queries)


def test_recomposed_model_must_pass_the_whole_query(gpu_solver, fresh_state,
                                                    monkeypatch):
    """A recomposed assignment that fails the full-query clause check is
    not returned: the caller's CDCL settles the query."""
    class Rejecting(DeviceSolverBackend):
        @staticmethod
        def _honors(bits, clauses):
            return False

    # the router's recomposition check alone fails; the backend's own
    # check of each component's model is untouched
    monkeypatch.setattr(router_mod, "DeviceSolverBackend", Rejecting)
    queries = sibling_window(port_smt, 2, seed=4)
    results = port_model.get_models_batch(queries)
    counters = fresh_state.as_dict()
    assert counters["aig_device_components"] > 0
    assert counters.get("device_batch_hits", 0) == 0
    assert counters["cdcl_settles"] >= 2
    assert [s for s, _m in results] == ["sat", "sat"]


def test_kernel_error_reaches_the_caller(gpu_solver, monkeypatch):
    """No fallback: an exception from the round propagates out of the
    router and get_models_batch."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_model.get_models_batch(sibling_window(port_smt, 2, seed=4))


class _Clock:
    """perf_counter stand-in: each call advances by `step` seconds."""

    def __init__(self, step):
        self.now = 0.0
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


def test_calibration_times_the_round_against_a_stubbed_timer(
        gpu_solver, monkeypatch, tmp_path):
    """kernel_cells_s is CAL_STEPS x 2 x the stream's padded cells over the
    timed launch (perf_counter on the CPU), after one warm-up launch; the
    measurement persists only under solve_cache "disk"."""
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    flats = []
    real = ragged_kernel.run_round_ragged_kernel

    def recorded(flat, *args, **kwargs):
        flats.append(flat)
        return real(flat, *args, **kwargs)

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel", recorded)
    monkeypatch.setattr(router_mod, "time", SimpleNamespace(
        perf_counter=_Clock(0.5), monotonic=time.monotonic))
    router = router_mod.get_router("cpu")
    router._calibrate()
    rates = router.attainable_rates()
    assert len(flats) == 2, "one warm-up launch, one timed launch"
    cells = flats[0].padded_cells
    assert rates["kernel_cells_s"] == pytest.approx(
        router_mod.CAL_STEPS * 2 * cells / 0.5)
    assert {"pack_bytes_s", "ragged_bytes_s",
            "settle_clauses_s"} <= set(rates)
    assert not (tmp_path / "calibration.json").exists()

    port_args.solve_cache = "disk"
    router_mod.reset_router()
    router_mod.get_router("cpu")._calibrate()
    assert (tmp_path / "calibration.json").exists()
    router_mod.reset_router()
    flats.clear()
    router = router_mod.get_router("cpu")
    router._calibrate()
    assert flats == [], "a persisted entry skips the measurement"
    assert router.attainable_rates()["kernel_cells_s"] > 0
