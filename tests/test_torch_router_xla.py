"""The xla kernel mode (MYTHRIL_GPU_KERNEL=xla) and the pallas mode's
fallback to K2, in the router (mythril_tpu_torch/gpu/router.py) and the
backend (gpu/backend.py).

- The counterparts of tests/test_router.py's three mode tests (its
  `kernel_mode` fixture): the per-cone cost veto in xla mode only, the
  mixed-origin cone cap in xla mode only, and the cost model and roofline
  charging the live kernel's rate.
- Against the JAX package's router under MYTHRIL_TPU_KERNEL=xla: the same
  windows prepared with pre-analysis on in both packages (the sibling and
  fork windows, and a window of two origins), the same rate injected into
  both routers (K2's xla_cells_s; the reference's XLA per-cell latency),
  and a recording stub in place of each one's stream dispatch: the
  admission counters and the streams must be equal.
- The real backend on device "cpu": in pallas mode a cone past K1's
  variable space rides K2 in a stream of its own while the rest stays on
  K1, and nothing is a cap reject; a window past a capacity falls back to
  K2 instead of raising, the cube pass and the fork pins with it; K2's
  calibration; and `analyze` in xla mode, whose findings equal the
  reference's at issue granularity.

Every change of the knob goes through the `kernel_mode` fixture, which
drops both packages' cached resolutions (ragged_kernel.reset_kernel_mode,
pallas_kernel.reset_kernel_mode) when it is set and after the test.
"""

import time
from types import SimpleNamespace

import pytest

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu.smt.solver.statistics import (
    SolverStatistics as RefStatistics,
)
from mythril_tpu.support import model as ref_model
from mythril_tpu.tpu import pallas_kernel
from mythril_tpu.tpu import router as ref_router_mod
from mythril_tpu_torch.gpu import backend as port_backend
from mythril_tpu_torch.gpu import ragged_kernel, xla_kernel
from mythril_tpu_torch.gpu import router as router_mod
from mythril_tpu_torch.gpu.backend import DeviceSolverBackend, shape_bucket
from mythril_tpu_torch.gpu.router import QueryRouter
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import sibling_window
from tests.test_analysis import KILLBILLY, wrap_creation
from tests.test_pallas_kernel import _build_entries
from tests.test_torch_backend import _problem
from tests.test_torch_router import (
    ADMISSION_COUNTERS,
    FakeBackend,
    FakePC,
    _Clock,
    _host_verdicts,
    _prepared,
    _unit_key,
    fresh_state,  # noqa: F401 (autouse fixture)
    gpu_solver,  # noqa: F401 (fixture)
    problem,
)
from tests.torch_helpers import issue_keys, run_analyze


@pytest.fixture
def kernel_mode(monkeypatch):
    """Force MYTHRIL_GPU_KERNEL and MYTHRIL_TPU_KERNEL for a test, and drop
    both packages' cached resolutions when set and afterwards."""

    def set_mode(mode):
        monkeypatch.setenv("MYTHRIL_GPU_KERNEL", mode)
        monkeypatch.setenv("MYTHRIL_TPU_KERNEL", mode)
        ragged_kernel.reset_kernel_mode()
        pallas_kernel.reset_kernel_mode()

    yield set_mode
    monkeypatch.delenv("MYTHRIL_GPU_KERNEL", raising=False)
    monkeypatch.delenv("MYTHRIL_TPU_KERNEL", raising=False)
    ragged_kernel.reset_kernel_mode()
    pallas_kernel.reset_kernel_mode()


# -- the reference's three mode tests -----------------------------------------


def test_cost_veto_applies_in_xla_mode_only(monkeypatch, kernel_mode):
    """A cone whose one round over it alone costs twice the chunk budget
    is a cost reject in xla mode and admitted in pallas mode; "tiny" and
    the stream's byte budget hold in both."""
    deep = FakePC(700, width=1024)
    cells = QueryRouter(FakeBackend()).ragged_round_cells(deep)
    assert cells == shape_bucket(700) * shape_bucket(1024)
    for mode, verdict in (("xla", "cost"), ("pallas", "device")):
        kernel_mode(mode)
        router = QueryRouter(FakeBackend())
        rate = (router._profile_steps() * 2 * cells
                / (2.0 * router.ragged_chunk_budget_s()))
        router._rates.update(kernel_cells_s=rate, xla_cells_s=rate)
        assert router._admission_ragged(deep) == verdict, mode
        assert (router._admission_ragged(FakePC(router.host_direct_levels))
                == "tiny")
    # the floor: a cone inside 640 levels and 2^20 cells is never vetoed
    kernel_mode("xla")
    router = QueryRouter(FakeBackend())
    router._rates["xla_cells_s"] = 1.0
    assert router._admission_ragged(FakePC(600, width=1024)) == "device"
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_STREAM_BYTES", str(
        DeviceSolverBackend.ragged_entry_bytes(deep) - 1))
    assert QueryRouter(FakeBackend())._admission_ragged(deep) == "cap"


def test_mixed_origin_cone_cap_applies_in_xla_mode_only(monkeypatch,
                                                        kernel_mode):
    """On device "cpu" the xla mode caps the chunks of a window of two
    origins at MIXED_CHUNK_CONES_CPU (2) cones, and neither a
    single-origin window nor the pallas mode; K1's cone slots chunk only
    the pallas mode."""
    pcs = [FakePC(300) for _ in range(6)]

    def window(two_origins):
        return [router_mod._Unit(i, None, pc, problem(pc),
                                 origin=("even" if i % 2 == 0 else "odd")
                                 if two_origins else "one")
                for i, pc in enumerate(pcs)]

    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_CONE_CAP", "4")
    caps = ragged_kernel.kernel_caps()
    kernel_mode("xla")
    router = QueryRouter(FakeBackend())
    assert [len(c) for c in router._chunk_ragged(window(True), caps)] \
        == [2, 2, 2]
    assert [len(c) for c in router._chunk_ragged(window(False), caps)] \
        == [6]
    monkeypatch.setattr(router_mod, "MIXED_CHUNK_CONES_CPU", 3)
    assert [len(c) for c in router._chunk_ragged(window(True), caps)] \
        == [3, 3]
    kernel_mode("pallas")
    assert [len(c) for c in router._chunk_ragged(window(True), caps)] \
        == [4, 2]


def test_cost_model_and_roofline_charge_the_live_kernel_rate(kernel_mode):
    """est_ragged_round_seconds and the roofline's kernel ceiling read K1's
    rate in pallas mode and K2's in xla mode; with neither measured the
    estimate charges mythril_tpu's constant."""
    for mode, rate in (("pallas", 4e7), ("xla", 2e6)):
        kernel_mode(mode)
        router = QueryRouter(FakeBackend())
        steps2 = router._profile_steps() * 2
        assert router.est_ragged_round_seconds(1000) == pytest.approx(
            1e-7 * steps2 * 1000)
        router._rates.update(kernel_cells_s=4e7, xla_cells_s=2e6)
        assert router.est_ragged_round_seconds(1000) == pytest.approx(
            steps2 * 1000 / rate)
        assert router.attainable_rates() == {"kernel_cells_s": rate}


# -- against the JAX package's router -----------------------------------------


@pytest.mark.parametrize("workload, rate, min_streams", [
    ("sibling", 1e13, 1), ("sibling", 1e6, 2), ("fork", 1e13, 1),
    ("two-origin", 1e13, 4)])
def test_xla_streams_and_counters_equal_the_reference_router(
        monkeypatch, fresh_state, kernel_mode, workload, rate, min_streams):
    kernel_mode("xla")
    for prefix in ("MYTHRIL_TPU_", "MYTHRIL_GPU_"):
        monkeypatch.setenv(prefix + "RAGGED_WINDOW_CAP", "100")
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    ref_model.clear_caches()
    ref_router_mod.reset_router()
    ref_stats = RefStatistics()
    ref_stats.reset()
    ref_stats.enabled = True
    source = "fork" if workload == "fork" else "sibling"
    try:
        ref_problems, pairs = _prepared(ref_frontend, ref_smt, source)
        problems, port_pairs = _prepared(port_frontend, port_smt, source)
        assert pairs == port_pairs
        origins = None
        if workload == "two-origin":
            origins = ["a" if i < len(problems) // 2 else "b"
                       for i in range(len(problems))]

        ref_router = ref_router_mod.get_router()
        ref_router._per_cell_s = 1.0 / rate
        ref_streams = []

        def ref_record(group, remaining, profile):
            ref_streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(ref_router, "_guarded_ragged_dispatch",
                            ref_record)
        ref_router.dispatch(ref_problems, 20.0, ref_stats, fork_pairs=pairs,
                            origins=origins)

        router = router_mod.get_router("cpu")
        router._rates["xla_cells_s"] = rate
        streams = []

        def record(group, remaining, profile):
            streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(router, "_ragged_dispatch", record)
        router.dispatch(problems, 20.0, fresh_state, fork_pairs=pairs,
                        origins=origins)

        assert streams == ref_streams
        assert len(streams) >= min_streams
        port_counts = fresh_state.as_dict()
        ref_counts = ref_stats.as_dict()
        for key in ADMISSION_COUNTERS:
            assert port_counts.get(key, 0) == ref_counts.get(key, 0), key
        if workload == "two-origin":
            assert max(len(stream) for stream in streams) == 2
    finally:
        ref_stats.reset()
        ref_model.clear_caches()
        ref_router_mod.reset_router()


# -- the real backend on device "cpu" -----------------------------------------


def _count_launches(monkeypatch):
    """{"K1": [...], "K2": [...]}: the number of cones of each launch's
    stream, recorded at the two wrappers."""
    launches = {"K1": [], "K2": []}
    real_k1 = ragged_kernel.run_round_ragged_kernel
    real_k2 = xla_kernel.run_round_xla_kernel

    def k1(flat, *a, **k):
        launches["K1"].append(flat.num_cones)
        return real_k1(flat, *a, **k)

    def k2(xs, *a, **k):
        launches["K2"].append(xs.num_cones)
        return real_k2(xs, *a, **k)

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel", k1)
    monkeypatch.setattr(xla_kernel, "run_round_xla_kernel", k2)
    return launches


def test_a_cone_past_k1_rides_k2_alone_and_is_no_cap_reject(
        gpu_solver, fresh_state, monkeypatch, kernel_mode):
    """In pallas mode the sibling window's cones past a small var capacity
    each ride K2 in a stream of their own; the rest stay on K1. No cap
    reject is counted, and the verdicts equal the host CDCL's."""
    kernel_mode("pallas")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "100")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "60")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "1500")
    streams = []
    backend = port_backend.get_device_backend("cpu")
    backend.on_stream = lambda stream, entries: streams.append(
        (stream.v1, [pc.v1 for pc, _extra in entries]))
    launches = _count_launches(monkeypatch)
    queries = sibling_window(port_smt, 6, seed=4)
    results = port_model.get_models_batch(queries)
    counters = fresh_state.as_dict()
    assert counters["cap_rejects"] == 0
    assert launches["K1"] and launches["K2"]
    assert set(launches["K2"]) == {1}, "K2 carries each big cone alone"
    big = [sizes for v1, sizes in streams if v1 == shape_bucket(v1)
           and max(sizes) > 1500]
    assert big and all(len(sizes) == 1 for sizes in big)
    assert [s for s, _m in results] == _host_verdicts(queries)
    for (status, model), constraints in zip(results, queries):
        if status == "sat":
            assert model.satisfies(constraints)


def test_a_window_past_k1_falls_back_to_k2_with_its_pins_and_cubes(
        monkeypatch, kernel_mode):
    """A window past K1's root capacity (its cones' roots plus pinned
    extra roots) runs on K2 instead of raising, pins honoured. In xla mode
    the cube pass after a forced miss runs on K2 too, with mythril_tpu's
    replica sizing (no root capacity: the pallas mode sizes cube streams
    to fit K1), and a cube's model settles the cone."""
    entries = [e for e in _build_entries() if e[5] and e[4]][:3]
    cache = {}
    prepared = [_problem(entry, cache) for entry in entries]
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_ROOT_CAP", "1")
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    launches = _count_launches(monkeypatch)
    problems = [p for p, _pc, _e in prepared]
    results = backend.try_solve_batch_ragged(
        problems, budget_seconds=60.0,
        packed_hint=[pc for _p, pc, _e in prepared],
        extra_roots=[extra for _p, _pc, extra in prepared])
    assert launches["K1"] == [] and launches["K2"]
    for bits, (problem_, pc, extra) in zip(results, prepared):
        assert bits is not None and backend._honors(bits, problem_[1])

    entry = next(e for e in _build_entries() if e[5] and not e[4]
                 and e[0].num_levels >= 2)
    problem_, pc, _extra = _problem(entry, cache)
    real_solve = backend._solve_ragged_stream
    calls = []

    def miss_first(entries, deadline, num_restarts, steps, **kwargs):
        calls.append(len(entries))
        if len(calls) == 1:
            return {}, 0, True  # the plain pass: a forced miss
        return real_solve(entries, deadline, num_restarts, steps, **kwargs)

    monkeypatch.setattr(backend, "_solve_ragged_stream", miss_first)
    kernel_mode("xla")
    launches["K2"].clear()
    results = backend.try_solve_batch_ragged(
        [problem_], budget_seconds=60.0, steps=96, packed_hint=[pc],
        cube_vars=2, cube_min_levels=0)
    assert calls[:2] == [1, 4], "2^2 cube replicas ride the second stream"
    assert launches["K2"] and set(launches["K2"]) == {4}
    assert results[0] is not None and backend._honors(results[0],
                                                      problem_[1])


def test_k2_calibration_times_its_round_in_xla_mode_only(
        gpu_solver, monkeypatch, tmp_path, kernel_mode):
    """In xla mode the calibration times K2 (never K1) on the two-cone
    calibration stream padded to its shape bucket: xla_cells_s is
    CAL_STEPS x 2 x the bucketed levels x width over the timed launch,
    and it persists beside K1's rate under its own key."""
    kernel_mode("xla")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    launches = _count_launches(monkeypatch)
    streams = []
    real_upload = xla_kernel.device_stream

    def upload(stream, device):
        streams.append(stream)
        return real_upload(stream, device)

    monkeypatch.setattr(xla_kernel, "device_stream", upload)
    monkeypatch.setattr(router_mod, "time", SimpleNamespace(
        perf_counter=_Clock(0.5), monotonic=time.monotonic))
    port_args.solve_cache = "disk"
    router = router_mod.get_router("cpu")
    router._calibrate()
    assert launches == {"K1": [], "K2": [2, 2]}
    stream = streams[0]
    assert stream.num_cones == 2 and stream.v1 == shape_bucket(stream.v1)
    rates = router.attainable_rates()
    assert rates["kernel_cells_s"] == pytest.approx(
        router_mod.CAL_STEPS * 2 * stream.num_levels * stream.width / 0.5)
    assert "xla_cells_s" not in rates
    assert router._rates["xla_cells_s"] == rates["kernel_cells_s"]
    # the pallas mode measures K1 in the same process; a persisted entry
    # then holds both rates and skips both measurements
    kernel_mode("pallas")
    router._calibrate()
    assert launches["K1"] == [2, 2]
    router_mod.reset_router()
    for mode in ("xla", "pallas"):
        kernel_mode(mode)
        launches["K1"].clear()
        launches["K2"].clear()
        router_mod.get_router("cpu")._calibrate()
        assert launches == {"K1": [], "K2": []}, mode


def test_analyze_in_xla_mode_finds_what_the_reference_finds(
        monkeypatch, fresh_state, kernel_mode):
    """KILLBILLY at -t 2 with fork pruning on: the port in xla mode on
    device "cpu" against the JAX package under MYTHRIL_TPU_KERNEL=xla,
    findings at issue granularity. K2 solved components; K1 never ran."""
    kernel_mode("xla")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "100")
    launches = _count_launches(monkeypatch)
    code = wrap_creation(KILLBILLY)
    reference = run_analyze("mythril_tpu", code, 2, "tpu", 60,
                            pruning_factor=1)
    port = run_analyze("mythril_tpu_torch", code, 2, "gpu", 60,
                       device="cpu", pruning_factor=1)
    assert issue_keys(port) == issue_keys(reference)
    counters = fresh_state.as_dict()
    assert launches["K2"] and launches["K1"] == []
    assert counters["aig_device_component_hits"] > 0
    assert counters["kernel_backend"] == "xla"
    assert counters["kernel_launches"] == 0
