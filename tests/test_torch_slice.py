"""The slice end to end: get_models_batch on a window of 256-bit sibling
queries in both packages.

Reference: mythril_tpu with solver_backend="tpu", with pre-analysis off
(`backends`) and at its defaults, pre-analysis on (`defaults`). Port:
mythril_tpu_torch with solver_backend="gpu" on device "cpu" (the plain
round), set the same way. Verdicts must be equal query by query and every
SAT model must satisfy its constraints; models may differ (the two draw
different random numbers). The port's device must have found models. The
coalescing scheduler must answer as get_models_batch does, and a repeated
window must come from the memory tier without a launch.
"""

import pytest

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.support import model as ref_model
from mythril_tpu.support.args import args as ref_args
from mythril_tpu_torch.gpu import backend as port_backend
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import sibling_window


@pytest.fixture
def backends(monkeypatch):
    from mythril_tpu.tpu import router as ref_router

    monkeypatch.setenv("MYTHRIL_TPU_PREANALYSIS", "0")
    monkeypatch.setenv("MYTHRIL_GPU_PREANALYSIS", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    # small kernel capacities and restarts: the plain round runs on the CPU
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "16384")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "32")
    monkeypatch.setattr(port_backend, "_backends", {})
    ref_model.clear_caches()
    ref_router.reset_router()
    ref_args.solver_backend = "tpu"
    port_args.solver_backend = "gpu"
    port_args.torch_device = "cpu"
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    ref_model.clear_caches()
    ref_router.reset_router()
    ref_args.solver_backend = "cpu"
    port_args.reset()


def test_verdicts_equal_reference_query_by_query(backends):
    ref_results = ref_model.get_models_batch(
        sibling_window(ref_smt, 12, seed=3))
    queries = sibling_window(port_smt, 12, seed=3)
    results = port_model.get_models_batch(queries)
    assert [s for s, _m in results] == [s for s, _m in ref_results]
    assert {s for s, _m in results} == {"sat", "unsat"}
    for (status, model), constraints in zip(results, queries):
        if status == "sat":
            assert model.satisfies(constraints)
    counters = backends.as_dict()
    assert counters["device_batch_queries"] == 12
    assert counters["device_batch_hits"] > 0
    assert counters["kernel_launches"] > 0
    # the device never proves UNSAT: every miss was settled by the CDCL
    assert counters["cdcl_settles"] == 12 - counters["device_batch_hits"]


def test_cone_over_a_capacity_is_settled_by_the_cdcl(backends, monkeypatch):
    """Cones past K1's variable capacity are no cap rejects: each rides
    K2 in a stream of its own (K1 never launches), and the verdicts equal
    the host CDCL's, which still settles the UNSAT one. (The name dates
    from before K2, when the CDCL settled them all; it is kept so that the
    test's history reads on.)"""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "1024")
    queries = sibling_window(port_smt, 4, seed=4)
    results = port_model.get_models_batch(queries)
    host = _host_verdicts(queries)
    assert [s for s, _m in results] == host
    counters = backends.as_dict()
    assert counters["cap_rejects"] == 0
    assert counters["device_batch_hits"] > 0
    assert counters["kernel_launches"] == 0


def test_no_device_named_and_no_cuda_raises(backends, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_args.torch_device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.get_models_batch(sibling_window(port_smt, 2, seed=5))


@pytest.fixture
def defaults(monkeypatch):
    """Both packages at their defaults (pre-analysis on); the port skips
    calibration and runs small kernel capacities."""
    from mythril_tpu.tpu import router as ref_router

    for name in ("MYTHRIL_TPU_PREANALYSIS", "MYTHRIL_GPU_PREANALYSIS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "16384")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "32")
    monkeypatch.setattr(port_backend, "_backends", {})
    ref_model.clear_caches()
    ref_router.reset_router()
    port_model.clear_caches()
    ref_args.solver_backend = "tpu"
    port_args.solver_backend = "gpu"
    port_args.torch_device = "cpu"
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    ref_model.clear_caches()
    ref_router.reset_router()
    port_model.clear_caches()
    ref_args.solver_backend = "cpu"
    port_args.reset()


def test_verdicts_equal_reference_with_preanalysis_on(defaults):
    ref_results = ref_model.get_models_batch(
        sibling_window(ref_smt, 8, seed=3))
    queries = sibling_window(port_smt, 8, seed=3)
    results = port_model.get_models_batch(queries)
    assert [s for s, _m in results] == [s for s, _m in ref_results]
    assert {s for s, _m in results} == {"sat", "unsat"}
    for (status, model), constraints in zip(results, queries):
        if status == "sat":
            assert model.satisfies(constraints)
    counters = defaults.as_dict()
    assert counters["device_batch_hits"] > 0
    assert counters["kernel_launches"] > 0
    assert counters["aig_device_components"] > 0
    assert counters["cnf_units_propagated"] > 0


def test_scheduler_solve_batch_equals_get_models_batch(defaults):
    from mythril_tpu_torch.service.scheduler import get_scheduler

    queries = sibling_window(port_smt, 12, seed=3)
    direct = port_model.get_models_batch(queries)
    port_model.clear_caches()
    defaults.reset()
    defaults.enabled = True
    coalesced = get_scheduler().solve_batch(queries)
    assert [s for s, _m in coalesced] == [s for s, _m in direct]
    for (status, model), constraints in zip(coalesced, queries):
        if status == "sat":
            assert model.satisfies(constraints)
    counters = defaults.as_dict()
    assert counters["window_flushes"] == 1
    assert counters["coalesced_queries"] == 12
    assert counters["device_batch_hits"] > 0


def test_repeated_window_is_served_by_the_memory_tier(defaults):
    queries = sibling_window(port_smt, 12, seed=3)
    first = port_model.get_models_batch(queries)
    answered = sum(1 for s, _m in first if s in ("sat", "unsat"))
    defaults.reset()
    defaults.enabled = True
    again = port_model.get_models_batch(queries)
    assert [s for s, _m in again] == [s for s, _m in first]
    counters = defaults.as_dict()
    assert counters["memory_hits"] == answered == len(queries)
    assert counters.get("kernel_launches", 0) == 0
    assert counters.get("device_batch_queries", 0) == 0
    # a query that a recent model satisfies: the quick-sat tier
    sat_query = next(q for (s, _m), q in zip(first, queries) if s == "sat")
    status, model = port_model.get_models_batch([sat_query[:-1]])[0]
    assert status == "sat" and model.satisfies(sat_query[:-1])
    assert defaults.as_dict()["quick_sat_hits"] == 1


def test_scheduler_without_a_device_raises(defaults, monkeypatch):
    import torch

    from mythril_tpu_torch.service.scheduler import get_scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_args.torch_device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_scheduler().solve_batch(sibling_window(port_smt, 2, seed=5))


def _host_verdicts(queries):
    backend, device = port_args.solver_backend, port_args.torch_device
    port_args.solver_backend = "cpu"
    try:
        return [s for s, _m in port_model.get_models_batch(queries)]
    finally:
        port_args.solver_backend, port_args.torch_device = backend, device
