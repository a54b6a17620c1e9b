"""`analyze` with fork pruning on, where the engine's windows reach the
router: bench_inputs/corpus/xc_dispatch_a.hex at -t 1 (the host backend's
report byte-identical to the JAX package's, and the batched frontier's
counters equal, both packages with their frontier on)
and KILLBILLY at -t 2, with the device backend's findings equal at issue
granularity and models from the router. The other corpus contracts and
stress_dispatch run in chip_smoke.py's analyze phase."""

import os

import pytest

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_analysis import ETHER_LEAK, KILLBILLY, wrap_creation
from tests.test_torch_analyze import EXECUTION_TIMEOUT as FAMILY_TIMEOUT
from tests.test_torch_analyze import counted_run
from tests.torch_helpers import issue_keys, run_analyze

CONTRACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_inputs", "corpus", "xc_dispatch_a.hex")
EXECUTION_TIMEOUT = 600  # s, never reached: the exploration completes


@pytest.fixture(autouse=True)
def counted(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    yield stats
    stats.reset()


_HOST_RUNS = {}


def _contract_code():
    with open(CONTRACT) as handle:
        return handle.read().strip()


def _host_runs():
    """(reference, port) host-backend runs of the contract, each (report,
    frontier counters), run once per process."""
    if not _HOST_RUNS:
        code = _contract_code()
        for package in ("mythril_tpu", "mythril_tpu_torch"):
            _HOST_RUNS[package] = counted_run(
                package, code, 1, "cpu", EXECUTION_TIMEOUT, pruning_factor=1)
    return _HOST_RUNS["mythril_tpu"], _HOST_RUNS["mythril_tpu_torch"]


def test_corpus_frontier_counters_equal_the_reference():
    (_reference, ref_counters), (_host, counters) = _host_runs()
    assert counters == ref_counters
    assert counters["frontier_vmap_steps"] > 0
    assert counters["frontier_forks"] > 0


def test_corpus_contract_host_parity_and_device_findings(counted):
    code = _contract_code()
    (reference, _c), (host, _counters) = _host_runs()
    assert host.as_json() == reference.as_json()
    assert {issue.swc_id for issue in host.issues.values()} == {"101"}
    counted.reset()
    device = run_analyze("mythril_tpu_torch", code, 1, "gpu",
                         EXECUTION_TIMEOUT, device="cpu", pruning_factor=1)
    assert issue_keys(device) == issue_keys(host)
    assert counted.device_batch_hits > 0


def test_device_backend_finds_models(counted):
    """With fork pruning on and a second transaction, the engine's fork and
    reachability windows reach the router, and K1's round (with the
    router's in-router settles) returns host-verified models."""
    code = wrap_creation(KILLBILLY)
    reference = run_analyze("mythril_tpu", code, 2, "cpu",
                            FAMILY_TIMEOUT, pruning_factor=1)
    counted.reset()
    device = run_analyze("mythril_tpu_torch", code, 2, "gpu",
                         FAMILY_TIMEOUT, device="cpu", pruning_factor=1)
    assert issue_keys(device) == issue_keys(reference)
    assert counted.kernel_launches > 0
    assert counted.device_batch_hits > 0


@pytest.mark.parametrize("where", ["first_round", "detection"])
def test_device_fault_stops_the_analysis(counted, monkeypatch, where):
    """K1 failing partway through an analysis stops it with a DeviceFault:
    no report comes back, the failed round is the last one, and no query
    is settled on the host CDCL after it. K1 fails on its first round
    (KILLBILLY at -t 2, the engine's reachability and fork windows), or on
    its first round inside a detection module's solve (ETHER_LEAK at -t 2,
    whose ether-thief candidates reach K1): nothing there confirms around
    the fault.

    On the CPU the router stops launching after MYTHRIL_GPU_RAGGED_WINDOW_CAP
    streams a process, cuts a window at its dispatch deadline and opens its
    breaker after MYTHRIL_GPU_DEVICE_MAX_WASTE zero-hit seconds; and before
    the router, get_model's host CDCL probe (a 20,000-conflict budget cut
    at 0.5 s) settles whatever it solves in time. ETHER_LEAK's ether-thief
    candidate takes that probe 0.6-1.0 s, so the probe's clock alone
    decided whether it reached K1. All four are lifted here (the probe by
    sat_backend.PROBE_CONFLICTS = 0), so no count of earlier streams and no
    host clock keeps the detection window off K1. The test then checks
    first that a window reached the router inside a detection context, and
    only then the fault."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu import router as router_mod
    from mythril_tpu_torch.gpu.device import DeviceFault
    from mythril_tpu_torch.smt.solver import sat_backend
    from mythril_tpu_torch.support import model

    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "1000")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "600")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_MAX_WASTE", "600")
    monkeypatch.setattr(sat_backend, "PROBE_CONFLICTS", 0)
    settles_at_fault = []
    dispatched = []  # the detection flag of every window the router takes
    plain_round = ragged_kernel.run_round_ragged_plain
    dispatch = router_mod.QueryRouter.dispatch

    def broken_round(*args, **kwargs):
        if where == "detection" and not model._in_detection_context:
            return plain_round(*args, **kwargs)
        settles_at_fault.append(counted.cdcl_settles)
        raise RuntimeError("injected K1 failure")

    def watched_dispatch(self, *args, **kwargs):
        dispatched.append(model._in_detection_context)
        return dispatch(self, *args, **kwargs)

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_plain", broken_round)
    monkeypatch.setattr(router_mod.QueryRouter, "dispatch", watched_dispatch)
    runtime = KILLBILLY if where == "first_round" else ETHER_LEAK
    counted.reset()
    fault = None
    try:
        run_analyze("mythril_tpu_torch", wrap_creation(runtime), 2, "gpu",
                    FAMILY_TIMEOUT, device="cpu", pruning_factor=1)
    except DeviceFault as error:
        fault = error
    if where == "detection":
        assert True in dispatched, (
            f"no window reached the router inside a detection context "
            f"(detection flags of the windows it took: {dispatched})")
    assert fault is not None, "the analysis ended without a DeviceFault"
    assert "injected K1 failure" in str(fault.__cause__)
    assert len(settles_at_fault) == 1
    assert counted.cdcl_settles == settles_at_fault[0]
