"""`analyze` with fork pruning on, where the engine's windows reach the
router: bench_inputs/corpus/xc_dispatch_a.hex at -t 1 (the host backend's
report byte-identical to the JAX package's with its vmapped frontier off)
and KILLBILLY at -t 2, with the device backend's findings equal at issue
granularity and models from the router. The other corpus contracts and
stress_dispatch run in chip_smoke.py's analyze phase."""

import os

import pytest

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_analysis import ETHER_LEAK, KILLBILLY, wrap_creation
from tests.test_torch_analyze import EXECUTION_TIMEOUT as FAMILY_TIMEOUT
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


def test_corpus_contract_host_parity_and_device_findings(counted):
    with open(CONTRACT) as handle:
        code = handle.read().strip()
    reference = run_analyze("mythril_tpu", code, 1, "cpu",
                            EXECUTION_TIMEOUT, pruning_factor=1)
    host = run_analyze("mythril_tpu_torch", code, 1, "cpu",
                       EXECUTION_TIMEOUT, pruning_factor=1)
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
    the fault."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu.device import DeviceFault
    from mythril_tpu_torch.support import model

    settles_at_fault = []
    plain_round = ragged_kernel.run_round_ragged_plain

    def broken_round(*args, **kwargs):
        if where == "detection" and not model._in_detection_context:
            return plain_round(*args, **kwargs)
        settles_at_fault.append(counted.cdcl_settles)
        raise RuntimeError("injected K1 failure")

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_plain", broken_round)
    runtime = KILLBILLY if where == "first_round" else ETHER_LEAK
    counted.reset()
    with pytest.raises(DeviceFault) as caught:
        run_analyze("mythril_tpu_torch", wrap_creation(runtime), 2, "gpu",
                    FAMILY_TIMEOUT, device="cpu", pruning_factor=1)
    assert "injected K1 failure" in str(caught.value.__cause__)
    assert len(settles_at_fault) == 1
    assert counted.cdcl_settles == settles_at_fault[0]
