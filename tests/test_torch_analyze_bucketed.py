"""`analyze` on the bucketed path (--no-ragged): KILLBILLY at -t 2 in both
packages with their bucketed dispatch, findings equal at issue
granularity (K3's models may differ from the JAX package's, so the
witnesses may too), every device window through K3 and none through K1;
the dispatch mode's own kernel built before the first window; and the
chaos case: device.dispatch:raise:n1 with --no-ragged stops the
CLI with exit 2 and a recorded DeviceFault, as on the ragged path.

The port runs on --torch-device cpu, where K3's plain version runs behind
the seam the card takes.
"""

import pytest

from mythril_tpu_torch.gpu import circuit_kernel, ragged_kernel
from mythril_tpu_torch.resilience import deadline as deadline_mod
from mythril_tpu_torch.resilience import faults
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, wrap_creation
from tests.test_torch_chaos import _cli_fault
from tests.torch_helpers import issue_keys, run_analyze

EXECUTION_TIMEOUT = 60  # s, never reached by KILLBILLY


def _full_reset():
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support.model import clear_caches

    args.reset()
    clear_caches()
    frontend._global_blaster = None
    deadline_mod.reset()
    faults.configure(None)


@pytest.fixture(autouse=True)
def bucketed_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_TPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    monkeypatch.delenv("MYTHRIL_GPU_RAGGED", raising=False)
    stats = SolverStatistics()
    _full_reset()
    stats.reset()
    yield stats
    _full_reset()
    stats.reset()


def test_killbilly_findings_equal_the_reference(monkeypatch, bucketed_env):
    monkeypatch.setenv("MYTHRIL_TPU_RAGGED", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0")
    launches = []
    real = circuit_kernel.run_round_circuit_kernel

    def counted(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel", counted)
    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel",
                        lambda *a, **k: pytest.fail("K1 launched"))
    code = wrap_creation(KILLBILLY)
    reference = run_analyze("mythril_tpu", code, 2, "tpu", EXECUTION_TIMEOUT,
                            pruning_factor=1)
    bucketed_env.reset()
    port = run_analyze("mythril_tpu_torch", code, 2, "gpu",
                       EXECUTION_TIMEOUT, device="cpu", pruning_factor=1)
    assert issue_keys(port) == issue_keys(reference)
    assert port.issues, "KILLBILLY's findings are there"
    assert launches, "K3 ran on the device windows"
    counters = bucketed_env.as_dict()
    assert counters["device_dispatches"] > 0
    assert counters["device_batch_queries"] > 0


@pytest.mark.parametrize("mode", ["bucketed", "ragged", "xla"])
def test_kernels_build_before_the_first_guarded_dispatch(monkeypatch, mode):
    """On a card, fire_lasers builds the dispatch mode's own kernels (K3
    with --no-ragged; K2, and K1 unless the kernel mode is xla, on the
    ragged path: K2 is the pallas mode's fallback past K1's capacities)
    before the first window: with the calibration off nothing else builds
    them, and a build inside the dispatch's hard deadline could turn a
    slow nvcc into a DeviceFault. The card is stood in for: core sees a
    CUDA device, the builds are recorded, and the windows run on the
    CPU."""
    import torch

    from mythril_tpu_torch import core
    from mythril_tpu_torch.gpu import frontier_kernel, xla_kernel
    from mythril_tpu_torch.gpu.router import QueryRouter

    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0" if mode == "bucketed"
                       else "1")
    monkeypatch.setenv("MYTHRIL_GPU_KERNEL",
                       "xla" if mode == "xla" else "pallas")
    # a fresh resolution of the knob, dropped again after the test
    monkeypatch.setattr(ragged_kernel, "_MODE", None)
    events = []
    monkeypatch.setattr(core, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    for name, module in (("K1", ragged_kernel), ("K2", xla_kernel),
                         ("K3", circuit_kernel), ("K6", frontier_kernel)):
        monkeypatch.setattr(module, "build_kernel",
                            lambda name=name: events.append("build " + name))
    for method in ("_guarded_dispatch", "_ragged_dispatch"):
        real = getattr(QueryRouter, method)

        def recorded(self, *a, real=real, **k):
            events.append("dispatch")
            return real(self, *a, **k)

        monkeypatch.setattr(QueryRouter, method, recorded)
    run_analyze("mythril_tpu_torch", wrap_creation(KILLBILLY), 2, "gpu",
                EXECUTION_TIMEOUT, device="cpu", pruning_factor=1)
    own = {"bucketed": ["K3"], "ragged": ["K1", "K2"], "xla": ["K2"]}[mode]
    assert "dispatch" in events
    first = events.index("dispatch")
    for name in ("K1", "K2", "K3"):
        if name in own:
            assert "build " + name in events[:first]
        else:
            assert "build " + name not in events


def test_a_finished_analysis_leaves_no_execution_budget(bucketed_env):
    """fire_lasers ends the execution budget it started: a window solved
    after the run is not cut to get_models_batch's 0.05 s floor once the
    run's budget has passed (found when the bucketed sibling window ran
    after the analyze phase and dispatched nothing)."""
    from mythril_tpu_torch.support.time_handler import time_handler

    run_analyze("mythril_tpu_torch", wrap_creation(KILLBILLY), 1, "cpu",
                EXECUTION_TIMEOUT)
    assert time_handler.time_remaining() == 1e9


def test_device_dispatch_raise_stops_with_device_fault(monkeypatch, tmp_path,
                                                       capsys):
    from mythril_tpu_torch.gpu.router import QueryRouter

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel",
                        lambda *a, **k: pytest.fail("K3 launched"))
    monkeypatch.setattr(QueryRouter, "_ragged_dispatch",
                        lambda *a, **k: pytest.fail("a ragged dispatch"))
    code, stats, _s = _cli_fault(monkeypatch, tmp_path,
                                 "device.dispatch:raise:n1", "--no-ragged")
    assert code == 2
    err = capsys.readouterr().err
    # the DeviceFault the router recorded, carrying the injected cause
    assert "device path failed" in err
    assert "injected fault at device.dispatch" in err
    assert stats["completed"] is False
    assert stats["resilience"]["sites"]["device.dispatch"] == {"injected": 1}
    assert stats["resilience_faults_injected"] == 1
