"""`analyze` with the batched frontier, end to end in the port: the step
backends against each other, the frontier switches of the CLI, and a
fault of the CUDA step (K6), which must stop the analysis.

- MYTHRIL_GPU_FRONTIER_BACKEND=torch (K6's plain version) and =numpy give
  byte-identical KILLBILLY reports and equal frontier counters (host CDCL).
- frontier off (--no-vmap-frontier) in both packages: the port's host
  report is byte-identical to the JAX package's, and no batch is stepped.
- the CLI runs the frontier by default and --no-vmap-frontier switches it
  off; --no-frontier-fork leaves the batches but forks nothing.
- the stepper's backend set to cuda with K6's entry raising: the analysis
  stops with a DeviceFault, and no state is stepped after it.
"""

import pytest

from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

from tests.test_analysis import ASSERT_FAIL, KILLBILLY, wrap_creation
from tests.test_torch_analyze import counted_run, frontier_counters
from tests.torch_helpers import run_analyze

EXECUTION_TIMEOUT = 60  # s, never reached by these contracts


@pytest.fixture(autouse=True)
def fresh_stats(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.delenv("MYTHRIL_GPU_FRONTIER_BACKEND", raising=False)
    stats = SolverStatistics()
    stats.reset()
    yield stats
    stats.reset()


def test_torch_step_report_equals_numpy_step(monkeypatch):
    code = wrap_creation(KILLBILLY)
    runs = {}
    for backend in ("numpy", "torch"):
        monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", backend)
        runs[backend] = counted_run("mythril_tpu_torch", code, 2, "cpu",
                                    EXECUTION_TIMEOUT, pruning_factor=1)
    assert runs["torch"][0].as_json() == runs["numpy"][0].as_json()
    assert runs["torch"][0].as_text() == runs["numpy"][0].as_text()
    assert runs["torch"][1] == runs["numpy"][1]
    assert runs["torch"][1]["frontier_vmap_steps"] > 0
    assert runs["torch"][1]["frontier_forks"] > 0


@pytest.mark.parametrize("runtime,tx_count", [(KILLBILLY, 2),
                                              (ASSERT_FAIL, 1)],
                         ids=["killbilly", "exception"])
def test_frontier_off_equals_the_reference_frontier_off(runtime, tx_count):
    code = wrap_creation(runtime)
    reference, ref_counters = counted_run(
        "mythril_tpu", code, tx_count, "cpu", EXECUTION_TIMEOUT,
        pruning_factor=1, frontier=False)
    port, counters = counted_run(
        "mythril_tpu_torch", code, tx_count, "cpu", EXECUTION_TIMEOUT,
        pruning_factor=1, frontier=False)
    assert port.as_json() == reference.as_json()
    assert port.as_text() == reference.as_text()
    assert counters == ref_counters
    assert counters["frontier_vmap_steps"] == 0


def _cli_counters(*flags):
    """The frontier counters of one in-process CLI analyze of KILLBILLY."""
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    clear_caches()
    SolverStatistics().reset()
    parsed = cli.build_parser().parse_args(
        ["analyze", "-c", wrap_creation(KILLBILLY), "-t", "2",
         "--solver-backend", "cpu", "-o", "json", "--execution-timeout",
         str(EXECUTION_TIMEOUT), "--pruning-factor", "1", *flags])
    try:
        assert cli.execute_command(parsed) == 1
    finally:
        args.reset()
    return frontier_counters("mythril_tpu_torch")


def test_cli_frontier_switches(capsys):
    default = _cli_counters()
    assert default["frontier_vmap_steps"] > 0
    assert default["frontier_forks"] > 0
    assert _cli_counters("--no-vmap-frontier")["frontier_vmap_steps"] == 0
    no_fork = _cli_counters("--no-frontier-fork")
    assert no_fork["frontier_vmap_steps"] > 0
    assert no_fork["frontier_forks"] == 0
    capsys.readouterr()


def test_k6_fault_stops_the_analysis(monkeypatch, fresh_stats):
    """A failing CUDA step is not replayed on the host: the analysis stops
    with a DeviceFault whose cause is the step's error, and the engine
    steps no state after it."""
    import torch

    from mythril_tpu_torch.gpu.device import DeviceFault
    from mythril_tpu_torch.laser import svm
    from mythril_tpu_torch.laser.frontier import kernel

    monkeypatch.setenv("MYTHRIL_GPU_FRONTIER_BACKEND", "cuda")
    # the card this machine lacks: the device is only named, never used
    monkeypatch.setattr(kernel, "backend_device",
                        lambda backend: torch.device("cuda"))
    stepped = []
    at_fault = []
    execute_state = svm.LaserEVM.execute_state

    def counted_execute_state(self, global_state):
        stepped.append(global_state)
        return execute_state(self, global_state)

    def broken_step(run, dense, device):
        at_fault.append(len(stepped))
        raise RuntimeError("injected K6 failure")

    monkeypatch.setattr(svm.LaserEVM, "execute_state", counted_execute_state)
    monkeypatch.setattr(kernel, "_step_cuda", broken_step)
    with pytest.raises(DeviceFault) as caught:
        run_analyze("mythril_tpu_torch", wrap_creation(KILLBILLY), 2, "cpu",
                    EXECUTION_TIMEOUT, pruning_factor=1)
    assert "injected K6 failure" in str(caught.value.__cause__)
    assert len(at_fault) == 1
    assert len(stepped) == at_fault[0]  # nothing stepped after the fault
    assert fresh_stats.frontier_vmap_steps == 0
