"""The port's concolic mode against the JAX package's (the counterparts of
tests/test_concolic.py): concrete replay, trace, branch flip. The port's
output is the JAX package's on the same input, on the host backend and on
the device backend with --torch-device cpu (the flip pass's pruning
windows through the router to K1's plain version). Both packages' args
and execution budgets are restored after each run."""

import importlib
import json
import os
import subprocess
import sys

import pytest

from tests.test_concolic import _concrete_data, _jumpi_address

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_concolic(package, input_word, backend=None, device=None):
    """`package`'s concolic_execution of the two-way branch run with
    `input_word`, flipping its JUMPI, from fresh solve state."""
    concolic = importlib.import_module(f"{package}.concolic")
    args = importlib.import_module(f"{package}.support.args").args
    model = importlib.import_module(f"{package}.support.model")
    time_handler = importlib.import_module(
        f"{package}.support.time_handler").time_handler
    args.reset()
    model.clear_caches()
    if backend is not None:
        args.solver_backend = backend
        args.torch_device = device
    try:
        return concolic.concolic_execution(
            _concrete_data(input_word), [_jumpi_address()],
            solver_timeout=60000)
    finally:
        time_handler.start_execution(None)
        args.reset()


@pytest.fixture(autouse=True)
def cpu_device_settings(monkeypatch):
    """No calibration, and a dispatch budget that a loaded host cannot
    overrun (the plain round's 2.5 s default on the CPU is a deadline;
    past it the run stops with a DeviceFault)."""
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "600")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_MAX_WASTE", "600")


@pytest.mark.parametrize("input_word", [7, 42], ids=["to-equal",
                                                     "to-not-equal"])
@pytest.mark.parametrize("backend, device", [("cpu", None), ("gpu", "cpu")],
                         ids=["host", "device-cpu"])
def test_flip_output_is_the_references(input_word, backend, device):
    ref = run_concolic("mythril_tpu", input_word)
    port = run_concolic("mythril_tpu_torch", input_word, backend, device)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert len(port) == 1 and port[0] is not None
    data = bytes.fromhex(port[0]["steps"][-1]["input"][2:])
    word = int.from_bytes(data[:32].ljust(32, b"\x00"), "big")
    assert (word == 42) == (input_word != 42)


def test_device_flip_pass_reaches_the_router(monkeypatch):
    """The flip pass's 600 s budget turns fork pruning on: on the device
    backend its windows go through the router, whose K1 wrapper runs the
    plain round on the CPU tensors."""
    from mythril_tpu_torch.gpu import ragged_kernel

    calls = []
    plain = ragged_kernel.run_round_ragged_kernel

    def counted(*call_args, **kwargs):
        calls.append(1)
        return plain(*call_args, **kwargs)

    monkeypatch.setattr(ragged_kernel, "run_round_ragged_kernel", counted)
    run_concolic("mythril_tpu_torch", 7, "gpu", "cpu")
    assert calls


@pytest.mark.parametrize("command", ["concolic", "c"])
def test_concolic_cli_subcommand(tmp_path, command):
    data_file = tmp_path / "input.json"
    data_file.write_text(json.dumps(_concrete_data(7)))
    outputs = []
    for package, extra in (("mythril_tpu", []),
                           ("mythril_tpu_torch", ["--torch-device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", package, command, str(data_file),
             "--branches", str(_jumpi_address()), *extra],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "MYTHRIL_GPU_CALIBRATE": "0"})
        assert proc.returncode == 0, proc.stderr
        outputs.append(proc.stdout.strip().splitlines()[-1])
    assert outputs[0] == outputs[1]
    assert json.loads(outputs[1])[0] is not None


def test_concolic_without_a_device_exits_2(tmp_path):
    data_file = tmp_path / "input.json"
    data_file.write_text(json.dumps(_concrete_data(7)))
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "concolic",
         str(data_file), "--branches", str(_jumpi_address())],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr
