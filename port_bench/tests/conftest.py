"""Small device settings for the CPU runs of the port (the kernels' plain
versions), and the `cuda` marker: a test that needs the card takes the
`cuda_card` fixture, which skips it when there is none."""

import os

import pytest

# the plain rounds are slow on the CPU: few lanes and steps, no calibration
CPU_SETTINGS = {"MYTHRIL_GPU_RESTARTS": "8", "MYTHRIL_GPU_CIRCUIT_STEPS": "16",
                "MYTHRIL_GPU_RAGGED_WINDOW_CAP": "100",
                "MYTHRIL_GPU_CALIBRATE": "0"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (run on the chip machine)")


@pytest.fixture
def cpu_settings(monkeypatch, tmp_path):
    """The CPU settings, and the port's per-user state in a fresh
    directory."""
    for key, value in CPU_SETTINGS.items():
        monkeypatch.setenv(key, value)
    for key in ("MYTHRIL_GPU_DIR", "MYTHRIL_GPU_CACHE_DIR",
                "MYTHRIL_GPU_FLIGHTREC_DIR"):
        monkeypatch.setenv(key, str(tmp_path / key.lower()))
    return tmp_path


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
