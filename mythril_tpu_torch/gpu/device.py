"""Device choice for the port's entry points, and the record of a device
fault.

Torch is imported only where a device is resolved, so the engine can read
the fault record without loading it."""

from typing import Optional


class NoDeviceError(RuntimeError):
    """No CUDA device, and no device named by the caller."""


class DeviceFault(RuntimeError):
    """The device path failed: K1 did not build or launch, or the card
    raised. It is recorded when raised (record_fault), so that code which
    catches broad exceptions, as the detection modules do, cannot hide it:
    the engine re-raises it after the module returns (raise_recorded_fault)
    and the analysis stops with it."""


_fault: Optional[DeviceFault] = None


def resolve_device(device=None):
    """The torch device an entry point runs on: `device` when the caller
    names one (the CPU tests pass "cpu", which runs every kernel's plain
    PyTorch version), else the current CUDA device. With no device named
    and no CUDA present this raises: the port never drops to the CPU
    unasked."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device available; pass device='cpu' (or set "
            "args.torch_device = 'cpu', or --torch-device cpu) to run the "
            "plain PyTorch versions")
    return torch.device("cuda", torch.cuda.current_device())


def record_fault(error: BaseException) -> DeviceFault:
    """Record `error` from the device path as the process's device fault;
    returns the DeviceFault to raise."""
    global _fault
    if not isinstance(error, DeviceFault):
        error = DeviceFault(f"device path failed: {error!r}")
    _fault = error
    return error


def raise_recorded_fault() -> None:
    """Raise the recorded device fault, if any, and forget it."""
    global _fault
    fault, _fault = _fault, None
    if fault is not None:
        raise fault


def clear_fault() -> None:
    global _fault
    _fault = None
