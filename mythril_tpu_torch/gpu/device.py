"""Device choice for the port's entry points, the dp x mp mesh of the
bucketed path, and the record of a device fault.

Torch is imported only where a device is resolved, so the engine can read
the fault record without loading it."""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


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


@dataclass(frozen=True)
class Mesh:
    """A dp x mp grid of torch devices, the twin of the JAX package's
    `Mesh(devices.reshape(dp, mp), ("dp", "mp"))`: queries split over
    "dp", restart lanes over "mp". One process drives every shard, as one
    controller drives the reference's mesh. A device may appear more than
    once (a virtual mesh: several shards on one card, or on the CPU)."""

    devices: Tuple  # dp * mp torch devices; shard (i, j) at i * mp + j
    dp: int
    mp: int

    def __post_init__(self):
        if self.dp < 1 or self.mp < 1 \
                or len(self.devices) != self.dp * self.mp:
            raise ValueError(f"a {self.dp} x {self.mp} mesh needs "
                             f"{self.dp * self.mp} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def virtual(self) -> bool:
        """Two shards or more share a device."""
        return len(set(self.devices)) < len(self.devices)

    def shard(self, i: int, j: int):
        """The device of shard (dp index i, mp index j)."""
        if not (0 <= i < self.dp and 0 <= j < self.mp):
            raise IndexError(f"shard ({i}, {j}) of a {self.dp} x {self.mp} "
                             f"mesh")
        return self.devices[i * self.mp + j]

    @property
    def lead(self):
        """Shard (0, 0)'s device: where the `mp` MAX is gathered."""
        return self.devices[0]


def mesh_over(devices: Sequence) -> Mesh:
    """The JAX package's mesh rule (mythril_tpu/tpu/backend.py:379-390)
    over `devices` (torch devices or their names): mp = 2 when their count
    is even, else 1; dp = count // mp; the first dp * mp of them."""
    import torch

    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    mp = 2 if len(devices) % 2 == 0 else 1
    dp = len(devices) // mp
    return Mesh(tuple(devices[:dp * mp]), dp, mp)


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
