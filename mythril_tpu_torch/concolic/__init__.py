"""Concolic mode: concrete replay -> trace -> branch flipping
(reference mythril/concolic/, 193 LoC)."""

from mythril_tpu_torch.concolic.runner import concolic_execution, run_concolic  # noqa: F401
