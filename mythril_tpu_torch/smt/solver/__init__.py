"""Solver backends: word-level frontend, CPU CDCL (C++), GPU batched solver."""

from mythril_tpu_torch.smt.solver.frontend import (  # noqa: F401
    Optimize,
    Solver,
    UnsatError,
    SolverTimeOutException,
)
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics  # noqa: F401
