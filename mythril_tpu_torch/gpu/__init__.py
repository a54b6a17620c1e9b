"""Batched satisfiability on the GPU.

The word-level frontend (smt/solver/frontend.py) blasts QF_ABV path
constraints to an AIG plus CNF; this package packs a window of blasted
cones into one ragged flat stream (circuit.py) and searches for models
with the circuit-SLS round, a CUDA kernel for Hopper (ragged_kernel.py,
csrc/ragged_round.cu; in the xla kernel mode, and past its capacities,
xla_kernel.py, csrc/xla_round.cu), driven by backend.py.

Local search is a SAT-finder, not an UNSAT-prover: a found model is
checked on the host against the CNF and the original word-level
constraints, and the queries the device cannot crack are settled by the
C++ CDCL backend, which alone proves UNSAT.

Select with `args.solver_backend = "gpu"` (support/args.py).
"""
