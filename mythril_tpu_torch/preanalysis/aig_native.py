"""ctypes calls of the AIG rewrite's cone passes
(mythril_tpu_torch/csrc/aig_passes.cpp).

The passes are built into the port's host library with the host CDCL
(smt/solver/sat_backend.get_native_lib), which binds them: they load, and
fail to load, with it.
"""

import ctypes
from typing import List, Tuple

import numpy as np

from mythril_tpu_torch.smt.bitblast import AIG
from mythril_tpu_torch.smt.solver import sat_backend

# aig_source_pass's status (meta[0]) and its kinds of cone var
OK, OVER_CAP, CONTRADICTION = 0, 1, 2
(SKIP, PINNED_TRUE, PINNED_FALSE, FORCED_FALSE, FORCED_TRUE, INPUT, IMPURE,
 PURE) = range(8)

_i32p = ctypes.POINTER(ctypes.c_int32)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _gate_tables(aig: AIG, roots: List[int]):
    """The gate table's arrays, its last var (read from the arrays, which
    another thread's appends to the AIG cannot lengthen) and the roots."""
    lhs, rhs = aig.gate_arrays()
    num_vars = len(lhs) - 1
    roots_arr = np.asarray(roots, dtype=np.int32)
    if len(roots_arr) and (int(roots_arr.min()) < 0
                           or int(roots_arr.max()) >> 1 > num_vars):
        raise ValueError("a root literal names no var of the AIG")
    return lhs, rhs, num_vars, roots_arr


def source_pass(aig: AIG, roots: List[int], force_roots: bool,
                cap: int) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """optimize_roots' passes over the source cone of `roots` (constants
    already dropped). Returns meta [status, cone size, gates in the cone,
    forced vars, forced inputs, const folds at a contradiction], the cone
    in ascending var order and each cone var's kind; both arrays are
    empty unless the status is OK."""
    lib = sat_backend.get_native_lib()
    lhs, rhs, num_vars, roots_arr = _gate_tables(aig, roots)
    size = min(cap, num_vars)
    cone = np.empty(size, dtype=np.int32)
    kinds = np.empty(size, dtype=np.int8)
    meta = np.zeros(6, dtype=np.int64)
    lib.aig_source_pass(
        num_vars, lhs.ctypes.data_as(_i32p), rhs.ctypes.data_as(_i32p),
        roots_arr.ctypes.data_as(_i32p), len(roots_arr), int(force_roots),
        cap, cone.ctypes.data_as(_i32p), kinds.ctypes.data_as(_i8p),
        meta.ctypes.data_as(_i64p))
    meta = meta.tolist()
    count = meta[1] if meta[0] == OK else 0
    return meta, cone[:count], kinds[:count]


def cone_components(aig: AIG, roots: List[int]) -> Tuple[int, List[int]]:
    """Gates in the cone of `roots`, and for each root the smallest var of
    its variable-disjoint component (0 for a constant root)."""
    lib = sat_backend.get_native_lib()
    lhs, rhs, num_vars, roots_arr = _gate_tables(aig, roots)
    reps = np.empty(len(roots_arr), dtype=np.int32)
    gates = lib.aig_cone_components(
        num_vars, lhs.ctypes.data_as(_i32p), rhs.ctypes.data_as(_i32p),
        roots_arr.ctypes.data_as(_i32p), len(roots_arr),
        reps.ctypes.data_as(_i32p))
    return int(gates), reps.tolist()
