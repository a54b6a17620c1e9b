"""CNF SAT backend: the C++ CDCL solver in native/sat.cpp.

Compiled on first use with g++ into the port's own build directory
(mythril_tpu_torch/_build/) and bound through a plain C ABI with ctypes.
The library is all of the port's host C++: it also hosts the AIG cone /
Tseitin exporters smt/bitblast.py calls and the AIG rewrite's cone passes
(csrc/aig_passes.cpp, called through preanalysis/aig_native.py). A build
failure raises: there is no pure-Python path behind any of them.
"""

import ctypes
import logging
import os
import random
import subprocess
import tempfile
import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from mythril_tpu_torch.observe.tracer import span as trace_span
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCES = (os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "sat.cpp"),
            os.path.join(_PACKAGE_DIR, "csrc", "aig_passes.cpp"))
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
# the host CDCL probe solve_cnf runs before the device: its conflict budget
# (0 skips the probe) and its wall-clock bound
PROBE_CONFLICTS = 20000
PROBE_SECONDS = 0.5

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"

log = logging.getLogger(__name__)

_lib = None
_lib_lock = threading.Lock()


def build_library(sources: Sequence[str], so_name: str) -> str:
    """Build the C++ files `sources` with g++ into one BUILD_DIR/`so_name`,
    unless a build newer than every source is there; returns the path. A
    missing source or a failed or missing compiler raises (OSError,
    SubprocessError)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, so_name)
    if (not os.path.exists(so_path) or os.path.getmtime(so_path)
            < max(os.path.getmtime(source) for source in sources)):
        # build to a temp name and rename: concurrent test workers may
        # race to build, and a half-written .so must never be loaded
        with tempfile.NamedTemporaryFile(
            suffix=".so", dir=BUILD_DIR, delete=False
        ) as tmp:
            tmp_path = tmp.name
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
               "-o", tmp_path, *sources]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return so_path


def _compile_native() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library(_SOURCES, "libhost.so"))
    i32p = ctypes.POINTER(ctypes.c_int)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    i8p = ctypes.POINTER(ctypes.c_byte)
    lib.sat_solve.restype = ctypes.c_int
    lib.sat_solve.argtypes = [
        ctypes.c_int, i32p, i64p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_longlong, i8p,
    ]
    lib.aig_cone.restype = None
    lib.aig_cone.argtypes = [
        ctypes.c_int, i32p, i32p, i32p, ctypes.c_int, u8p, i64p,
    ]
    lib.aig_emit_cnf.restype = ctypes.c_longlong
    lib.aig_emit_cnf.argtypes = [
        ctypes.c_int, i32p, i32p, u8p, i32p, ctypes.c_int, i32p, i32p,
        i64p, i64p,
    ]
    lib.sat_session_new.restype = ctypes.c_void_p
    lib.sat_session_new.argtypes = []
    lib.sat_session_free.restype = None
    lib.sat_session_free.argtypes = [ctypes.c_void_p]
    lib.sat_session_add_cnf.restype = None
    lib.sat_session_add_cnf.argtypes = [
        ctypes.c_void_p, ctypes.c_int, i32p, i64p, ctypes.c_int,
    ]
    lib.sat_session_solve.restype = ctypes.c_int
    lib.sat_session_solve.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_double,
        ctypes.c_longlong, i8p,
    ]
    # the AIG rewrite's cone passes (csrc/aig_passes.cpp)
    lib.aig_source_pass.restype = None
    lib.aig_source_pass.argtypes = [
        ctypes.c_int, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, i8p, i64p,
    ]
    lib.aig_cone_components.restype = ctypes.c_longlong
    lib.aig_cone_components.argtypes = [
        ctypes.c_int, i32p, i32p, i32p, ctypes.c_int, i32p,
    ]
    return lib


def get_native_lib() -> ctypes.CDLL:
    """The compiled native library (built on first use; a failed build
    raises here, and again at the next call)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _compile_native()
    return _lib


def _as_cnf(clauses):
    if hasattr(clauses, "lits"):
        return clauses
    from mythril_tpu_torch.smt.bitblast import CNF

    return CNF.from_clauses(clauses)


# ---------------------------------------------------------------------------
# Per-query CDCL sessions: a prepared problem's instance loads into a
# persistent native solver once; re-solves reuse its learnt clauses.


class PrepSession:
    """Owns one native solver pre-loaded with a query's CNF. Single-
    instance by contract: a second load would solve under learnt clauses
    of the previous instance, so load_cnf refuses it."""

    __slots__ = ("_ptr", "num_vars", "_loaded")

    def __init__(self, ptr, num_vars: int):
        self._ptr = ptr
        self.num_vars = num_vars
        self._loaded = False

    def load_cnf(self, num_vars: int, clauses) -> None:
        if self._loaded:
            raise RuntimeError(
                "PrepSession already holds a CNF instance; create a fresh "
                "session instead of reloading one")
        clauses = _as_cnf(clauses)
        lits_np = np.ascontiguousarray(clauses.lits, dtype=np.int32)
        offs_np = np.ascontiguousarray(clauses.offsets, dtype=np.int64)
        get_native_lib().sat_session_add_cnf(
            self._ptr, num_vars,
            lits_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            offs_np.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(clauses))
        self.num_vars = num_vars
        self._loaded = True

    def solve(self, assumptions, timeout_seconds: float = 0.0,
              conflict_budget: int = 0):
        assume = np.ascontiguousarray(
            np.asarray(list(assumptions), dtype=np.int32))
        model = np.zeros(self.num_vars + 1, dtype=np.int8)
        status = get_native_lib().sat_session_solve(
            self._ptr, assume.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(assume), float(timeout_seconds), int(conflict_budget),
            model.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)))
        if status == 10:
            # List[bool]: np.bool_ would fail the frontend's `is not True`
            # identity validation on valid assignments
            return SAT, model.astype(bool).tolist()
        if status == 20:
            return UNSAT, None
        return UNKNOWN, None

    def __del__(self):
        try:
            if _lib is not None and self._ptr:
                _lib.sat_session_free(self._ptr)
                self._ptr = None
        except Exception:
            pass


def create_prep_session(num_vars: int, clauses) -> PrepSession:
    """Load a query's CNF into a fresh persistent solver."""
    ptr = get_native_lib().sat_session_new()
    if not ptr:
        raise MemoryError("sat_session_new returned NULL")
    session = PrepSession(ptr, num_vars)
    session.load_cnf(num_vars, clauses)
    return session


def solve_cnf(
    num_vars: int,
    clauses: Sequence[Tuple[int, ...]],
    assumptions: Iterable[int] = (),
    timeout_seconds: float = 0.0,
    conflict_budget: int = 0,
    allow_device: bool = True,
    aig_roots=None,
    crosscheck: bool = False,
    session_ctx: Optional[PrepSession] = None,
) -> Tuple[str, Optional[List[bool]]]:
    """Solve CNF with DIMACS-signed literals.

    Returns (status, model) where model[v] is the boolean of var v (1-based),
    or None unless SAT.

    With `args.solver_backend == "gpu"` a conflict-budgeted CDCL probe
    (PROBE_CONFLICTS conflicts, at most PROBE_SECONDS) settles the easy
    queries first, then the device circuit-SLS solver (gpu/router.py)
    searches the rest. It can only return a model, which
    is re-checked on the host; the CDCL stays the UNSAT prover. A device
    error raises: the device is never silently skipped.
    """
    assumptions = list(assumptions)
    from mythril_tpu_torch.support.args import args

    if args.solver_backend == "gpu" and not conflict_budget and allow_device:
        start = time.monotonic()
        if PROBE_CONFLICTS > 0 and len(clauses) <= 200_000:
            probe_status, probe_model = solve_cnf(
                num_vars, clauses, assumptions,
                timeout_seconds=min(PROBE_SECONDS,
                                    timeout_seconds or PROBE_SECONDS),
                conflict_budget=PROBE_CONFLICTS,
                crosscheck=crosscheck,
                session_ctx=session_ctx,
            )
            if probe_status != UNKNOWN:
                return probe_status, probe_model
        if aig_roots is not None and not assumptions:
            from mythril_tpu_torch.gpu.router import get_router

            # the router owns the device decision; a lone query is a
            # window of one
            stats = SolverStatistics()
            bits = get_router(args.torch_device).dispatch(
                [(num_vars, clauses, aig_roots)], timeout_seconds,
                stats)[0]
            stats.add_device_batch_query(hit=bits is not None)
            if bits is not None:
                return SAT, bits
        if timeout_seconds:
            timeout_seconds = max(
                0.05, timeout_seconds - (time.monotonic() - start))
    lib = get_native_lib()
    # one terminal host-CDCL solve: timed into settle_wall and traced as
    # the solver.settle stage (crosscheck re-solves are excluded)
    settle_start = time.monotonic()
    with trace_span("solver.settle", cat="solver",
                    clauses=len(clauses), vars=num_vars,
                    assumptions=len(assumptions)):
        if session_ctx is not None:
            # a session solves whatever instance it was loaded with: a
            # caller handing it another problem would get a wrong verdict
            if session_ctx.num_vars != num_vars:
                raise ValueError(
                    f"session holds a {session_ctx.num_vars}-var instance, "
                    f"caller passed {num_vars} vars")
            status, model = session_ctx.solve(
                assumptions, timeout_seconds, conflict_budget)
        else:
            status, model = _solve_native(lib, num_vars, clauses,
                                          assumptions, timeout_seconds,
                                          conflict_budget)
    SolverStatistics().add_cdcl_settle(
        clauses=len(clauses), seconds=time.monotonic() - settle_start)
    if status == UNSAT and (crosscheck or _crosscheck_enabled()):
        status = _crosscheck_unsat(num_vars, clauses, assumptions,
                                   timeout_seconds, conflict_budget)
    return status, model


def _crosscheck_enabled() -> bool:
    """Global force-enable of the UNSAT second opinion on every solve."""
    return os.environ.get("MYTHRIL_GPU_UNSAT_CROSSCHECK", "") not in ("",
                                                                     "0")


CROSSCHECK_CLAUSE_CAP = 150_000

# outcome of the most recent _crosscheck_unsat: True only when the permuted
# re-solve positively re-proved UNSAT (cap skips and inconclusive timeouts
# are False). The persistent result store reads it right after an UNSAT
# settle, so an entry records provenance as confirmed, never as requested
# (support/model._crosscheck_confirmed).
_last_crosscheck_confirmed = False


def last_crosscheck_confirmed() -> bool:
    return _last_crosscheck_confirmed


def _crosscheck_unsat(num_vars, clauses, assumptions, timeout_seconds,
                      conflict_budget=0) -> str:
    """Soundness net for UNSAT verdicts: re-solve under a random variable
    relabeling + clause shuffle. Disagreement degrades the verdict to
    UNKNOWN. Instances past CROSSCHECK_CLAUSE_CAP are skipped (counted) and
    the re-solve is capped at 3 s."""
    global _last_crosscheck_confirmed
    _last_crosscheck_confirmed = False
    stats = SolverStatistics()
    if len(clauses) > CROSSCHECK_CLAUSE_CAP:
        stats.add_crosscheck(skipped=True)
        return UNSAT
    stats.add_crosscheck(skipped=False)
    start = time.monotonic()
    try:
        with trace_span("solver.crosscheck", cat="solver",
                        clauses=len(clauses), vars=num_vars):
            return _crosscheck_resolve(num_vars, clauses, assumptions,
                                       timeout_seconds, conflict_budget)
    finally:
        stats.add_crosscheck_seconds(time.monotonic() - start)


def _crosscheck_resolve(num_vars, clauses, assumptions, timeout_seconds,
                        conflict_budget) -> str:
    global _last_crosscheck_confirmed
    from mythril_tpu_torch.smt.bitblast import CNF

    rng = random.Random(num_vars * 1_000_003 + len(clauses))
    perm = list(range(1, num_vars + 1))
    rng.shuffle(perm)
    clauses = _as_cnf(clauses)
    perm_arr = np.zeros(num_vars + 1, dtype=np.int64)
    perm_arr[1:] = perm
    lits = clauses.lits
    relabeled = np.where(
        lits > 0, perm_arr[np.abs(lits)], -perm_arr[np.abs(lits)]
    ).astype(np.int32)
    offsets = clauses.offsets
    order = np.arange(len(clauses))
    rng.shuffle(order)
    lengths = (offsets[1:] - offsets[:-1])[order]
    new_offsets = np.zeros(len(clauses) + 1, dtype=np.int64)
    np.cumsum(lengths, out=new_offsets[1:])
    # ragged gather of source literal indices in shuffled clause order
    total = int(new_offsets[-1])
    gather = (np.arange(total, dtype=np.int64)
              + np.repeat(offsets[:-1][order] - new_offsets[:-1], lengths))
    shuffled = CNF(relabeled[gather], new_offsets, len(clauses),
                   clauses.has_empty)
    mapped = [int(np.sign(a)) * int(perm_arr[abs(a)]) for a in assumptions]
    second, _ = _solve_native(get_native_lib(), num_vars, shuffled, mapped,
                              min(timeout_seconds or 3.0, 3.0),
                              conflict_budget)
    if second == SAT:
        log.critical("UNSAT crosscheck DISAGREED: permuted instance is SAT "
                     "(%d vars, %d clauses) — degrading verdict to UNKNOWN",
                     num_vars, len(clauses))
        return UNKNOWN
    # UNKNOWN (a timed-out re-solve) keeps the verdict: the crosscheck
    # only degrades a verdict on positive disagreement; only UNSAT is a
    # confirmation the persistent tier may record
    _last_crosscheck_confirmed = second == UNSAT
    return UNSAT


def _solve_native(lib, num_vars, clauses, assumptions, timeout_seconds,
                  conflict_budget):
    clauses = _as_cnf(clauses)
    lits_np = np.ascontiguousarray(clauses.lits, dtype=np.int32)
    offs_np = np.ascontiguousarray(clauses.offsets, dtype=np.int64)
    assume = np.ascontiguousarray(np.asarray(list(assumptions) or [0],
                                             dtype=np.int32))
    model = np.zeros(num_vars + 1, dtype=np.int8)
    status = lib.sat_solve(
        num_vars, lits_np.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        offs_np.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(clauses), assume.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(assumptions), float(timeout_seconds), int(conflict_budget),
        model.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)))
    if status == 10:
        return SAT, model.astype(bool).tolist()
    if status == 20:
        return UNSAT, None
    return UNKNOWN, None
