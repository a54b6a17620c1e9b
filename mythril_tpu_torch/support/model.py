"""The central solve path (reference mythril/support/model.py:63-125).

get_model(constraints, ...) is the choke point every single reachability
check and exploit concretization goes through: memory result tier ->
quick-sat probe over recent models -> full solve on the host CDCL with a
deadline capped by the global time budget (Optimize when the caller
minimizes or maximizes) -> the verdict lands in the memory tier. It raises
UnsatError on unsat and SolverTimeOutException on unknown.

get_models_batch(constraint_sets) takes N constraint lists (sibling-path
feasibility checks) and returns N entries of ("sat", Model) /
("unsat", None) / ("unknown", None):

  memory result tier -> quick-sat probe over recent models -> prepare on
  the host (simplify, lower, blast; with pre-analysis the prefix resume,
  AIG rewrite and CNF preprocessing) -> with `args.solver_backend ==
  "gpu"`, the adaptive router (gpu/router.py) sends the eligible queries
  to the device -> every device model is rebuilt and validated against
  the original constraints -> the host CDCL settles the rest and alone
  proves UNSAT -> verdicts land in the memory tiers.

A device error raises out of here (the JAX package falls back to the
CDCL). The persistent disk tier (store, fingerprints) waits for a later
slice.
"""

import os
import sys
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from typing import Iterable, List, Optional

from mythril_tpu_torch.observe.tracer import span as trace_span
from mythril_tpu_torch.service import memory_tier_enabled
from mythril_tpu_torch.service.interleave import blaster_scope, current_origin
from mythril_tpu_torch.smt.bitvec import Expression
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver.frontend import (
    SAT,
    UNSAT,
    Optimize,
    Solver,
    SolverTimeOutException,
    UnsatError,
)
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.time_handler import time_handler


# UNSAT verdicts on the DETECTION path ("no vulnerability here") get a
# second opinion by default: the host CDCL is the sole UNSAT authority, so
# detection-critical UNSATs are re-solved on a permuted instance
# (solver/sat_backend._crosscheck_unsat). MYTHRIL_GPU_UNSAT_CROSSCHECK=0
# force-disables; any other value force-enables it on the engine path too.
# Engine-internal pruning UNSATs stay single-opinion by default.
_in_detection_context = False


@contextmanager
def detection_context():
    """Marks module predicate evaluation / issue confirmation; get_model
    requests the UNSAT crosscheck inside it."""
    global _in_detection_context
    previous = _in_detection_context
    _in_detection_context = True
    try:
        yield
    finally:
        _in_detection_context = previous


def _crosscheck_wanted() -> bool:
    env = os.environ.get("MYTHRIL_GPU_UNSAT_CROSSCHECK")
    if env == "0":
        return False
    if env not in (None, ""):
        return True
    return _in_detection_context


class ModelCache:
    """Recent models probed before any real solve
    (reference support_utils.py:57-68)."""

    def __init__(self, maxlen: int = 100):
        self.models = deque(maxlen=maxlen)

    def check_quick_sat(self, constraints) -> Optional[Model]:
        for model in self.models:
            if model.satisfies(constraints):
                return model
        return None

    def put(self, model: Model) -> None:
        self.models.appendleft(model)


model_cache = ModelCache()

_result_cache: "OrderedDict" = OrderedDict()
# entries pin whole constraint-term DAGs (keys are Term tuples verified by
# structural equality), so keep the cap modest to bound retention
_RESULT_CACHE_MAX = 2 ** 12

# per-origin memory tiers: each contract's analysis in an interleaved run
# gets its OWN term-keyed result cache and quick-sat deque, so verdicts
# and witness models do not depend on which sibling contracts shared the
# process; get_models_batch resolves them PER QUERY
_origin_caches: dict = {}


def caches_for_origin(origin):
    """(result cache, model cache) for `origin`; the module globals for
    origin-less traffic."""
    if origin is None:
        return _result_cache, model_cache
    if origin not in _origin_caches:
        _origin_caches[origin] = (OrderedDict(), ModelCache())
    return _origin_caches[origin]


def _cache_key(terms_list) -> Optional[tuple]:
    """Order- and multiplicity-insensitive key: the DEDUPLICATED constraint
    terms sorted by hash. The stored entry is verified by structural
    equality on lookup (Term.__eq__), so a hash collision cannot alias two
    constraint sets' verdicts."""
    try:
        return tuple(sorted(dict.fromkeys(terms_list), key=hash))
    except TypeError:
        return None


def get_model(
    constraints,
    minimize: Iterable = (),
    maximize: Iterable = (),
    enforce_execution_time: bool = True,
    solver_timeout: Optional[int] = None,
) -> Model:
    """Solve `constraints` (list of Bool); returns a validated Model."""
    with trace_span("solver.get_model", cat="solver",
                    constraints=len(constraints)):
        return _get_model_impl(constraints, minimize, maximize,
                               enforce_execution_time, solver_timeout)


def _get_model_impl(
    constraints,
    minimize: Iterable = (),
    maximize: Iterable = (),
    enforce_execution_time: bool = True,
    solver_timeout: Optional[int] = None,
) -> Model:
    minimize, maximize = tuple(minimize), tuple(maximize)
    raw_constraints: List = [
        c.raw if isinstance(c, Expression) else c for c in constraints
    ]

    timeout_ms = (solver_timeout if solver_timeout is not None
                  else args.solver_timeout)
    timeout_s = timeout_ms / 1000.0
    if enforce_execution_time:
        timeout_s = min(timeout_s,
                        max(time_handler.time_remaining() - 0.5, 0.05))

    crosscheck = _crosscheck_wanted()
    stats = SolverStatistics()
    key = None
    if not minimize and not maximize:
        key = _cache_key(raw_constraints) if memory_tier_enabled() else None
        if key is not None and key in _result_cache:
            cached = _result_cache[key]
            stats.add_memory_hit()
            if isinstance(cached, Model):
                return cached
            # a cached UNSAT is final even in a detection context: it came
            # from a completed CDCL solve in this process
            raise UnsatError()
        quick = model_cache.check_quick_sat(raw_constraints)
        if quick is not None:
            stats.add_quick_sat_hit()
            if key is not None:
                _store_result(key, quick)
            return quick

    if minimize or maximize:
        solver: Solver = Optimize(timeout=timeout_s)
        for m in minimize:
            solver.minimize(m.raw if isinstance(m, Expression) else m)
        for m in maximize:
            solver.maximize(m.raw if isinstance(m, Expression) else m)
        solver.unsat_crosscheck = crosscheck
        solver.add(raw_constraints)
        status = solver.check()
        if status == SAT:
            return solver.model()
        if status == UNSAT:
            raise UnsatError()
        raise SolverTimeOutException()

    solver = Solver(timeout=timeout_s)
    solver.unsat_crosscheck = crosscheck
    solver.add(raw_constraints)
    start = time.monotonic()
    try:
        prep = solver._prepare([])
        if prep.trivial is not None:
            if prep.trivial == SAT:
                model = solver._trivial_model(prep)
                if key is not None:
                    _store_result(key, model)
                    # trivial models often satisfy sibling queries with
                    # different keys: feed the quick-sat deque too
                    model_cache.put(model)
                return model
            if prep.trivial == UNSAT:
                if key is not None:
                    _store_result(key, UNSAT)
                raise UnsatError()
            raise SolverTimeOutException()

        status = solver._solve_prepared(prep)
        if status == SAT:
            model = solver.model()
            if key is not None:
                _store_result(key, model)
                model_cache.put(model)
            return model
        if status == UNSAT:
            if key is not None:
                _store_result(key, UNSAT)
            raise UnsatError()
        raise SolverTimeOutException()
    finally:
        stats.add_query(time.monotonic() - start)


def get_models_batch(
    constraint_sets,
    enforce_execution_time: bool = True,
    solver_timeout: Optional[int] = None,
    crosscheck: Optional[bool] = None,
    fork_pairs=None,
    origins=None,
) -> List:
    """Batched multi-query solve — THE production device fan-out.

    `crosscheck` requests the permuted-instance UNSAT second opinion on
    the CDCL settling pass (None = MYTHRIL_GPU_UNSAT_CROSSCHECK).
    `fork_pairs`: (i, j) index pairs marking the taken/fall-through sides
    of one batched JUMPI fork — a routing hint only (the router packs a
    pair's shared cone once; verdicts are untouched). `origins`: per-query
    contract tags (None entries for untagged traffic), which select the
    per-origin memory tiers and blasters."""
    with trace_span("solver.batch", cat="solver",
                    queries=len(constraint_sets)):
        return _get_models_batch_impl(constraint_sets,
                                      enforce_execution_time,
                                      solver_timeout, crosscheck,
                                      fork_pairs, origins)


def _get_models_batch_impl(constraint_sets, enforce_execution_time,
                           solver_timeout, crosscheck, fork_pairs,
                           origins) -> List:
    stats = SolverStatistics()
    results: List = [None] * len(constraint_sets)
    if crosscheck is None:
        crosscheck = _crosscheck_wanted()

    timeout_ms = (solver_timeout if solver_timeout is not None
                  else args.solver_timeout)
    timeout_s = timeout_ms / 1000.0
    if enforce_execution_time:
        timeout_s = min(timeout_s,
                        max(time_handler.time_remaining() - 0.5, 0.05))

    use_memory_tier = memory_tier_enabled()
    if origins is None:
        origins = [current_origin()] * len(constraint_sets)

    def origin_of(index):
        return origins[index] if index < len(origins) else None

    # fork-pair members prepare under the root-forcing-deferred aig_opt
    # sweep (preanalysis/aig_opt.deferred_forcing): the per-side forced
    # sweep would diverge the pair's shared base roots, which is exactly
    # what the router's shared-cone pair packing keys on
    fork_members = set()
    if fork_pairs and args.solver_backend == "gpu":
        for pair in fork_pairs:
            fork_members.update(pair)

    pending: List[tuple] = []  # (idx, key, solver, prep)
    start = time.monotonic()
    for idx, constraints in enumerate(constraint_sets):
        raw_constraints = [
            c.raw if isinstance(c, Expression) else c for c in constraints
        ]
        tier, quick_cache = caches_for_origin(origin_of(idx))
        with trace_span("cache.probe", cat="solver"):
            key = _cache_key(raw_constraints) if use_memory_tier else None
            cached = tier.get(key) if key is not None else None
            quick = (quick_cache.check_quick_sat(raw_constraints)
                     if cached is None else None)
        if cached is not None:
            stats.add_memory_hit()
            results[idx] = (("sat", cached) if isinstance(cached, Model)
                            else ("unsat", None))
            continue
        if quick is not None:
            stats.add_quick_sat_hit()
            if key is not None:
                _store_result(key, quick, tier)
            results[idx] = ("sat", quick)
            continue
        solver = Solver(timeout=timeout_s)
        solver.add(raw_constraints)
        if idx in fork_members:
            from mythril_tpu_torch.preanalysis import aig_opt

            prep_scope = aig_opt.deferred_forcing()
        else:
            prep_scope = nullcontext()
        with blaster_scope(origin_of(idx)), prep_scope:
            prep = solver._prepare([])
        if prep.trivial is not None:
            if prep.trivial == SAT:
                # preprocessing may have eliminated every constraint via
                # substitutions — the model must still carry those values
                model = solver._trivial_model(prep)
                results[idx] = ("sat", model)
                if key is not None:
                    _store_result(key, model, tier)
            elif prep.trivial == UNSAT:
                results[idx] = ("unsat", None)
                if key is not None:
                    _store_result(key, UNSAT, tier)
            else:
                results[idx] = ("unknown", None)
            continue
        pending.append((idx, key, solver, prep))

    if pending and args.solver_backend == "gpu":
        from mythril_tpu_torch.gpu.router import get_router

        eligible = []
        ineligible = []
        for entry in pending:
            prep = entry[3]
            if prep.blaster is not None and not prep.clauses.has_empty:
                eligible.append(entry)
            else:
                ineligible.append(entry)
                stats.add_device_ineligible()
        # remap fork pairs onto the eligible-problem axis: a pair survives
        # only when BOTH sides reached the router
        eligible_pairs = None
        if fork_pairs:
            position = {entry[0]: pos for pos, entry in enumerate(eligible)}
            eligible_pairs = [
                (position[i], position[j]) for i, j in fork_pairs
                if i in position and j in position] or None
        bits_list = get_router(args.torch_device).dispatch(
            [(p.num_vars, p.clauses, p.aig_roots)
             for _i, _k, _s, p in eligible],
            timeout_s, stats, fork_pairs=eligible_pairs,
            origins=[origin_of(entry[0]) for entry in eligible])
        still_pending = list(ineligible)
        for (idx, key, solver, prep), bits in zip(eligible, bits_list):
            stats.add_device_batch_query(hit=bits is not None)
            if bits is None:
                still_pending.append((idx, key, solver, prep))
                continue
            # validated against the original constraints: a model that
            # passed the clause check but fails here is a solver bug
            prep.last_bits = bits
            with trace_span("solver.reconstruct", cat="solver"):
                model = solver._reconstruct(prep, bits)
            results[idx] = ("sat", model)
            tier, quick_cache = caches_for_origin(origin_of(idx))
            if key is not None:
                _store_result(key, model, tier)
                quick_cache.put(model)
        pending = still_pending

    # CDCL settles the rest (and proves UNSAT); no device re-entry
    settle_start = time.monotonic()
    with trace_span("solver.settle_pass", cat="solver",
                    queries=len(pending)):
        for idx, key, solver, prep in pending:
            solver.allow_device = False
            solver.unsat_crosscheck = crosscheck
            solver.timeout = max(0.05,
                                 timeout_s - (time.monotonic() - start))
            status = solver._solve_prepared(prep)
            tier, quick_cache = caches_for_origin(origin_of(idx))
            if status == SAT:
                model = solver.model()
                results[idx] = ("sat", model)
                if key is not None:
                    _store_result(key, model, tier)
                    quick_cache.put(model)
            elif status == UNSAT:
                results[idx] = ("unsat", None)
                if key is not None:
                    _store_result(key, UNSAT, tier)
            else:
                results[idx] = ("unknown", None)
    stats.add_host_route_seconds(time.monotonic() - settle_start)
    stats.add_batch(len(constraint_sets), time.monotonic() - start)
    return results


def _store_result(key, value, cache=None) -> None:
    target = cache if cache is not None else _result_cache
    target[key] = value
    while len(target) > _RESULT_CACHE_MAX:
        target.popitem(last=False)


def clear_result_tiers() -> None:
    """Drop the memory tiers alone: the term-keyed results, the quick-sat
    models and the per-origin pairs (every other cache stays warm)."""
    _result_cache.clear()
    model_cache.models.clear()
    _origin_caches.clear()


def clear_caches() -> None:
    """Drop every piece of process-global solve state: the memory tiers,
    the per-origin blasters, the scheduler's buffer, the incremental
    memos, the aig_opt session and result cache, the partition cache, the
    router (its calibration and breaker) and the session fuses; and, once
    the engine's front (core.py) is loaded, its reset_engine_state."""
    clear_result_tiers()
    core = sys.modules.get("mythril_tpu_torch.core")
    if core is not None:
        core.reset_engine_state()
    from mythril_tpu_torch import preanalysis, resilience
    from mythril_tpu_torch.gpu import router
    from mythril_tpu_torch.service import reset_service_state, tenancy
    from mythril_tpu_torch.smt.solver import incremental

    tenancy.clear_blasters()
    reset_service_state()
    incremental.reset()
    preanalysis.reset_caches()
    router.reset_router()
    resilience.reset_session()
