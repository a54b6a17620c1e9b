"""The central solve path (reference mythril/support/model.py:63-125).

get_model(constraints, ...) is the choke point every single reachability
check and exploit concretization goes through: memory result tier ->
quick-sat probe over recent models -> persistent disk tier (service/store,
keyed by the blasted instance's content fingerprint, replay-verified;
under solve_cache "disk" only) -> full solve on the host CDCL with a
deadline capped by the global time budget (Optimize when the caller
minimizes or maximizes) -> the verdict lands in every enabled tier. It
raises UnsatError on unsat and SolverTimeOutException on unknown.

get_models_batch(constraint_sets) takes N constraint lists (sibling-path
feasibility checks) and returns N entries of ("sat", Model) /
("unsat", None) / ("unknown", None):

  memory result tier -> quick-sat probe over recent models -> prepare on
  the host (simplify, lower, blast; with pre-analysis the prefix resume,
  AIG rewrite and CNF preprocessing) -> persistent disk tier -> with
  `args.solver_backend == "gpu"`, the adaptive router (gpu/router.py)
  sends the eligible queries to the device -> every device model is
  rebuilt and validated against the original constraints -> the host
  CDCL settles the rest and alone proves UNSAT -> verdicts land in the
  memory tiers and the disk tier (a device model at whole-instance and
  component granularity, so K1's work outlives the process).

A device error raises out of here as a recorded DeviceFault, and so does
a fresh device model that fails its _reconstruct check (the JAX package
falls back to the CDCL for both). An entry loaded from disk that fails
_reconstruct is a host artefact: a safe miss, counted in
persistent_verify_rejects. A disk hit on an entry another contract's
analysis stored in this process counts xcontract_dedup_hits (corpus
runs). The disk tier's network mirror comes with the fleet slice.
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


# fingerprint -> origin tag of the analysis that first persisted the entry
# in this process (entries written outside an origin are not recorded).
# Telemetry only: a later hit from another origin counts
# xcontract_dedup_hits, the disk tier's content-addressed fingerprints
# deduping identical (sub-)cones across contracts
# (mythril_tpu/support/model.py:126-148). First writer wins, size-capped,
# never read for a verdict.
_fingerprint_origins: dict = {}
_FINGERPRINT_ORIGIN_MAX = 1 << 16


def _record_fingerprint_origin(fingerprint, origin) -> None:
    if fingerprint is None or origin is None:
        return
    if fingerprint not in _fingerprint_origins \
            and len(_fingerprint_origins) >= _FINGERPRINT_ORIGIN_MAX:
        return
    _fingerprint_origins.setdefault(fingerprint, origin)


def _count_xcontract_hit(fingerprint, origin, stats) -> None:
    """A disk-tier hit on an entry another origin stored in this
    process: cross-contract dedup, counted."""
    stored = _fingerprint_origins.get(fingerprint)
    if stored is not None and origin is not None and stored != origin:
        stats.add_xcontract_dedup_hit()


def _cache_key(terms_list) -> Optional[tuple]:
    """Order- and multiplicity-insensitive key: the DEDUPLICATED constraint
    terms sorted by hash. The stored entry is verified by structural
    equality on lookup (Term.__eq__), so a hash collision cannot alias two
    constraint sets' verdicts."""
    try:
        return tuple(sorted(dict.fromkeys(terms_list), key=hash))
    except TypeError:
        return None


def _persistent_store():
    """The on-disk result store, or None when the disk tier is off."""
    from mythril_tpu_torch.service import disk_tier_enabled

    if not disk_tier_enabled():
        return None
    from mythril_tpu_torch.service.store import get_result_store

    store = get_result_store()
    return store if store.available else None


def _prep_partition(prep):
    """The AIG-level partition of a prepared instance's rewritten cone
    (preanalysis/aig_partition.py), or None for monolithic instances: the
    same gate the router's component dispatch uses."""
    aig_roots = getattr(prep, "aig_roots", None)
    if not aig_roots:
        return None
    try:
        from mythril_tpu_torch.preanalysis import aig_partition

        return aig_partition.partition_for_aig_roots(aig_roots)
    except Exception:
        return None


def _count_net_tier(store, stats, event: str) -> None:
    """Mirror a persistent-tier event into the net_tier_* counters when the
    store is the fleet's shared network tier (fleet/netstore.py), so
    serving across processes shows apart from a private disk tier."""
    if stats is None or not getattr(store, "is_network", False):
        return
    if event == "hit":
        stats.add_net_tier_hit()
    elif event == "store":
        stats.add_net_tier_store()
    elif event == "reject":
        stats.add_net_tier_verify_reject()


def _probe_component_assembly(store, solver, prep, stats, origin=None):
    """Disk-tier probe at component granularity: when the whole-instance
    fingerprint misses but every non-trivial component of the partitioned
    instance has a stored SAT sub-model, the components reassemble into a
    full model, so a sub-cone shared by different parent queries hits
    across them. The assembled assignment goes through Solver._reconstruct
    (validated against the ORIGINAL constraints): any staleness or
    collision is a safe miss. Returns ("sat", Model, True) or None. The
    cross-contract dedup hits are counted only once the whole assembly
    serves."""
    partition = _prep_partition(prep)
    if partition is None:
        return None
    from mythril_tpu_torch.preanalysis.aig_partition import (
        apply_trivial_assignment,
        component_vars,
        merge_component_bits,
    )
    from mythril_tpu_torch.service.fingerprint import component_fingerprint

    aig, dense_q = prep.aig_roots[0], prep.aig_roots[2]
    merged = [False] * (prep.num_vars + 1)
    hit_fingerprints = []
    try:
        for component in partition.components:
            if apply_trivial_assignment(component, dense_q, merged):
                continue
            comp_nv, comp_cnf, comp_dense = component.instance(aig)
            fingerprint = component_fingerprint(
                comp_nv, comp_cnf, component.roots, comp_dense)
            entry = store.lookup(fingerprint)
            if entry is None or entry.verdict != "sat" \
                    or entry.num_vars != comp_nv or entry.bits is None:
                return None
            hit_fingerprints.append(fingerprint)
            merge_component_bits(
                comp_dense, dense_q, component_vars(comp_dense),
                entry.bits, merged)
        model = solver._reconstruct(prep, merged)
    except Exception:
        stats.add_persistent_verify_reject()
        _count_net_tier(store, stats, "reject")
        return None
    for fingerprint in hit_fingerprints:
        _count_xcontract_hit(fingerprint, origin, stats)
    return ("sat", model, True)


def _persist_component_entries(store, prep, bits, stats,
                               origin=None) -> None:
    """Store each non-trivial component's sub-model under its own
    fingerprint, so later queries sharing the sub-cone (under any parent,
    in any later process) can reassemble it from disk."""
    partition = _prep_partition(prep)
    if partition is None or bits is None:
        return
    from mythril_tpu_torch.preanalysis.aig_partition import component_vars
    from mythril_tpu_torch.service.fingerprint import component_fingerprint

    aig, dense_q = prep.aig_roots[0], prep.aig_roots[2]
    try:
        for component in partition.components:
            if component.trivial_assignment is not None:
                continue  # units reassemble for free; nothing to store
            comp_nv, comp_cnf, comp_dense = component.instance(aig)
            comp_bits = [False] * (comp_nv + 1)
            for gvar in component_vars(comp_dense):
                qvar = dense_q.get(int(gvar))
                if qvar is not None and qvar < len(bits):
                    comp_bits[comp_dense.arr[gvar]] = bool(bits[qvar])
            fingerprint = component_fingerprint(
                comp_nv, comp_cnf, component.roots, comp_dense)
            if store.store_sat(fingerprint, comp_nv, comp_bits):
                stats.add_persistent_store()
                _count_net_tier(store, stats, "store")
            _record_fingerprint_origin(fingerprint, origin)
    except Exception:
        pass  # persistence is best-effort; never break a solve


def _probe_persistent(solver, prep, crosscheck, stats, origin=None):
    """Disk-tier lookup for a blasted instance: (fingerprint, outcome).
    outcome is ("sat", Model, True) / ("unsat", None, memoizable) on a
    trusted hit, None on a miss; fingerprint is None when the disk tier
    is off or the instance cannot be fingerprinted (callers reuse it to
    store the eventual verdict)."""
    store = _persistent_store()
    if store is None:
        return None, None
    from mythril_tpu_torch.service.fingerprint import instance_fingerprint

    with trace_span("cache.probe", cat="service"):
        return _probe_persistent_store(
            store, instance_fingerprint(prep), solver, prep, crosscheck,
            stats, origin=origin)


def _probe_persistent_store(store, fingerprint, solver, prep, crosscheck,
                            stats, origin=None):
    """A SAT entry is replay-verified: its bits go through
    Solver._reconstruct against the ORIGINAL constraints, and a failure is
    a safe miss (persistent_verify_rejects), never a verdict and never a
    DeviceFault. An UNSAT entry is trusted on the detection path only with
    crosscheck provenance; an unprovenanced one trusted on the engine path
    is not memoizable (a memory-tier UNSAT is final even in a detection
    context, which would bypass the provenance gate)."""
    if fingerprint is None:
        return None, None
    entry = store.lookup(fingerprint)
    if entry is None:
        # a whole-instance miss: a partitioned instance may still
        # reassemble from per-component entries
        assembled = _probe_component_assembly(store, solver, prep, stats,
                                              origin=origin)
        stats.add_persistent_lookup(hit=assembled is not None)
        if assembled is not None:
            _count_net_tier(store, stats, "hit")
        return fingerprint, assembled
    if entry.verdict == "sat":
        try:
            if entry.num_vars != prep.num_vars:
                raise ValueError("entry width differs from the instance")
            model = solver._reconstruct(prep, entry.bits)
        except Exception:
            stats.add_persistent_verify_reject()
            _count_net_tier(store, stats, "reject")
            stats.add_persistent_lookup(hit=False)
            return fingerprint, None
        stats.add_persistent_lookup(hit=True)
        _count_net_tier(store, stats, "hit")
        _count_xcontract_hit(fingerprint, origin, stats)
        return fingerprint, ("sat", model, True)
    if crosscheck and not entry.crosschecked:
        # a detection-critical lookup of an entry that never got its
        # second opinion: re-solve (and re-store with provenance)
        stats.add_persistent_lookup(hit=False)
        return fingerprint, None
    stats.add_persistent_lookup(hit=True)
    _count_net_tier(store, stats, "hit")
    _count_xcontract_hit(fingerprint, origin, stats)
    return fingerprint, ("unsat", None, entry.crosschecked)


def _crosscheck_confirmed(crosscheck: bool) -> bool:
    """Whether the just-settled UNSAT verdict's crosscheck ran and
    positively re-proved UNSAT on the permuted instance. Provenance
    records confirmed, not requested: a cap-skipped or timed-out
    crosscheck keeps the verdict in-process but is not persisted as a
    second opinion."""
    if not crosscheck:
        return False
    from mythril_tpu_torch.smt.solver import sat_backend

    return sat_backend.last_crosscheck_confirmed()


def _persist_result(fingerprint, prep, status, bits=None,
                    crosscheck=False, stats=None, origin=None) -> None:
    """Write a settled verdict into the disk tier (no-op when off). A SAT
    verdict is stored whole and per component."""
    if fingerprint is None:
        return
    store = _persistent_store()
    if store is None:
        return
    if status == SAT:
        stored = store.store_sat(fingerprint, prep.num_vars, bits)
        _persist_component_entries(store, prep, bits, stats,
                                   origin=origin)
    elif status == UNSAT:
        stored = store.store_unsat(
            fingerprint, crosschecked=_crosscheck_confirmed(crosscheck))
    else:
        return
    _record_fingerprint_origin(fingerprint, origin)
    if stored and stats is not None:
        stats.add_persistent_store()
        _count_net_tier(store, stats, "store")


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

        origin = current_origin()
        fingerprint, cached_outcome = _probe_persistent(
            solver, prep, crosscheck, stats, origin=origin)
        if cached_outcome is not None:
            verdict, model, memoizable = cached_outcome
            if verdict == "sat":
                if key is not None:
                    _store_result(key, model)
                model_cache.put(model)
                return model
            if key is not None and memoizable:
                _store_result(key, UNSAT)
            raise UnsatError()

        status = solver._solve_prepared(prep)
        if status == SAT:
            model = solver.model()
            if key is not None:
                _store_result(key, model)
                model_cache.put(model)
            _persist_result(fingerprint, prep, SAT, bits=prep.last_bits,
                            crosscheck=crosscheck, stats=stats,
                            origin=origin)
            return model
        if status == UNSAT:
            if key is not None:
                _store_result(key, UNSAT)
            _persist_result(fingerprint, prep, UNSAT, crosscheck=crosscheck,
                            stats=stats, origin=origin)
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
    # what the router's shared-cone pair packing keys on. Only where the
    # pair can reach that packing, the ragged path: elsewhere the forced
    # sweep's smaller cones win
    fork_members = set()
    if fork_pairs and args.solver_backend == "gpu":
        from mythril_tpu_torch.gpu.router import ragged_enabled

        if ragged_enabled():
            for pair in fork_pairs:
                fork_members.update(pair)

    pending: List[tuple] = []  # (idx, key, fingerprint, solver, prep)
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
        fingerprint, cached_outcome = _probe_persistent(
            solver, prep, crosscheck, stats, origin=origin_of(idx))
        if cached_outcome is not None:
            verdict, model, memoizable = cached_outcome
            if verdict == "sat":
                results[idx] = ("sat", model)
                if key is not None:
                    _store_result(key, model, tier)
                quick_cache.put(model)
            else:
                results[idx] = ("unsat", None)
                if key is not None and memoizable:
                    _store_result(key, UNSAT, tier)
            continue
        pending.append((idx, key, fingerprint, solver, prep))

    if pending and args.solver_backend == "gpu":
        from mythril_tpu_torch.gpu.router import get_router

        eligible = []
        ineligible = []
        for entry in pending:
            prep = entry[4]
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
             for _i, _k, _f, _s, p in eligible],
            timeout_s, stats, fork_pairs=eligible_pairs,
            origins=[origin_of(entry[0]) for entry in eligible])
        still_pending = list(ineligible)
        for entry, bits in zip(eligible, bits_list):
            idx, key, fingerprint, solver, prep = entry
            stats.add_device_batch_query(hit=bits is not None)
            if bits is None:
                still_pending.append(entry)
                continue
            # validated against the original constraints: a device model
            # that passed the clause check but fails here is a fault of
            # the device path, recorded so no caller can retry past it
            prep.last_bits = bits
            try:
                with trace_span("solver.reconstruct", cat="solver"):
                    model = solver._reconstruct(prep, bits)
            except Exception as error:
                from mythril_tpu_torch.gpu.device import record_fault

                raise record_fault(error) from error
            results[idx] = ("sat", model)
            tier, quick_cache = caches_for_origin(origin_of(idx))
            if key is not None:
                _store_result(key, model, tier)
                quick_cache.put(model)
            _persist_result(fingerprint, prep, SAT, bits=bits,
                            crosscheck=crosscheck, stats=stats,
                            origin=origin_of(idx))
        pending = still_pending

    # CDCL settles the rest (and proves UNSAT); no device re-entry
    settle_start = time.monotonic()
    with trace_span("solver.settle_pass", cat="solver",
                    queries=len(pending)):
        for idx, key, fingerprint, solver, prep in pending:
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
                _persist_result(fingerprint, prep, SAT, bits=prep.last_bits,
                                crosscheck=crosscheck, stats=stats,
                                origin=origin_of(idx))
            elif status == UNSAT:
                results[idx] = ("unsat", None)
                if key is not None:
                    _store_result(key, UNSAT, tier)
                _persist_result(fingerprint, prep, UNSAT,
                                crosscheck=crosscheck, stats=stats,
                                origin=origin_of(idx))
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
    models, the per-origin pairs and the disk entries' origin attribution
    (every other cache stays warm)."""
    _result_cache.clear()
    model_cache.models.clear()
    _origin_caches.clear()
    _fingerprint_origins.clear()


def clear_caches(session: Optional[str] = None) -> None:
    """Drop every piece of process-global solve state: the memory tiers,
    the per-origin blasters, the scheduler's buffer and the store handle
    (the disk tier itself survives), the incremental
    memos, the aig_opt session and result cache, the partition cache, the
    router (its calibration and breaker) and the session fuses; and, once
    the engine's front (core.py) is loaded, its reset_engine_state.

    With `session` (the serve daemon's per-tenant eviction,
    mythril_tpu/support/model.py:831) only that session's origins lose
    their memory tiers, quick-sat deques, blasters and prefix snapshots;
    the shared strash table, the disk tier, the scheduler, the router,
    the session fuses and every other tenant's memos stay."""
    if session is not None:
        from mythril_tpu_torch.service import tenancy

        tenancy.evict_session(session)
        return
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
