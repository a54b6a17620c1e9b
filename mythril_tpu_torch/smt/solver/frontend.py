"""Word-level solver frontend.

check() pipeline:
  1. simplify + trivial verdicts
  2. lower to pure QF_BV:
     - unwind select-over-store chains into ite ladders (read-over-write)
     - ackermannize remaining selects on base arrays (fresh symbol per
       distinct index term + pairwise congruence axioms)
     - ackermannize uninterpreted-function applications the same way
  3. bit-blast to CNF (smt/bitblast.py)
  4. CDCL SAT (solver/sat_backend.py — C++ via ctypes)
  5. reconstruct a word-level model (incl. array/UF tables) and VALIDATE it
     against the original constraints with the independent evaluator —
     the soundness net replacing the absent z3 oracle.

With pre-analysis on (the default; preanalysis.enabled()) _prepare also
resumes a query from a sibling's memoized prefix (incremental.py),
rewrites the blasted cone (preanalysis/aig_opt.py: constant sweep +
session strash), records its components (preanalysis/aig_partition.py)
and preprocesses the CNF (preanalysis/cnf_prep.py), and a host-bound
solve settles variable-disjoint components one by one. These are
mythril_tpu's gates, so both packages prepare a query into the same AIG,
roots, CNF and dense map.

Optimize implements minimize/maximize by MSB-first bit fixing under
assumptions over the objective's CNF bits (exploit minimization).
"""

import logging
import time
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch import resilience
from mythril_tpu_torch.observe.tracer import NULL_SPAN, span as trace_span
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitblast import Blaster
from mythril_tpu_torch.smt.bitvec import Expression
from mythril_tpu_torch.smt.eval import evaluate, evaluate_shared
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver import sat_backend
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.smt.terms import BOOL, Term

log = logging.getLogger(__name__)


class UnsatError(Exception):
    pass


class SolverTimeOutException(Exception):
    pass


class SolverInternalError(Exception):
    """A produced model failed validation — a bug in the solver stack."""


SAT, UNSAT, UNKNOWN = sat_backend.SAT, sat_backend.UNSAT, sat_backend.UNKNOWN


def _raw(constraint) -> Term:
    return constraint.raw if isinstance(constraint, Expression) else constraint


def _substitute(roots: List[Term], mapping: Dict[str, Term]) -> List[Term]:
    """Replace sym leaves per `mapping` (name -> term), rebuilding bottom-up
    through the shared smart constructors so folding re-fires."""
    cache: Dict[int, Term] = {}
    for node in terms.walk_terms(roots):
        if node.op == "sym":
            replacement = mapping.get(node.params[0])
            cache[id(node)] = (
                replacement
                if replacement is not None and replacement.sort == node.sort
                else node
            )
            continue
        if not node.children:
            cache[id(node)] = node
            continue
        new_children = [cache[id(c)] for c in node.children]
        if all(a is b for a, b in zip(new_children, node.children)):
            cache[id(node)] = node
        else:
            cache[id(node)] = terms.rebuild(node, new_children)
    return [cache[id(r)] for r in roots]


def _substitute_simplify_fixpoint(term: Term, mapping) -> Term:
    """Substitute `mapping` through `term` and re-simplify until stable.

    A single _substitute pass inserts replacement subtrees VERBATIM, so a
    definition chain (x := y+1 with y := z+1, z := 3 in the same map)
    leaves bound symbols inside the inserted rhs — the residual would
    keep a symbol whose definition was already dropped, and model
    reconstruction would pin it to a value the solver never saw
    (observed: a 3-deep chain left `z` free, the solver chose z freely,
    and validation against the original constraints raised
    SolverInternalError). Bounded by the map size: each pass eliminates
    at least one bound symbol or reaches the fixpoint."""
    for _ in range(len(mapping) + 1):
        new = terms.simplify_expr(_substitute([term], mapping)[0])
        if new is term:
            break
        term = new
    return term


def _extract_binding(term: Term, taken) -> Optional[Tuple[str, Term]]:
    """If `term` asserts sym == rhs (or a bool unit), return the binding."""
    if term.op == "sym" and term.sort == BOOL:
        return term.params[0], terms.TRUE
    if term.op == "not" and term.children[0].op == "sym" \
            and term.children[0].sort == BOOL:
        return term.children[0].params[0], terms.FALSE
    if term.op != "eq":
        return None
    lhs, rhs = term.children
    if not (isinstance(lhs.sort, int) or lhs.sort == BOOL):
        return None  # array equality: not handled here
    # prefer binding to a constant; otherwise either side's symbol
    for sym_side, value_side in ((lhs, rhs), (rhs, lhs)):
        if sym_side.op != "sym" or sym_side.params[0] in taken:
            continue
        name = sym_side.params[0]
        if (name, sym_side.sort) in terms.free_symbols([value_side]):
            continue  # occurs check: x == f(x) is not a definition
        return name, value_side
    return None


def propagate_equalities(
    asserted: List[Term], max_rounds: int = 8
) -> Tuple[List[Term], List[Tuple[str, Term]], bool]:
    """Equality/constant propagation over the assertion set (pre-blast).

    Asserted `sym == rhs` definitions are substituted through every other
    constraint and dropped; repeated to fixpoint. EVM path constraints pin
    many symbols (selector bytes, caller, callvalue), and substituting them
    collapses ite ladders and whole arithmetic cones before the expensive
    bit-blast — the word-level preprocessing role z3 plays for the
    reference. Returns (residual constraints, substitutions in insertion
    order, trivially_unsat). Model reconstruction re-derives substituted
    symbols by evaluating their definitions in reverse insertion order."""
    substitutions: List[Tuple[str, Term]] = []
    taken = set()
    work = list(asserted)
    for _ in range(max_rounds):
        found: Dict[str, Term] = {}
        remaining: List[Term] = []
        for term in work:
            if found:
                # apply this round's earlier bindings (to fixpoint — the
                # map's values may chain) before inspecting, so
                # `x == 5; y == x + 1` resolves in one round and a
                # recorded rhs never references a same-round EARLIER
                # binding (the reverse-resolution order depends on it)
                term = _substitute_simplify_fixpoint(term, found)
            if term.is_const:
                if term.value is False:
                    return [], substitutions, True
                continue
            binding = _extract_binding(term, taken)
            if binding is not None:
                name, rhs = binding
                taken.add(name)
                found[name] = rhs
                substitutions.append((name, rhs))
                continue
            remaining.append(term)
        if not found:
            return remaining, substitutions, False
        work = []
        for term in remaining:
            term = _substitute_simplify_fixpoint(term, found)
            if term.is_const:
                if term.value is False:
                    return [], substitutions, True
                continue
            work.append(term)
    return work, substitutions, False


def narrow_bounded_symbols(
    asserted: List[Term], taken: set
) -> Tuple[List[Term], List[Tuple[str, Term]]]:
    """Bounds-driven symbol narrowing (pre-blast word-level rewrite).

    An asserted constant upper bound `x < c` / `x <= c` proves x's high
    bits are zero; substituting `x := zext(fresh_k)` (k = the bound's bit
    width) makes those zeros STRUCTURAL, so downstream multiplier partial
    products, comparison borrow chains, and adder carries over x collapse
    in the AIG instead of burdening the CDCL. Always sound: the bound
    constraint itself is kept (now a cheap comparison over mostly-constant
    bits), so no models are lost and none are added — any model must
    satisfy the bound anyway. The substitutions flow through
    the standard reconstruction machinery (the fresh symbol's "!" prefix
    keeps it out of visible models). Returns (residual terms, new
    substitutions); residual None means a constraint folded to false under
    the restriction — since the restriction loses no models, that proves
    the original set unsat."""
    bounds: Dict[str, int] = {}  # name -> tightest narrowed width
    widths: Dict[str, int] = {}
    for term in asserted:
        if term.op not in ("bvult", "bvule"):
            continue
        lhs, rhs = term.children
        if lhs.op != "sym" or not isinstance(lhs.sort, int):
            continue
        if not (rhs.is_const and isinstance(rhs.value, int)):
            continue
        bound = rhs.value - 1 if term.op == "bvult" else rhs.value
        if bound < 0:
            continue  # x < 0: unsat; leave it to the solver
        narrow = max(1, bound.bit_length())
        name = lhs.params[0]
        if name in taken or narrow >= lhs.sort:
            continue
        widths[name] = lhs.sort
        bounds[name] = min(bounds.get(name, narrow), narrow)
    if not bounds:
        return asserted, []
    substitutions: List[Tuple[str, Term]] = []
    mapping: Dict[str, Term] = {}
    for name, narrow in bounds.items():
        width = widths[name]
        fresh = terms.bv_sym(f"!narrow!{name}", narrow)
        definition = terms.zext(width - narrow, fresh)
        mapping[name] = definition
        substitutions.append((name, definition))
        taken.add(name)
    narrowed: List[Term] = []
    for term in _substitute(asserted, mapping):
        term = terms.simplify_expr(term)
        if term.is_const:
            if term.value is False:
                # false under the (sound) restriction => unsat overall
                return None, substitutions
            continue
        narrowed.append(term)
    return narrowed, substitutions


class _Lowering:
    """Rewrites a set of bool terms into pure QF_BV + side constraints."""

    def __init__(self):
        self.cache: Dict[int, Term] = {}
        self.side_constraints: List[Term] = []
        # (array_name) -> list of (index_term, fresh_sym_term)
        self.array_reads: Dict[str, List[Tuple[Term, Term]]] = {}
        # func name -> list of (args_tuple, fresh_sym_term)
        self.func_apps: Dict[str, List[Tuple[Tuple[Term, ...], Term]]] = {}
        self._fresh = 0

    def fresh(self, size: int, tag: str) -> Term:
        self._fresh += 1
        return terms.bv_sym(f"!{tag}!{self._fresh}", size)

    def lower(self, term: Term) -> Term:
        hit = self.cache.get(id(term))
        if hit is not None:
            return hit
        result = self._lower_node(term)
        self.cache[id(term)] = result
        return result

    def drain_side_constraints(self) -> List[Term]:
        out = self.side_constraints
        self.side_constraints = []
        return out

    def clone(self) -> "_Lowering":
        """Independent copy for the incremental prefix memo: a snapshot
        must survive this query's drain/extend, and a resumed child must
        not mutate the shared snapshot. Side constraints are copied
        UNDRAINED so a resume appends the suffix's constraints to the
        prefix's and the final drain reproduces the full pipeline's root
        order exactly."""
        twin = _Lowering.__new__(_Lowering)
        twin.cache = dict(self.cache)
        twin.side_constraints = list(self.side_constraints)
        twin.array_reads = {k: list(v) for k, v in self.array_reads.items()}
        twin.func_apps = {k: list(v) for k, v in self.func_apps.items()}
        twin._fresh = self._fresh
        return twin

    def _lower_node(self, term: Term) -> Term:
        op = term.op
        if op == "select":
            return self._lower_select(term.children[0], self.lower_index(term.children[1]))
        if op == "apply":
            decl = term.params[0]
            args = tuple(self.lower(a) for a in term.children)
            return self._ackermann_apply(decl, args)
        if op == "eq" and not isinstance(term.children[0].sort, int) \
                and term.children[0].sort != BOOL:
            raise NotImplementedError("array extensionality is not supported")
        if not term.children:
            return term
        new_children = [self.lower(c) for c in term.children]
        if all(a is b for a, b in zip(new_children, term.children)):
            return term
        return terms.rebuild(term, new_children)

    def lower_index(self, index: Term) -> Term:
        return self.lower(index)

    def _lower_select(self, arr: Term, index: Term) -> Term:
        """Unwind store/ite chains; terminate at base array / karray."""
        if arr.op == "store":
            base, widx, wval = arr.children
            widx_l = self.lower(widx)
            wval_l = self.lower(wval)
            hit = terms.eq(index, widx_l)
            if hit.is_const:
                if hit.value:
                    return wval_l
                return self._lower_select(base, index)
            return terms.ite(hit, wval_l, self._lower_select(base, index))
        if arr.op == "karray":
            return self.lower(arr.children[0])
        if arr.op == "ite":
            cond = self.lower(arr.children[0])
            then = self._lower_select(arr.children[1], index)
            otherwise = self._lower_select(arr.children[2], index)
            return terms.ite(cond, then, otherwise)
        if arr.op == "array":
            return self._ackermann_select(arr, index)
        raise NotImplementedError(f"select over {arr.op}")

    def _ackermann_select(self, arr: Term, index: Term) -> Term:
        name = arr.params[0]
        rng = arr.sort[2]
        reads = self.array_reads.setdefault(name, [])
        for prev_index, prev_sym in reads:
            if prev_index == index:
                return prev_sym
        sym = self.fresh(rng, f"sel!{name}")
        # congruence with all previous reads of the same array
        for prev_index, prev_sym in reads:
            self.side_constraints.append(
                terms.bool_or([
                    terms.bool_not(terms.eq(index, prev_index)),
                    terms.eq(sym, prev_sym),
                ])
            )
        reads.append((index, sym))
        return sym

    def _ackermann_apply(self, decl: terms.FuncDecl, args: Tuple[Term, ...]) -> Term:
        apps = self.func_apps.setdefault(decl.name, [])
        for prev_args, prev_sym in apps:
            if prev_args == args:
                return prev_sym
        sym = self.fresh(decl.range, f"app!{decl.name}")
        for prev_args, prev_sym in apps:
            same_args = terms.bool_and(
                [terms.eq(a, b) for a, b in zip(args, prev_args)]
            )
            self.side_constraints.append(
                terms.bool_or([terms.bool_not(same_args), terms.eq(sym, prev_sym)])
            )
        apps.append((args, sym))
        return sym


class _Prepared:
    """Lowered + blasted problem state shared across assumption probes."""

    __slots__ = ("trivial", "original", "lowering", "blaster",
                 "num_vars", "clauses", "objective_bits", "last_bits",
                 "substitutions", "aig_roots", "symbols", "var_dense",
                 "session")

    def __init__(self):
        self.trivial: Optional[str] = None
        self.original: List[Term] = []
        self.lowering: Optional[_Lowering] = None
        self.blaster: Optional[Blaster] = None
        self.num_vars = 0
        self.clauses: List = []
        self.objective_bits: List[List[int]] = []
        self.last_bits: Optional[List[bool]] = None
        # (name, definition) pairs eliminated by propagate_equalities
        self.substitutions: List[Tuple[str, Term]] = []
        # (aig, root literals) snapshot for THIS problem — with the shared
        # global blaster, blaster.last_roots belongs to whoever blasted last
        self.aig_roots: Optional[Tuple] = None
        # free symbols of THIS problem's lowered terms: the shared blaster's
        # symbol tables span every problem ever blasted, so reconstruction
        # must filter to these (same-named symbols from other problems would
        # otherwise leak into — and corrupt — the model)
        self.symbols: Optional[set] = None
        # global AIG var -> dense CNF var (the cone's compact numbering)
        self.var_dense: dict = {}
        # lazily-created per-query native solver session (sat_backend);
        # holds the loaded instance across assumption probes
        self.session = None


_global_blaster: Optional[Blaster] = None
_global_blaster_generation = -1
BLASTER_VAR_CAP = 20_000_000  # reset past this to bound memory


def get_global_blaster() -> Blaster:
    """Process-wide blaster: terms are hash-consed (smt/terms.py), so its
    id-keyed memo + structurally-hashed AIG persist across solver calls —
    repeated confirmation queries share their blasted cones instead of
    rebuilding them. Resets when the term intern table is cleared (the memo
    keys would dangle) or when the AIG outgrows the var cap."""
    global _global_blaster, _global_blaster_generation
    if (
        _global_blaster is None
        or _global_blaster_generation != terms.Term.generation
        or _global_blaster.aig.num_vars > BLASTER_VAR_CAP
    ):
        _global_blaster = Blaster()
        _global_blaster_generation = terms.Term.generation
    return _global_blaster


class _StageClock:
    """The stages of one prepare, each timed into its SolverStatistics
    timer and traced as a span over the same code. enter(stage) ends the
    running stage and begins `stage` on one time.monotonic() reading, so
    the stages partition prepare from the first enter() to close(); an
    early return still adds the stage it was in. Entering the running
    stage again changes nothing."""

    TIMERS = {"word": "prepare_word_wall", "blast": "prepare_blast_wall",
              "aig_opt": "aig_opt_wall", "cnf_prep": "cnf_prep_wall"}

    __slots__ = ("_stage", "_start", "_span")

    def __init__(self):
        self._stage = None
        self._start = 0.0
        self._span = NULL_SPAN

    def enter(self, stage: str, **attrs):
        """Begin `stage` (a TIMERS key); returns its span, for set()."""
        if stage == self._stage:
            return self._span
        now = time.monotonic()
        self._end(now)
        self._stage, self._start = stage, now
        self._span = trace_span("solver." + stage, cat="solver", **attrs)
        self._span.__enter__()
        return self._span

    def close(self) -> None:
        self._end(time.monotonic())

    def _end(self, now: float) -> None:
        if self._stage is None:
            return
        self._span.__exit__(None, None, None)
        SolverStatistics().add_prepare_stage(self.TIMERS[self._stage],
                                             now - self._start)
        self._stage, self._span = None, NULL_SPAN


class Solver:
    """Check a conjunction of Bool constraints; extract word-level models."""

    def __init__(self, timeout: Optional[float] = None):
        self.timeout = timeout  # seconds
        self.constraints: List[Term] = []
        self._model: Optional[Model] = None
        self.conflict_budget = 0
        # False = plain CDCL only (the batched device path sets this for
        # leftover settling so solve_cnf doesn't re-enter the device)
        self.allow_device = True
        # True = UNSAT verdicts are re-solved on a permuted instance
        self.unsat_crosscheck = False

    def set_timeout(self, timeout_ms: int) -> None:
        self.timeout = timeout_ms / 1000.0

    def add(self, *constraints) -> None:
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.add(*c)
            else:
                self.constraints.append(_raw(c))

    append = add

    def check(self, *extra) -> str:
        stats = SolverStatistics()
        start = time.monotonic()
        try:
            return self._check([_raw(e) for e in extra])
        finally:
            stats.add_query(time.monotonic() - start)

    def _prepare(self, extra: List[Term],
                 objectives: List[Term] = ()) -> "_Prepared":
        """Simplify, lower, and blast the assertion set (+ objective bits).
        Timed into prepare_wall and traced as the solver.prepare stage
        (its `mode` attr tells a prefix resume from the full pipeline);
        inside it, _StageClock times and traces the four stages."""
        start = time.monotonic()
        stages = _StageClock()
        with trace_span("solver.prepare", cat="solver",
                        constraints=len(self.constraints) + len(extra)) as sp:
            try:
                return self._prepare_impl(extra, objectives, sp, stages)
            finally:
                stages.close()
                SolverStatistics().add_prepare_seconds(
                    time.monotonic() - start)

    def _prepare_impl(self, extra: List[Term], objectives: List[Term],
                      sp, stages: "_StageClock") -> "_Prepared":
        # the stages run in order, word, blast, aig_opt, cnf_prep, each
        # until the next begins; blast runs twice when the AIG rewrite
        # returns nothing or fails (bv_bits and assert_bool before it,
        # the blaster's CNF after), adding to its timer both times with
        # a span each
        stages.enter("word")
        from mythril_tpu_torch import preanalysis
        from mythril_tpu_torch.smt.solver import incremental

        prep = _Prepared()
        # incremental cross-query preparation (smt/solver/incremental.py):
        # memoized simplify + prefix-snapshot resume, withheld under
        # Optimize objectives (the memo would have to snapshot them too).
        # A fault inside it
        # degrades THIS query to the full pipeline, and repeated faults
        # blow the session fuse so the layer stays off
        use_incr = (not objectives and incremental.enabled()
                    and not resilience.fuse_blown("prepare.incremental"))
        simplify = (incremental.simplify_cached if use_incr
                    else terms.simplify_expr)
        asserted: List[Term] = []
        for term in self.constraints + extra:
            term = simplify(term)
            if term.is_const:
                if term.value is False:
                    prep.trivial = UNSAT
                    return prep
                continue
            asserted.append(term)
        prep.original = asserted

        resume = None
        if use_incr:
            try:
                resilience.maybe_inject("prepare.incremental")
                resume = incremental.try_resume(asserted)
            except Exception:
                log.warning("incremental prefix resume failed; full "
                            "prepare pipeline for this query",
                            exc_info=True)
                resilience.note_stage_failure("prepare.incremental")
                use_incr = False
                resume = None
        if resume is not None and resume.unsat:
            prep.trivial = UNSAT
            return prep
        sp.set(mode="prefix_resume" if resume is not None else "full")
        if resume is not None:
            # path constraints grow monotonically: this query's list is a
            # memoized sibling's plus a suffix — the prefix's substitution
            # map, lowering state and lowered terms are resumed and only
            # the suffix runs the word-level pipeline below
            asserted_residual = resume.suffix_residual
            residual_full = resume.residual
            prep.substitutions = resume.substitutions
            taken_equal = resume.taken_equal
            taken_narrow = resume.taken_narrow
            lowering = resume.lowering
            lowered_prefix = resume.lowered_prefix
        else:
            # pre-blast word-level preprocessing: substitute asserted
            # definitions (sym == rhs) through the set before any lowering
            asserted_residual, prep.substitutions, unsat = \
                propagate_equalities(asserted)
            if unsat:
                prep.trivial = UNSAT
                return prep
            taken_equal = {name for name, _ in prep.substitutions}
            # then narrow constant-bounded symbols so their high bits become
            # structural zeros (collapses multiplier/comparison cones)
            asserted_residual, narrow_subs = narrow_bounded_symbols(
                asserted_residual, set(taken_equal)
            )
            prep.substitutions = prep.substitutions + narrow_subs
            taken_narrow = {name for name, _ in narrow_subs}
            if asserted_residual is None:
                prep.trivial = UNSAT
                return prep
            residual_full = asserted_residual
            # objectives must see the same substitution; iterate because
            # later bindings may appear inside earlier definitions
            if objectives and prep.substitutions:
                mapping = dict(prep.substitutions)
                objectives = list(objectives)
                for _ in range(len(prep.substitutions)):
                    new_objectives = [
                        terms.simplify_expr(t)
                        for t in _substitute(objectives, mapping)
                    ]
                    if all(a is b
                           for a, b in zip(new_objectives, objectives)):
                        break
                    objectives = new_objectives
            lowering = _Lowering()
            lowered_prefix = []

        try:
            lowered = lowered_prefix + [
                lowering.lower(t) for t in asserted_residual]
            lowered_objectives = [lowering.lower(o) for o in objectives]
        except NotImplementedError:
            prep.trivial = UNKNOWN
            return prep
        if use_incr:
            # snapshot BEFORE draining side constraints so a resumed child
            # reproduces the full pipeline's root ordering
            incremental.record(asserted, residual_full, prep.substitutions,
                               taken_equal, taken_narrow, lowering, lowered)
        lowered = lowered + lowering.drain_side_constraints()
        lowered = [simplify(t) for t in lowered]
        if any(t.is_const and t.value is False for t in lowered):
            prep.trivial = UNSAT
            return prep
        lowered = [t for t in lowered if not t.is_const]
        if not lowered and not objectives:
            prep.trivial = SAT
            return prep
        if use_incr:
            # per-root memoized scan: sibling queries share most roots
            prep.symbols = set(incremental.free_symbols_cached(
                list(lowered) + list(lowered_objectives)))
        else:
            prep.symbols = set(terms.free_symbols(
                list(lowered) + list(lowered_objectives)))

        stages.enter("blast")
        prep.lowering = lowering
        prep.blaster = get_global_blaster()
        objective_lits: List[int] = []
        prep.objective_bits = []
        for lowered_obj in lowered_objectives:
            bits = prep.blaster.bv_bits(lowered_obj)
            prep.objective_bits.append(bits)
            objective_lits.extend(bits)
        # AIG rewrite (preanalysis/aig_opt.py): the blasted cone is swept
        # (root-forced constants propagated, dead fanout pruned, trivially
        # UNSAT roots detected — the verdict still settles through the
        # CDCL) and re-strashed BEFORE the CNF is emitted, so the router
        # and the host CDCL consume the smaller rewritten instance.
        # prep.var_dense stays in ORIGINAL global numbering (composed
        # through the rewrite's input map) so _reconstruct works unchanged,
        # while prep.aig_roots carries the rewritten (aig, roots, dense).
        # Withheld under Optimize objectives: bit probes assume over
        # objective-bit literals of the ORIGINAL shared AIG, and the
        # rewrite could fold those gates away.
        aig_opted = False
        if not objectives and not resilience.fuse_blown("aig.session"):
            from mythril_tpu_torch.preanalysis import aig_opt

            if aig_opt.enabled():
                # a fault anywhere in the rewrite degrades THIS query to
                # the un-rewritten blaster CNF below (assert_bool/cnf are
                # memoized, so the fallback lands on identical roots);
                # repeated faults blow the session fuse. A host library
                # that cannot be built raises again there, from to_cnf
                try:
                    resilience.maybe_inject("aig.session")
                    roots = [prep.blaster.assert_bool(t) for t in lowered]
                    prep.blaster.last_roots = roots
                    opt_span = stages.enter(
                        "aig_opt", roots=len(roots),
                        deferred=aig_opt.defer_active())
                    opt = aig_opt.optimize_roots_cached(
                        prep.blaster.aig, roots)
                    if opt is not None:
                        opt_span.set(visited=opt.visited)
                        prep.num_vars, prep.clauses, opt_dense = \
                            opt.aig.to_cnf(list(opt.roots))
                        prep.aig_roots = (opt.aig, list(opt.roots),
                                          opt_dense)
                        prep.var_dense = aig_opt.ComposedDense(
                            opt.input_map, opt_dense)
                        stats = SolverStatistics()
                        stats.add_aig_opt(
                            opt.nodes_before, opt.nodes_after,
                            opt.strash_merges, opt.const_folds,
                            trivial_unsat=opt.trivially_unsat,
                            visited=opt.visited)
                        stats.add_strash_xquery(opt.xquery_merges)
                        from mythril_tpu_torch.preanalysis import (
                            aig_partition,
                        )

                        partition = aig_partition.partition_cached(
                            opt.aig, opt.roots, opt.root_labels)
                        if partition is not None:
                            stats.add_aig_components(
                                len(partition.components))
                        aig_opted = True
                except Exception:
                    log.warning("AIG session optimization failed; "
                                "un-rewritten CNF for this query",
                                exc_info=True)
                    resilience.note_stage_failure("aig.session")
                    aig_opted = False
        if not aig_opted:
            stages.enter("blast")
            prep.num_vars, prep.clauses, prep.var_dense = prep.blaster.cnf(
                lowered, objective_lits)
            prep.aig_roots = (prep.blaster.aig,
                              list(prep.blaster.last_roots),
                              prep.var_dense)
        # CNF preprocessing (preanalysis/cnf_prep.py): unit propagation +
        # pure literals BEFORE router dispatch, numbering preserved. The
        # pure rule is withheld when the instance may ride the device: the
        # circuit kernel searches the ORIGINAL AIG's model space, and a
        # model putting a pure-pinned variable at the opposite polarity
        # would fail the clause check. An AIG-rewritten instance is always
        # device-possible here. Under objectives it is withheld too: Optimize
        # probes the instance under assumptions later, and pinning a bit the
        # original CNF leaves free would flip those probes' verdicts. A
        # propagation CONFLICT does not short-circuit: the CDCL re-derives it and applies the crosscheck policy.
        if preanalysis.enabled():
            from mythril_tpu_torch.preanalysis.aig_opt import defer_active
            from mythril_tpu_torch.preanalysis.cnf_prep import preprocess_cnf
            from mythril_tpu_torch.support.args import args as _args

            device_possible = (
                (_args.solver_backend == "gpu" and self.allow_device)
                or aig_opted)
            # `deferred`: a fork-pair member, prepared under the deferred-
            # forcing sweep (support/model.get_models_batch)
            prep_span = stages.enter("cnf_prep", clauses=len(prep.clauses),
                                     deferred=defer_active())
            simplified = preprocess_cnf(
                prep.num_vars, prep.clauses,
                allow_pure=not objectives and not device_possible)
            if simplified is not None:
                prep_span.set(rounds=simplified.rounds,
                              units=simplified.units,
                              visited=simplified.visited)
            if simplified is not None and simplified.changed \
                    and not simplified.conflict:
                SolverStatistics().add_cnf_preprocess(
                    simplified.units, simplified.pures,
                    simplified.removed_clauses, simplified.rounds,
                    simplified.visited)
                prep.clauses = simplified.cnf
        return prep

    def _solve_prepared(self, prep: "_Prepared",
                        assumptions: List[int] = ()) -> str:
        aig_roots = prep.aig_roots if not assumptions else None
        # connected-component splitting (preanalysis/cnf_prep.py): when
        # this solve is host-CDCL-bound anyway, variable-disjoint
        # sub-instances settle independently
        if not assumptions and prep.session is None:
            split_status = self._try_solve_split(prep)
            if split_status is not None:
                return split_status
        # per-query session: the instance loads into a persistent native
        # solver on first use; later solves reuse it under assumptions
        if prep.session is None and prep.blaster is not None:
            prep.session = sat_backend.create_prep_session(
                prep.num_vars, prep.clauses)
        status, bits = sat_backend.solve_cnf(
            prep.num_vars,
            prep.clauses,
            assumptions=assumptions,
            timeout_seconds=self.timeout or 0.0,
            conflict_budget=self.conflict_budget,
            allow_device=self.allow_device,
            aig_roots=aig_roots,
            crosscheck=self.unsat_crosscheck and not assumptions,
            session_ctx=prep.session,
        )
        if status == SAT:
            prep.last_bits = bits
            self._model = self._reconstruct(prep, bits)
        return status

    def _try_solve_split(self, prep: "_Prepared") -> Optional[str]:
        """Settle a multi-component instance component by component on the
        host CDCL; None when splitting does not apply (single component,
        oversize, preanalysis off, or a device dispatch is still possible
        for the whole cone — the circuit kernel needs the full AIG)."""
        from mythril_tpu_torch import preanalysis
        from mythril_tpu_torch.support.args import args as _args

        if not preanalysis.enabled():
            return None
        if (_args.solver_backend == "gpu" and self.allow_device
                and prep.aig_roots is not None):
            return None
        from mythril_tpu_torch.preanalysis.cnf_prep import (
            merge_component_bits,
            split_components,
        )

        components = split_components(prep.num_vars, prep.clauses)
        if components is None:
            return None
        SolverStatistics().add_cnf_split(len(components))
        deadline = (time.monotonic() + self.timeout) if self.timeout else None
        bits_list = []
        for component in components:
            if component.trivial_bits is not None:
                # all-unit consistent component: its model is its literals
                bits_list.append(component.trivial_bits)
                continue
            remaining = 0.0
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return UNKNOWN
            status, bits = sat_backend.solve_cnf(
                component.num_vars,
                component.cnf,
                timeout_seconds=max(remaining, 0.0),
                conflict_budget=self.conflict_budget,
                allow_device=False,
                # an UNSAT component proves the whole instance UNSAT
                crosscheck=self.unsat_crosscheck,
            )
            if status == UNSAT:
                return UNSAT
            if status != SAT:
                return UNKNOWN
            bits_list.append(bits)
        merged = merge_component_bits(prep.num_vars, components, bits_list)
        prep.last_bits = merged
        self._model = self._reconstruct(prep, merged)
        return SAT

    def _check(self, extra: List[Term]) -> str:
        self._model = None
        prep = self._prepare(extra)
        if prep.trivial is not None:
            if prep.trivial == SAT:
                self._model = self._trivial_model(prep)
            return prep.trivial
        self.last_prep = prep  # the prepared instance, for tests and tools
        return self._solve_prepared(prep)

    @staticmethod
    def _resolve_substitutions(assignment: Dict, prep: "_Prepared") -> None:
        """Re-derive symbols eliminated by propagate_equalities.

        Reverse insertion order works because each definition was fully
        substituted w.r.t. earlier bindings when recorded — it can only
        reference later-bound or never-bound symbols."""
        for name, definition in reversed(prep.substitutions):
            assignment[name] = evaluate(definition, assignment)

    def _trivial_model(self, prep: "_Prepared") -> Model:
        """All constraints eliminated by preprocessing: the model is just
        the substituted definitions (empty only when none were made)."""
        assignment: Dict = {}
        self._resolve_substitutions(assignment, prep)
        model = Model(assignment)
        for term in prep.original:
            if evaluate(term, model.assignment) is not True:
                raise SolverInternalError(
                    f"model validation failed on {terms.term_to_str(term)}"
                )
        return model

    def _reconstruct(self, prep: "_Prepared", bits: List[bool]) -> Model:
        blaster, lowering = prep.blaster, prep.lowering
        assignment: Dict = {}
        # the blaster is shared across problems: symbols allocated AFTER
        # this prep's CNF snapshot have vars past len(bits) — they are not
        # part of this problem and default to 0 via model completion
        dense = prep.var_dense
        # iterate THIS problem's symbols (prep.symbols), not the shared
        # blaster's tables, which accumulate every symbol ever blasted
        for name, sort in prep.symbols or ():
            if sort == terms.BOOL:
                var = blaster.bool_symbol_vars.get(name)
                if var is None:
                    continue
                dvar = dense.get(var)
                assignment[name] = bits[dvar] if dvar is not None else False
            elif isinstance(sort, int):
                var_list = blaster.bv_symbol_vars.get((name, sort))
                if var_list is None:
                    continue
                value = 0
                for i, var in enumerate(var_list):
                    dvar = dense.get(var)
                    # bits outside the cone are unconstrained -> 0
                    if dvar is not None and bits[dvar]:
                        value |= 1 << i
                assignment[name] = value
        # rebuild array tables from the ackermannized reads
        for arr_name, reads in lowering.array_reads.items():
            entries = {}
            for index_term, sym_term in reads:
                index_value = evaluate(index_term, assignment)
                entries[index_value] = assignment.get(sym_term.params[0], 0)
            assignment[arr_name] = (0, entries)
        # rebuild UF tables
        for func_name, apps in lowering.func_apps.items():
            table = {}
            for args_terms, sym_term in apps:
                key = tuple(evaluate(a, assignment) for a in args_terms)
                table[key] = assignment.get(sym_term.params[0], 0)
            assignment[func_name] = (0, table)
        # symbols eliminated pre-blast come back via their definitions.
        # AFTER the array/UF tables: a definition like x == storage[0]
        # needs the rebuilt table, while the recorded array-read index
        # terms were lowered post-substitution and so never reference an
        # eliminated symbol — this order has no cycle.
        self._resolve_substitutions(assignment, prep)
        # drop internal fresh symbols from the visible model
        visible = {k: v for k, v in assignment.items()
                   if not (isinstance(k, str) and k.startswith("!"))}
        model = Model(visible)
        # soundness net: the model must satisfy the ORIGINAL constraints
        # (one shared node cache — sibling constraints share their cone)
        values: Dict = {}
        for term in prep.original:
            if evaluate_shared(term, model.assignment, values) is not True:
                raise SolverInternalError(
                    f"model validation failed on {terms.term_to_str(term)}"
                )
        return model

    def model(self) -> Model:
        if self._model is None:
            raise ValueError("no model available (last check not sat)")
        return self._model


class Optimize(Solver):
    """Lexicographic minimize/maximize via MSB-first bit fixing.

    The problem is lowered and blasted ONCE; each bit probe is a SAT call
    under assumptions on the shared CNF (no re-lowering/re-blasting).

    Past OPTIMIZE_CLAUSE_CAP clauses, per-bit probing switches to GROUPED
    prefix fixing (round-4 verdict item 8 — the old behavior skipped
    minimization entirely there, leaving unminimized exploit blobs on
    exactly the heaviest contracts): the longest MSB prefix of the
    objective is pinned to the preferred value in ONE conflict-budgeted
    solve, halving the span on failure — ~log(bits) probes instead of one
    per bit, each time-boxed, so calldatasize/callvalue still collapse to
    small values on ~1M-clause confirmation queries. The reference always
    minimizes (analysis/solver.py:217-257)."""

    OPTIMIZE_CLAUSE_CAP = 200_000
    BIG_PROBE_CONFLICTS = 50_000   # per grouped probe on heavy instances
    BIG_PROBE_DEADLINE_S = 10.0    # total minimization box past the cap

    def __init__(self, timeout: Optional[float] = None):
        super().__init__(timeout)
        self._objectives: List[Tuple[str, Term]] = []

    def minimize(self, expression) -> None:
        self._objectives.append(("min", _raw(expression)))

    def maximize(self, expression) -> None:
        self._objectives.append(("max", _raw(expression)))

    def _check(self, extra: List[Term]) -> str:
        if not self._objectives:
            return super()._check(extra)
        self._model = None
        prep = self._prepare(extra, [obj for _, obj in self._objectives])
        if prep.trivial is not None:
            if prep.trivial == SAT:
                self._model = self._trivial_model(prep)
            return prep.trivial
        self.last_prep = prep  # query-capture hook (support/model.py)
        status = self._solve_prepared(prep)
        if status != SAT:
            return status
        big = len(prep.clauses) > self.OPTIMIZE_CLAUSE_CAP
        box = (
            min(self.timeout or self.BIG_PROBE_DEADLINE_S,
                self.BIG_PROBE_DEADLINE_S)
            if big else (self.timeout or 10.0)
        )
        deadline = time.monotonic() + box
        probe = self._optimize_one_grouped if big else self._optimize_one
        assumptions: List[int] = []  # DIMACS lits, grown lexicographically
        for (direction, _), bit_lits in zip(self._objectives, prep.objective_bits):
            if time.monotonic() > deadline:
                break
            probe(direction, bit_lits, prep, assumptions, deadline)
        return SAT

    def _optimize_one(self, direction: str, bit_lits: List[int],
                      prep: "_Prepared", assumptions: List[int],
                      deadline: float) -> None:
        """Fix objective bits MSB-first, appending to `assumptions` in place.

        `bit_lits` are AIG literals (LSB-first); constant bits are skipped,
        the rest are probed as SAT assumptions over the shared CNF. The best
        model found is kept in self._model."""
        prefer_negative = direction == "min"
        dense = prep.var_dense
        for aig_lit in reversed(bit_lits):  # MSB first
            if time.monotonic() > deadline:
                return
            var = dense.get(aig_lit >> 1)
            if not var:
                continue  # constant bit (or outside the cone): undecidable
            dimacs = -var if aig_lit & 1 else var
            trial = -dimacs if prefer_negative else dimacs
            # witnessed-bit skip: if the current model already has this bit at
            # the preferred value, it witnesses SAT of (assumptions + trial) —
            # adopt the assumption without a solver call
            if prep.last_bits is not None:
                bit_value = prep.last_bits[var] ^ bool(aig_lit & 1)
                if bit_value == (not prefer_negative):
                    assumptions.append(trial)
                    continue
            saved = self.timeout
            self.timeout = max(0.25, deadline - time.monotonic())
            try:
                status = self._solve_prepared_keep_model(
                    prep, assumptions + [trial])
            finally:
                self.timeout = saved
            if status == SAT:
                assumptions.append(trial)
            elif status == UNSAT:
                assumptions.append(-trial)
            else:
                return

    def _optimize_one_grouped(self, direction: str, bit_lits: List[int],
                              prep: "_Prepared", assumptions: List[int],
                              deadline: float) -> None:
        """Heavy-instance variant: pin the longest MSB prefix per solve.

        Bits the current model already has at the preferred value are
        adopted free; past the first wrong bit, a whole remaining-suffix
        group is tried as one conflict-budgeted assumption solve, halving
        the span on UNSAT/UNKNOWN. A span-1 UNSAT fixes the bit at its
        non-preferred value (sound: budget overruns report UNKNOWN, never
        UNSAT) and the walk continues."""
        prefer_negative = direction == "min"
        dense = prep.var_dense
        trials: List[Tuple[int, int, int]] = []  # (trial lit, var, aig lit)
        for aig_lit in reversed(bit_lits):  # MSB first
            var = dense.get(aig_lit >> 1)
            if not var:
                continue  # constant bit (or outside the cone): undecidable
            dimacs = -var if aig_lit & 1 else var
            trials.append((-dimacs if prefer_negative else dimacs, var, aig_lit))
        total = len(trials)
        index = 0
        saved_timeout, saved_budget = self.timeout, self.conflict_budget
        self.conflict_budget = self.BIG_PROBE_CONFLICTS
        try:
            while index < total and time.monotonic() < deadline:
                trial, var, aig_lit = trials[index]
                if prep.last_bits is not None:
                    bit_value = prep.last_bits[var] ^ bool(aig_lit & 1)
                    if bit_value == (not prefer_negative):
                        assumptions.append(trial)
                        index += 1
                        continue
                span = total - index
                advanced = False
                while span >= 1 and time.monotonic() < deadline:
                    group = [t for t, _, _ in trials[index:index + span]]
                    self.timeout = max(
                        0.25, min(5.0, deadline - time.monotonic()))
                    status = self._solve_prepared_keep_model(
                        prep, assumptions + group)
                    if status == SAT:
                        assumptions.extend(group)
                        index += span
                        advanced = True
                        break
                    if span == 1:
                        if status == UNSAT:
                            assumptions.append(-group[0])
                            index += 1
                            advanced = True
                        break  # UNKNOWN at span 1: no progress possible
                    span //= 2
                if not advanced:
                    return
        finally:
            self.timeout = saved_timeout
            self.conflict_budget = saved_budget

    def _solve_prepared_keep_model(self, prep, assumptions) -> str:
        """Like _solve_prepared but keeps the previous model on non-SAT."""
        saved = self._model
        status = self._solve_prepared(prep, assumptions)
        if status != SAT:
            self._model = saved
        return status
