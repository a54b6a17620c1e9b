"""Incremental cross-query preparation: prefix-memoized word-level
pipeline (Solver._prepare).

The engine issues thousands of sibling solver queries per analyze run,
and path constraints grow monotonically: query N+1's constraint list is
query N's plus a handful of new terms. The full prepare pipeline
(simplify -> substitution fixpoint -> lowering -> blast) nevertheless
re-walks the ENTIRE list every time. This module memoizes the word-level
phase across queries, exploiting that terms are hash-consed
(smt/terms.py) so id-keyed memo tables are sound until the intern table
generation bumps:

  simplify memo   `simplify_expr` per interned term id, with the walk
                  stopping at already-simplified subterms — a suffix
                  term costs O(new nodes), a repeated term costs O(1)
                  (counted `prepare_incremental_hits`).
  prefix memo     each prepared query snapshots its word-level state —
                  residual constraints, substitution list, the live
                  `_Lowering` (side constraints undrained) and the
                  lowered prefix — keyed on the tuple of asserted term
                  ids. A child query whose assertion list extends a
                  snapshot resumes from it and only substitutes/lowers
                  its suffix (counted `prepare_prefix_resumes` + a
                  suffix-length histogram).
  free-symbols    `terms.free_symbols` per root term id (the per-query
                  prep.symbols scan re-walks the whole constraint DAG
                  otherwise).

Correctness guard: a suffix term that introduces a new `sym == rhs`
definition over a symbol the prefix residual still references — or a
narrowing bound (`x < c`) on such a symbol — would substitute back
through the already-lowered prefix. Those queries fall back to the full
pipeline (counted `prepare_prefix_fallbacks`). Suffix-only definitions
and bounds (symbols the prefix never saw) are handled incrementally,
mirroring `propagate_equalities` / `narrow_bounded_symbols` term-for-term
so the resumed pipeline emits the IDENTICAL lowered list, side-constraint
order and fresh-symbol numbering the full pipeline would — the CNF, the
model bits and the reconstructed model are byte-identical on vs off.

Invalidation: every memo keys on `terms.Term.generation` and clears when
the intern table is rebuilt (ids would dangle), exactly like the global
blaster; `support/model.clear_caches` resets it explicitly. Gated by
`args.no_incremental_prep` / MYTHRIL_GPU_INCR_PREP on top of the
preanalysis master switch.

A copy of mythril_tpu.smt.solver.incremental with the import root and the
knob prefix changed; the per-session snapshot eviction of the JAX
package's serve daemon is not ported.
"""

import os
from collections import OrderedDict
from typing import Dict, List, Optional

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

# memo caps: cleared wholesale on overflow (per-entry eviction would
# break the pinning argument — see _State docstring)
SIMPLIFY_MEMO_MAX = 1_000_000
FREE_SYMBOLS_MEMO_MAX = 200_000
PREFIX_MEMO_MAX = 32
# snapshots past this many lowering-cache entries are not recorded: the
# clone cost and retained memory would outweigh the resume win
SNAPSHOT_NODE_CAP = 200_000


def _prefix_memo_max() -> int:
    """Live prefix-memo cap: MYTHRIL_GPU_PREFIX_MEMO_MAX (env or tuned
    profile) over PREFIX_MEMO_MAX, read at use so a profile applied at
    start-up reaches it."""
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_GPU_PREFIX_MEMO_MAX", PREFIX_MEMO_MAX)


def _snapshot_node_cap() -> int:
    """Live snapshot-size cap: MYTHRIL_GPU_SNAPSHOT_NODE_CAP (env or tuned
    profile) over SNAPSHOT_NODE_CAP."""
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_GPU_SNAPSHOT_NODE_CAP", SNAPSHOT_NODE_CAP)

# mirrors propagate_equalities' max_rounds for the suffix fixpoint
SUFFIX_ROUNDS = 8


def enabled() -> bool:
    """The incremental layer rides the preanalysis subsystem: on by
    default whenever preanalysis is, `args.no_incremental_prep` turns just
    this layer off, and MYTHRIL_GPU_INCR_PREP=0/1 overrides the flag
    either way (the preanalysis master switch still gates everything)."""
    from mythril_tpu_torch import preanalysis

    if not preanalysis.enabled():
        return False
    env = os.environ.get("MYTHRIL_GPU_INCR_PREP", "")
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_incremental_prep", False)


class PrefixSnapshot:
    """Word-level prepare state at one assertion-list prefix.

    Self-contained for pinning: `key_terms` pins the key ids, `residual`
    pins every term the lowering cache keys can name (a resumed child's
    residual extends its parent's, so the containment is inductive), and
    the lowering is stored with its side constraints UNDRAINED so a
    resume reproduces the full pipeline's root ordering exactly."""

    __slots__ = ("key_terms", "residual", "substitutions", "taken_equal",
                 "taken_narrow", "free_names", "lowering", "lowered")

    def __init__(self, key_terms, residual, substitutions, taken_equal,
                 taken_narrow, free_names, lowering, lowered):
        self.key_terms = key_terms
        self.residual = residual
        self.substitutions = substitutions
        self.taken_equal = taken_equal
        self.taken_narrow = taken_narrow
        self.free_names = free_names
        self.lowering = lowering
        self.lowered = lowered


class Resume:
    """A prepare resumed (or statically settled) from a prefix snapshot."""

    __slots__ = ("unsat", "residual", "suffix_residual", "substitutions",
                 "taken_equal", "taken_narrow", "lowering",
                 "lowered_prefix")

    def __init__(self, unsat=False, residual=None, suffix_residual=None,
                 substitutions=None, taken_equal=None, taken_narrow=None,
                 lowering=None, lowered_prefix=None):
        self.unsat = unsat
        self.residual = residual
        self.suffix_residual = suffix_residual
        self.substitutions = substitutions
        self.taken_equal = taken_equal
        self.taken_narrow = taken_narrow
        self.lowering = lowering
        self.lowered_prefix = lowered_prefix


class _State:
    """All cross-query memo state for one term-table generation.

    Memo keys are `id(term)`; every key's term is pinned (a reused id
    after garbage collection would alias another term's entry, the same
    hazard the Blaster pins against). Simplify/free-symbol memos pin
    their walk roots — interior keys stay alive through the roots'
    children tuples. Prefix snapshots pin themselves (see
    PrefixSnapshot)."""

    __slots__ = ("generation", "simp_memo", "simp_pinned", "free_memo",
                 "free_pinned", "prefix_memo", "lengths", "origins")

    def __init__(self, generation: int):
        self.generation = generation
        self.simp_memo: Dict[int, terms.Term] = {}
        self.simp_pinned: List[terms.Term] = []
        self.free_memo: Dict[int, frozenset] = {}
        self.free_pinned: List[terms.Term] = []
        self.prefix_memo: "OrderedDict" = OrderedDict()
        self.lengths: Dict[int, int] = {}  # key length -> live snapshots
        # snapshot key -> origin tag of the analysis that recorded it
        # (None outside the interleave coordinator): session-scoped
        # eviction (evict_session) drops one tenant's snapshots alone
        self.origins: Dict[tuple, Optional[str]] = {}

    def drop_snapshot(self, key: tuple) -> None:
        self.prefix_memo.pop(key, None)
        self.origins.pop(key, None)
        live = self.lengths.get(len(key), 0) - 1
        if live <= 0:
            self.lengths.pop(len(key), None)
        else:
            self.lengths[len(key)] = live

    def clear_simplify(self) -> None:
        self.simp_memo = {}
        self.simp_pinned = []

    def clear_free(self) -> None:
        self.free_memo = {}
        self.free_pinned = []


_state_obj: Optional[_State] = None


def _state() -> _State:
    global _state_obj
    generation = terms.Term.generation
    if _state_obj is None or _state_obj.generation != generation:
        _state_obj = _State(generation)
    return _state_obj


def reset() -> None:
    """Drop every memo (clear_caches / testing hook)."""
    global _state_obj
    _state_obj = None


def evict_session(session: str) -> int:
    """Drop one session's prefix snapshots (those recorded while one of
    its origins held the baton; mythril_tpu/smt/solver/incremental.py:208),
    leaving every other tenant's snapshots and the id-keyed simplify and
    free-symbol memos. Returns the number of snapshots dropped."""
    state = _state_obj
    if state is None:
        return 0
    from mythril_tpu_torch.service.tenancy import origin_in_session

    doomed = [key for key, origin in list(state.origins.items())
              if origin is not None and origin_in_session(origin, session)]
    for key in doomed:
        state.drop_snapshot(key)
    return len(doomed)


def snapshot_count(session: Optional[str] = None) -> int:
    """Live prefix snapshots, or only those a session recorded (:225)."""
    state = _state_obj
    if state is None:
        return 0
    if session is None:
        return len(state.prefix_memo)
    from mythril_tpu_torch.service.tenancy import origin_in_session

    return sum(1 for origin in list(state.origins.values())
               if origin is not None and origin_in_session(origin, session))


# -- memoized simplify --------------------------------------------------------


def simplify_cached(term: terms.Term) -> terms.Term:
    """terms.simplify_expr with a cross-query per-node memo: the walk
    stops at any subterm simplified by an earlier query, so sibling
    queries pay only for their genuinely new nodes."""
    state = _state()
    memo = state.simp_memo
    hit = memo.get(id(term))
    if hit is not None:
        SolverStatistics().add_prepare_simplify_hits()
        return hit
    if len(memo) > SIMPLIFY_MEMO_MAX:
        state.clear_simplify()
        memo = state.simp_memo
    stack = [(term, False)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in memo:
            continue
        if not expanded:
            stack.append((node, True))
            for child in node.children:
                if id(child) not in memo:
                    stack.append((child, False))
            continue
        if not node.children:
            result = node
        else:
            new_children = [memo[id(c)] for c in node.children]
            if all(a is b for a, b in zip(new_children, node.children)):
                result = node
            else:
                result = terms.rebuild(node, new_children)
        memo[id(node)] = result
        state.simp_pinned.append(node)
    return memo[id(term)]


def free_symbols_cached(roots) -> set:
    """Union of terms.free_symbols keys over `roots`, memoized per root
    term id (repeated constraint roots dominate sibling queries)."""
    state = _state()
    memo = state.free_memo
    out = set()
    for root in roots:
        hit = memo.get(id(root))
        if hit is None:
            if len(memo) > FREE_SYMBOLS_MEMO_MAX:
                state.clear_free()
                memo = state.free_memo
            hit = frozenset(terms.free_symbols([root]))
            memo[id(root)] = hit
            state.free_pinned.append(root)
        out |= hit
    return out


# -- prefix memo --------------------------------------------------------------


def record(asserted, residual, substitutions, taken_equal, taken_narrow,
           lowering, lowered) -> None:
    """Snapshot a prepared query's word-level state under its assertion
    ids so a child query can resume from it. Must be called BEFORE the
    lowering's side constraints are drained (the snapshot clones the
    live object)."""
    if not asserted:
        return
    if len(lowering.cache) > _snapshot_node_cap():
        return
    state = _state()
    key = tuple(id(t) for t in asserted)
    if key in state.prefix_memo:
        state.prefix_memo.move_to_end(key)
        return
    free_names = frozenset(
        name for name, _sort in free_symbols_cached(residual))
    from mythril_tpu_torch.service.interleave import current_origin

    state.origins[key] = current_origin()
    state.prefix_memo[key] = PrefixSnapshot(
        key_terms=tuple(asserted),
        residual=tuple(residual),
        substitutions=tuple(substitutions),
        taken_equal=frozenset(taken_equal),
        taken_narrow=frozenset(taken_narrow),
        free_names=free_names,
        lowering=lowering.clone(),
        lowered=tuple(lowered),
    )
    state.lengths[len(key)] = state.lengths.get(len(key), 0) + 1
    while len(state.prefix_memo) > _prefix_memo_max():
        old_key, _old = state.prefix_memo.popitem(last=False)
        state.origins.pop(old_key, None)
        live = state.lengths.get(len(old_key), 0) - 1
        if live <= 0:
            state.lengths.pop(len(old_key), None)
        else:
            state.lengths[len(old_key)] = live


def try_resume(asserted) -> Optional[Resume]:
    """Resume `asserted`'s prepare from the longest memoized prefix, or
    None (no snapshot, or the guard forced a full-pipeline fallback —
    counted). The returned lowering is a private clone the caller may
    mutate."""
    state = _state()
    if not state.prefix_memo or not asserted:
        return None
    ids = tuple(id(t) for t in asserted)
    snap = None
    prefix_len = 0
    for length in sorted(state.lengths, reverse=True):
        if length > len(ids):
            continue
        candidate = state.prefix_memo.get(ids[:length])
        if candidate is not None:
            state.prefix_memo.move_to_end(ids[:length])
            snap, prefix_len = candidate, length
            break
    if snap is None:
        return None
    stats = SolverStatistics()
    suffix = asserted[prefix_len:]
    from mythril_tpu_torch.observe.tracer import span as trace_span

    with trace_span("solver.prefix_resume", cat="solver",
                    prefix=prefix_len, suffix=len(suffix)) as sp:
        resume = _resume_from(snap, suffix)
        if resume is None:
            sp.set(fallback=True)
            stats.add_prefix_fallback()
            return None
        stats.add_prefix_resume(len(suffix))
    return resume


def _narrow_candidate(term) -> Optional[str]:
    """Name of the symbol `term` would narrow (mirrors the eligibility
    filter of frontend.narrow_bounded_symbols), or None."""
    if term.op not in ("bvult", "bvule"):
        return None
    lhs, rhs = term.children
    if lhs.op != "sym" or not isinstance(lhs.sort, int):
        return None
    if not (rhs.is_const and isinstance(rhs.value, int)):
        return None
    bound = rhs.value - 1 if term.op == "bvult" else rhs.value
    if bound < 0:
        return None
    if max(1, bound.bit_length()) >= lhs.sort:
        return None
    return lhs.params[0]


def _substitute_fixpoint(term, mapping, frontend):
    """Apply a substitution map to fixpoint — the memoized-simplify twin
    of frontend._substitute_simplify_fixpoint (definition chains leave
    bound symbols inside verbatim-inserted rhs subtrees; both pipelines
    must resolve them identically)."""
    if not mapping:
        return term
    for _ in range(len(mapping) + 1):
        new = simplify_cached(frontend._substitute([term], mapping)[0])
        if new is term:
            break
        term = new
    return term


def _resume_from(snap: PrefixSnapshot, suffix) -> Optional[Resume]:
    """Run the word-level pipeline over `suffix` only, on top of `snap`.

    Returns None to force the full-pipeline fallback whenever the suffix
    would have changed how the prefix itself was processed:

      - a new `sym == rhs` definition over a symbol the prefix residual
        still references (it would substitute back through already-
        lowered terms), or over a symbol the prefix NARROWED (the full
        pipeline would have bound it before narrowing ever ran);
      - a narrowing bound on a symbol the prefix residual references or
        already narrowed (the full pipeline computes the min width over
        ALL bounds and rewrites every use site).

    The raw-term guard matters: the prefix's substitutions rewrite
    `x` into `zext(!narrow!x)`, which MASKS the binding/bound shape the
    full pipeline would have seen — so narrowed names are checked on the
    raw suffix terms before any substitution."""
    from mythril_tpu_torch.smt.solver import frontend

    taken_equal = set(snap.taken_equal)
    taken_narrow = snap.taken_narrow
    blocked = snap.free_names

    for term in suffix:
        binding = frontend._extract_binding(term, taken_equal)
        if binding is not None and binding[0] in taken_narrow:
            return None
        name = _narrow_candidate(term)
        if name is not None and name in taken_narrow:
            return None

    mapping = dict(snap.substitutions)
    local_subs = []
    work = []
    for term in suffix:
        term = _substitute_fixpoint(term, mapping, frontend)
        if term.is_const:
            if term.value is False:
                return Resume(unsat=True)
            continue
        work.append(term)

    # suffix-local equality propagation, mirroring propagate_equalities:
    # bindings over symbols the prefix never saw are safe (nothing to
    # substitute back through), everything else falls back
    residual_suffix = work
    for _ in range(SUFFIX_ROUNDS):
        found: Dict[str, terms.Term] = {}
        remaining = []
        for term in work:
            if found:
                term = _substitute_fixpoint(term, found, frontend)
                if term.is_const:
                    if term.value is False:
                        return Resume(unsat=True)
                    continue
            binding = frontend._extract_binding(term, taken_equal)
            if binding is not None:
                name, rhs = binding
                if name in blocked or name in taken_narrow:
                    return None  # substitutes back through the prefix
                taken_equal.add(name)
                found[name] = rhs
                local_subs.append((name, rhs))
                continue
            remaining.append(term)
        if not found:
            residual_suffix = remaining
            break
        work = []
        for term in remaining:
            term = _substitute_fixpoint(term, found, frontend)
            if term.is_const:
                if term.value is False:
                    return Resume(unsat=True)
                continue
            work.append(term)
        residual_suffix = work

    # suffix-local narrowing: only for symbols the prefix never saw
    taken_all = taken_equal | set(taken_narrow)
    candidates = {_narrow_candidate(t) for t in residual_suffix}
    candidates.discard(None)
    if (candidates - taken_all) & blocked:
        return None  # the bound would narrow prefix use sites
    residual_suffix, narrow_subs = frontend.narrow_bounded_symbols(
        residual_suffix, taken_all)
    if residual_suffix is None:
        return Resume(unsat=True)

    return Resume(
        unsat=False,
        residual=list(snap.residual) + residual_suffix,
        suffix_residual=residual_suffix,
        substitutions=(list(snap.substitutions) + local_subs
                       + list(narrow_subs)),
        taken_equal=taken_equal,
        taken_narrow=set(taken_narrow) | {n for n, _ in narrow_subs},
        lowering=snap.lowering.clone(),
        lowered_prefix=list(snap.lowered),
    )
