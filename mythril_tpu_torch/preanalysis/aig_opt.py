"""AIG structural analysis & rewriting ahead of CNF emission.

The blasted AIG the device circuit kernel simulates — and the CNF every
solver path consumes — is produced by construction-time folding only:
the shared global blaster strashes gates as they are BUILT, but nothing
ever re-analyzes a finished cone. Asserted roots carry exploitable
static structure: a root is a literal that must be TRUE, so root
conjunction trees decompose into forced fanin literals, forced literals
pin circuit inputs, and pinned inputs collapse the arithmetic cones that
share them (selector bytes pinning a comparison chain is the canonical
case). This module runs once per prepared instance (the TVM pattern of
graph-level rewriting ahead of device codegen) and rewrites the cone
into a fresh minimized AIG:

  constant sweep   every root literal is a forced constant; forced TRUE
                   AND gates decompose into forced fanins to a fixpoint,
                   forced values substitute as structural constants at
                   every use site, and dead fanout cones are never
                   rebuilt. A root forced both ways is a statically
                   proven UNSAT — counted, but the verdict still settles
                   through the CDCL so the detection-path crosscheck
                   policy is never bypassed (the rewrite emits a
                   one-variable contradiction the CDCL re-derives in
                   microseconds).
  strashing        the rebuild re-hashes every surviving gate through a
                   SESSION structural-hash table shared across sibling
                   queries (_StrashSession): gates that became identical
                   under the swept constants merge (the build-time strash
                   cannot see these: the originals differed structurally
                   when they were created), and gates a sibling query
                   already swept/strashed are reused literal-for-literal
                   instead of rebuilding against a fresh table (counted
                   strash_xquery_merges; a per-gate rewrite memo
                   short-circuits whole forced-constant-free sub-cones).
                   Double negations cancel on the literal encoding.

Soundness: the rewrite is equisatisfiable with a recorded reconstruction
map (`input_map`, original input var -> rewritten var): swept inputs are
kept as variables pinned by unit roots, so every model of the rewritten
instance assigns them and Solver._reconstruct — which validates every
model against the ORIGINAL word-level constraints — accepts the
recomposed assignment unchanged. Inputs whose every use folded away are
genuine don't-cares and take the reconstruction default (False).

Everything here is total: any unexpected shape degrades to "no change"
(None), never to a wrong cone. Gated by `args.no_aig_opt` /
MYTHRIL_GPU_AIG_OPT on top of the preanalysis master switch.

Ported from mythril_tpu.preanalysis.aig_opt with the import root and the
knob prefix changed, and its cone passes in native code
(csrc/aig_passes.cpp, through aig_native): the source cone, the sweep,
the liveness, and the rewritten cone's count and components. Given the
same AIG and roots, both packages emit the same rewritten gates, roots
and input map.
"""

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from mythril_tpu_torch.preanalysis import aig_native
from mythril_tpu_torch.smt.bitblast import AIG, FALSE_LIT, TRUE_LIT

# cones past this many variables skip the rewrite: the rebuild steps
# through the cone in Python, and cones this size are dominated by
# CDCL/device wall anyway (the CNF preprocessor has the same shape of cap
# for the same reason)
AIG_OPT_NODE_CAP = 150_000

_CACHE_MAX = 256
_NOT_APPLICABLE = object()
# (global aig uid, roots tuple) -> AIGOptResult | _NOT_APPLICABLE. Sound
# key: the shared blaster AIG is append-only, so a root literal's cone
# never changes once created. Caching matters doubly here: sibling
# analyze queries re-blast into memoized terms (same roots), and the
# cached result's session AIG keeps a stable uid so the device backend's
# pack/pad caches keep hitting across calls.
_cache: "OrderedDict" = OrderedDict()


# rewrites accumulate in ONE session AIG per source AIG; past this many
# variables the session resets (bounds memory, mirrors BLASTER_VAR_CAP)
SESSION_VAR_CAP = 4_000_000


class _StrashSession:
    """Session strash/rewrite table shared across sibling queries.

    Every cone rewritten from the same source AIG rebuilds into ONE
    shared append-only session AIG, so the strash table — and a per-gate
    rewrite memo for gates whose fanin cone carries no query-specific
    forced constant — persist across sibling queries: a sub-cone swept
    and strashed by query N is reused literal-for-literal by query N+1
    (counted `strash_xquery_merges`), instead of each cone rewriting
    against a fresh table.

    Sound because the source AIG is append-only (an original var's gate
    never changes) and `input_vars`/`clean_memo` key on original vars:
    a memo entry is only consulted when the current query proves the
    gate's whole fanin cone forced-constant-free (the source pass's PURE
    kind, aig_native), which is exactly the condition under which the
    rebuild is query-independent. A new source AIG uid (term-generation
    bump rebuilds the global blaster) or the var cap retires the session;
    results cached against a retired session stay valid — they hold
    their own reference to its (still append-only) AIG."""

    __slots__ = ("source_uid", "aig", "input_vars", "clean_memo")

    def __init__(self, source_uid):
        self.source_uid = source_uid
        self.aig = AIG()
        self.aig._aig_opt_cone = True  # partition-eligible (aig_partition)
        # indexed by source var, 0 where none is stored: an input's
        # session var (never 0), and a clean gate's session literal plus
        # one. Zeroed arrays come from the allocator untouched, so a
        # throwaway session (the incremental layer off) costs no pass
        # over the source AIG
        self.input_vars = np.zeros(1024, dtype=np.int32)
        self.clean_memo = np.zeros(1024, dtype=np.int32)

    def tables(self, num_vars: int):
        """(input_vars, clean_memo), grown by doubling to cover source vars
        up to `num_vars` (the source AIG only grows)."""
        size = len(self.clean_memo)
        if size <= num_vars:
            while size <= num_vars:
                size *= 2
            for name in ("input_vars", "clean_memo"):
                grown = np.zeros(size, dtype=np.int32)
                old = getattr(self, name)
                grown[:len(old)] = old
                setattr(self, name, grown)
        return self.input_vars, self.clean_memo


_session: Optional[_StrashSession] = None


def _get_session(aig: AIG) -> _StrashSession:
    global _session
    uid = getattr(aig, "uid", id(aig))
    from mythril_tpu_torch.smt.solver import incremental

    if not incremental.enabled():
        # cross-query sharing rides the incremental-prep switch: with the
        # layer off every rewrite gets a private throwaway table (the
        # per-query behavior), so switching the layer off isolates all
        # of it
        return _StrashSession(uid)
    if (_session is None or _session.source_uid != uid
            or _session.aig.num_vars > SESSION_VAR_CAP):
        _session = _StrashSession(uid)
    return _session


# -- root-forcing-deferred sweep (fork bundles) ------------------------------
#
# The sides of one batched-JUMPI fork pair share every base constraint
# and differ by exactly the fork literal and its negation. The normal
# sweep FORCES every root — so side A rewrites its shared base cone
# under "fork literal = TRUE" and side B under "= FALSE", the rebuilt
# base roots diverge structurally, and the router's shared-cone pair
# packing (_pack_fork_pair: "root sets differ by exactly {L, L^1}")
# misses on exactly the traffic it was built for. Inside this scope the
# sweep DEFERS root forcing entirely: the cone rebuilds through the
# session strash table with every root kept as a plain root, so both
# sides land in ONE session AIG with identical base roots (the second
# side's rebuild is all clean-memo hits) and the diff is the fork
# literal pair — the CDCL re-derives the forced constants by unit
# propagation in microseconds, which is why deferring is cheap.
# Threadlocal: a prepare scope belongs to the thread that opened it.

_defer_tls = threading.local()


@contextlib.contextmanager
def deferred_forcing():
    """Prepare-scope marker for fork-bundle queries: optimize_roots runs
    with root forcing deferred (see block comment above)."""
    depth = getattr(_defer_tls, "depth", 0)
    _defer_tls.depth = depth + 1
    try:
        yield
    finally:
        _defer_tls.depth = depth


def defer_active() -> bool:
    """True inside a deferred_forcing scope."""
    return bool(getattr(_defer_tls, "depth", 0))


def enabled() -> bool:
    """The AIG layer rides the preanalysis subsystem: it is on by default
    whenever preanalysis is, `--no-aig-opt` turns just this layer off, and
    MYTHRIL_GPU_AIG_OPT=0/1 overrides the flag either way (the preanalysis
    master switch still gates everything)."""
    from mythril_tpu_torch import preanalysis

    if not preanalysis.enabled():
        return False
    env = os.environ.get("MYTHRIL_GPU_AIG_OPT", "")
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_aig_opt", False)


class ComposedDense:
    """Original global AIG var -> dense CNF var of the REWRITTEN instance,
    composed through the rewrite's input map. Drop-in for the DenseMap
    protocol Solver._reconstruct consumes; gate vars and dropped inputs
    resolve to None (reconstruction's standard outside-the-cone default)."""

    __slots__ = ("input_map", "dense")

    def __init__(self, input_map: Dict[int, int], dense):
        self.input_map = input_map
        self.dense = dense

    def get(self, var: int, default=None):
        new_var = self.input_map.get(var)
        if new_var is None:
            return default
        return self.dense.get(new_var, default)


class AIGOptResult:
    __slots__ = ("aig", "roots", "input_map", "nodes_before", "nodes_after",
                 "strash_merges", "const_folds", "trivially_unsat",
                 "xquery_merges", "visited", "root_labels")

    def __init__(self, aig, roots, input_map, nodes_before, nodes_after,
                 strash_merges, const_folds, trivially_unsat,
                 xquery_merges=0, visited=0, root_labels=None):
        self.aig = aig                # shared session AIG (cone of roots)
        self.roots = roots            # root literals in the new numbering
        self.input_map = input_map    # orig input var -> new var
        self.nodes_before = nodes_before
        self.nodes_after = nodes_after
        self.strash_merges = strash_merges
        self.const_folds = const_folds
        self.trivially_unsat = trivially_unsat
        # gates reused from SIBLING queries via the session strash table
        self.xquery_merges = xquery_merges
        # the cone vars the Python rebuild loop stepped through
        self.visited = visited
        # per root its component in the rewritten cone, from the native
        # pass that counted nodes_after (aig_partition reuses it); None on
        # a trivially UNSAT result
        self.root_labels = root_labels


def _trivially_unsat_result(nodes_before: int, const_folds: int,
                            strash_merges: int = 0,
                            visited: int = 0) -> AIGOptResult:
    """A statically proven UNSAT root set rewrites to a one-variable
    contradiction: two unit roots the CDCL refutes by propagation in
    microseconds — through the normal solve path, so the detection-path
    UNSAT crosscheck policy applies exactly as it would have (a static
    verdict must never silently bypass that soundness net)."""
    new_aig = AIG()
    var = new_aig.new_var()
    new_aig._aig_opt_cone = True
    return AIGOptResult(new_aig, [2 * var, 2 * var + 1], {},
                        nodes_before, 0, strash_merges, const_folds,
                        trivially_unsat=True, visited=visited)


class _Rebuild:
    """One rewrite's forward rebuild into the session AIG: forced
    constants substitute at every use site (`new_lit`, source var -> new
    literal), surviving gates re-hash through the SESSION strash table —
    gates a sibling query already rebuilt merge instead of rebuilding —
    and each merge is counted by what made it."""

    __slots__ = ("new_aig", "session_start", "gate_lhs", "gate_rhs",
                 "input_vars", "memo", "new_lit", "input_map", "new_roots",
                 "strash_merges", "xquery_merges", "rebuild_folds")

    def __init__(self, session: _StrashSession, aig: AIG):
        self.input_vars, self.memo = session.tables(aig.num_vars)
        self.new_aig = session.aig
        # watermark: older vars are sibling work
        self.session_start = self.new_aig.num_vars
        self.gate_lhs, self.gate_rhs = aig.gate_lhs, aig.gate_rhs
        self.new_lit: Dict[int, int] = {0: FALSE_LIT}
        self.input_map: Dict[int, int] = {}
        self.new_roots: List[int] = []
        self.strash_merges = 0
        self.xquery_merges = 0
        self.rebuild_folds = 0

    def input(self, var: int) -> int:
        """The session var of source input `var`, created on its first
        use in the session: sibling queries share it."""
        new_var = int(self.input_vars[var])
        if not new_var:
            new_var = self.new_aig.new_var()
            self.input_vars[var] = new_var
        self.input_map[var] = new_var
        return new_var

    def gate(self, var: int) -> int:
        """Source gate `var` rebuilt over its substituted fanins."""
        new_lit = self.new_lit
        lhs, rhs = self.gate_lhs[var], self.gate_rhs[var]
        a = new_lit[lhs >> 1] ^ (lhs & 1)
        b = new_lit[rhs >> 1] ^ (rhs & 1)
        new_aig = self.new_aig
        before = new_aig.num_vars
        lit = new_aig.and_gate(a, b)
        if new_aig.num_vars == before:
            if lit in (TRUE_LIT, FALSE_LIT) or (lit >> 1) in (a >> 1, b >> 1):
                self.rebuild_folds += 1  # collapsed by a swept constant/absorption
            elif (lit >> 1) <= self.session_start:
                self.xquery_merges += 1  # strash hit on a sibling query's gate
            else:
                self.strash_merges += 1  # merged with an already-rebuilt gate
        return lit


def _deferred_without_session(force_roots: bool) -> bool:
    """Deferred forcing needs the shared session: without it each side
    would rebuild into a private throwaway AIG and the sides could never
    pair, so the ORIGINAL aig/roots are kept (both sides share the source
    AIG, so the pair still packs there)."""
    if force_roots:
        return False
    from mythril_tpu_torch.smt.solver import incremental

    return not incremental.enabled()


def optimize_roots(aig: AIG, roots: List[int],
                   force_roots: bool = True) -> Optional[AIGOptResult]:
    """Rewrite the cone of `roots` (sweep + strash); None when nothing
    applies (constant-only roots, oversize cone, or any unexpected shape
    — always degrade to "no change", never a wrong cone).

    With `force_roots=False` (fork-bundle queries under
    deferred_forcing) the constant sweep is DEFERRED: no root is
    propagated as a forced constant — the cone rebuilds through the
    session strash table with every root kept as a plain root, so the
    two sides of a fork pair produce identical base roots in one shared
    session AIG and the router's shared-cone pair packing hits. The
    rewrite is returned even when structurally unchanged: symmetry
    between the sides is the point (one side rewritten and the other
    degraded to the original AIG could never pair).

    The cone passes (the cone, the sweep, the liveness, the rewritten
    cone's count and components) run in native code (aig_native), and
    the rebuild loop steps only through the vars that create or look up
    something."""
    live_roots = []
    for lit in roots:
        if lit == TRUE_LIT:
            continue  # vacuous root
        if lit == FALSE_LIT:
            return _trivially_unsat_result(0, 0)
        live_roots.append(lit)
    if not live_roots:
        return None
    meta, cone, kinds = aig_native.source_pass(
        aig, live_roots, force_roots, AIG_OPT_NODE_CAP)
    status, _count, nodes_before, forced, pinned, folds = meta
    if status == aig_native.OVER_CAP or _deferred_without_session(
            force_roots):
        return None
    if status == aig_native.CONTRADICTION:
        return _trivially_unsat_result(nodes_before, folds)

    rebuild = _Rebuild(_get_session(aig), aig)
    new_lit, new_roots = rebuild.new_lit, rebuild.new_roots
    input_vars, memo = rebuild.input_vars, rebuild.memo
    # forced vars substitute as constants (TRUE_LIT is 1, FALSE_LIT 0)
    constant = (kinds >= aig_native.PINNED_TRUE) & (
        kinds <= aig_native.FORCED_TRUE)
    truth = (kinds == aig_native.PINNED_TRUE) | (
        kinds == aig_native.FORCED_TRUE)
    new_lit.update(zip(cone[constant].tolist(),
                       truth[constant].astype(np.int32).tolist()))
    # resolved in bulk, as the loop would resolve them: free inputs the
    # session already holds (they create nothing), and pure gates the
    # memo holds (memo[v] is written only at v's own turn, so its value
    # now is the value the loop would read)
    known = (kinds == aig_native.INPUT) & (input_vars[cone] > 0)
    known_vars = cone[known]
    session_vars = input_vars[known_vars]
    rebuild.input_map.update(zip(known_vars.tolist(), session_vars.tolist()))
    new_lit.update(zip(known_vars.tolist(), (2 * session_vars).tolist()))
    memo_lits = memo[cone] - 1
    hits = (kinds == aig_native.PURE) & (memo_lits >= 0)
    new_lit.update(zip(cone[hits].tolist(), memo_lits[hits].tolist()))
    rebuild.xquery_merges = int(np.count_nonzero(hits))
    steps = (kinds != aig_native.SKIP) & (
        kinds != aig_native.FORCED_TRUE) & ~hits & ~known
    order, order_kinds = cone[steps].tolist(), kinds[steps].tolist()

    gate, session_input = rebuild.gate, rebuild.input
    impure, pure = aig_native.IMPURE, aig_native.PURE
    free_input, forced_false = aig_native.INPUT, aig_native.FORCED_FALSE
    pinned_false = aig_native.PINNED_FALSE
    trivially_unsat = False
    visited = len(order)
    for step, (var, kind) in enumerate(zip(order, order_kinds)):
        if kind == pure:
            lit = new_lit[var] = gate(var)
            memo[var] = lit + 1
        elif kind == free_input:
            new_lit[var] = 2 * session_input(var)
        elif kind == impure:
            new_lit[var] = gate(var)
        elif kind == forced_false:
            asserted = gate(var) ^ 1
            if asserted == FALSE_LIT:
                trivially_unsat = True
                visited = step + 1
                break
            if asserted != TRUE_LIT:  # TRUE = tautology under the sweep
                new_roots.append(asserted)
        else:  # a pinned input
            new_roots.append(2 * session_input(var)
                             + (kind == pinned_false))
    return _finish(rebuild, live_roots, force_roots, nodes_before, forced,
                   pinned > 0, trivially_unsat, visited)


def _finish(rebuild: _Rebuild, live_roots: List[int], force_roots: bool,
            nodes_before: int, forced: int, pinned: bool,
            trivially_unsat: bool, visited: int) -> Optional[AIGOptResult]:
    """The rewrite's result from its rebuild: the roots, the rewritten
    cone's count and components, and the "unchanged" decision. `forced`
    counts the forced vars, `pinned` says whether any is an input."""
    strash_merges = rebuild.strash_merges
    const_folds = forced + rebuild.rebuild_folds
    if trivially_unsat:
        return _trivially_unsat_result(nodes_before, const_folds,
                                       strash_merges, visited)
    new_roots = rebuild.new_roots
    if not force_roots:
        # deferred forcing: roots were not decomposed, so they emit by
        # direct literal mapping — the rebuilt cone's image of each
        # original root, polarity preserved
        for lit in live_roots:
            mapped = rebuild.new_lit.get(lit >> 1)
            if mapped is None:
                return None  # unexpected shape: degrade to "no change"
            mapped ^= lit & 1
            if mapped == FALSE_LIT:
                return _trivially_unsat_result(nodes_before, const_folds,
                                               strash_merges, visited)
            if mapped == TRUE_LIT:
                continue
            new_roots.append(mapped)
    new_roots = list(dict.fromkeys(new_roots))
    new_aig = rebuild.new_aig
    # cone-local count: the session AIG also holds sibling queries' cones
    nodes_after, root_labels = aig_native.cone_components(new_aig, new_roots)
    unchanged = force_roots and (
        nodes_after >= nodes_before
        and strash_merges == 0
        and rebuild.rebuild_folds == 0
        and len(new_roots) == len(live_roots)
        and not pinned  # no pinned inputs
    )
    if unchanged:
        # the rebuild reproduced the cone one-to-one. Usually that means
        # "keep the original" (re-emitting an identical instance would
        # only churn numbering) — EXCEPT when the cone is variable-
        # disjoint: the rewritten AIG is what makes per-component root
        # projection possible downstream, so a splittable identity
        # rewrite is still worth keeping.
        from mythril_tpu_torch.preanalysis import aig_partition

        if aig_partition.partition_roots(new_aig, new_roots,
                                         root_labels) is None:
            return None
    return AIGOptResult(new_aig, new_roots, rebuild.input_map, nodes_before,
                        nodes_after, strash_merges, const_folds,
                        trivially_unsat=False,
                        xquery_merges=rebuild.xquery_merges,
                        visited=visited, root_labels=root_labels)


def optimize_roots_cached(aig: AIG, roots: List[int]) \
        -> Optional[AIGOptResult]:
    # fork-bundle queries (deferred_forcing scope) run the root-forcing-
    # deferred sweep; the flag is part of the cache key — the same root
    # set prepared outside a fork bundle must never serve (or be served
    # by) the unforced rewrite
    force_roots = not defer_active()
    key = (getattr(aig, "uid", id(aig)), tuple(roots), force_roots)
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return None if hit is _NOT_APPLICABLE else hit
    result = optimize_roots(aig, roots, force_roots=force_roots)
    _cache[key] = _NOT_APPLICABLE if result is None else result
    while len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return result


def evaluate_roots(aig: AIG, roots: List[int],
                   input_values: Dict[int, bool]) -> bool:
    """Simulate the cone under a total input assignment (missing inputs
    default False) and report whether every root literal holds — the
    reference evaluator the semantic-preservation property tests compare
    the rewritten cone against."""
    values: Dict[int, bool] = {0: False}
    gate_lhs, gate_rhs = aig.gate_lhs, aig.gate_rhs

    def lit_value(lit: int) -> bool:
        return values[lit >> 1] ^ bool(lit & 1)

    for var in range(1, aig.num_vars + 1):
        if gate_lhs[var] >= 0:
            values[var] = lit_value(gate_lhs[var]) and lit_value(gate_rhs[var])
        else:
            values[var] = bool(input_values.get(var, False))
    return all(lit_value(r) for r in roots)


def reset_cache() -> None:
    """Drop the result cache AND the session strash table (clear_caches /
    testing hook) — stale-generation entries must never resolve against a
    rebuilt term graph."""
    global _session
    _cache.clear()
    _session = None
