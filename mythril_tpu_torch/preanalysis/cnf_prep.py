"""Static CNF preprocessing ahead of fingerprinting and dispatch.

Two passes over the blasted instance, both verdict-preserving:

  unit propagation      asserted unit clauses force assignments; satisfied
                        clauses are dropped and falsified literals deleted,
                        to a fixpoint. Equivalence-preserving: every forced
                        assignment is a logical consequence, and each one
                        is RE-ASSERTED as a unit clause in the output so
                        any model of the simplified CNF assigns it
                        correctly (model replay / reconstruction stays
                        valid against the original constraints).
  pure-literal rule     a variable occurring with a single polarity among
                        the live clauses is pinned to that polarity (unit
                        clause added, its clauses dropped). Preserves
                        SAT/UNSAT and every surviving model satisfies the
                        original CNF — but it CAN remove models, so the
                        caller must disable it (allow_pure=False) when the
                        instance will later be probed under assumptions
                        (Optimize bit fixing): pinning a bit the original
                        CNF leaves free would turn a SAT probe into UNSAT
                        and mis-minimize exploits.

Variable numbering is PRESERVED (no renumbering): downstream consumers —
dense var maps for objective bits, session assumptions, stored assignment
replay, model reconstruction — all keep working on the simplified
instance unchanged.

`split_components` additionally partitions an instance into variable-
disjoint connected components (each renumbered dense) so the CDCL settles
independent sub-cones separately; merged component models recompose into
a full-space assignment Solver._reconstruct accepts.

Everything here is total: any unexpected shape degrades to "no change",
never to a wrong CNF.

Both packages must hand the solvers the same CNF: `split_components` and
`merge_component_bits` are copies of mythril_tpu.preanalysis.cnf_prep's
with the import root changed, and `preprocess_cnf` gives the reference's
output byte for byte, its propagation visiting only the occurrences of
the variables each round pins where the reference sweeps every literal.
"""

from typing import List, Optional

import numpy as np

from mythril_tpu_torch.smt.bitblast import CNF

# instances past this many clauses skip preprocessing: propagation
# visits only the pinned variables' occurrences, but the rebuild is a
# pass over every literal, and cones this size are dominated by CDCL
# wall anyway
PREPROCESS_CLAUSE_CAP = 400_000
MAX_ROUNDS = 40
# component splitting runs scipy's native connected_components over the
# bipartite variable-clause incidence graph (~1 ms at the cap; a Python
# union-find measured 150+ ms there — too expensive for a decision that
# usually answers "one component, no split"); bounded both ways so the
# split decision never costs more than the solve it is trying to shrink
SPLIT_CLAUSE_CAP = 60_000
SPLIT_MIN_CLAUSES = 64


class PreprocessResult:
    __slots__ = ("cnf", "conflict", "units", "pures", "removed_clauses",
                 "changed", "rounds", "visited")

    def __init__(self, cnf, conflict, units, pures, removed_clauses,
                 rounds=0, visited=0):
        self.cnf = cnf
        self.conflict = conflict
        self.units = units          # assignments forced by propagation
        self.pures = pures          # assignments chosen by the pure rule
        self.removed_clauses = removed_clauses
        self.changed = conflict or units > 0 or pures > 0 \
            or removed_clauses > 0
        # propagation rounds run: one per level of forced units, the last
        # (which forced nothing) included
        self.rounds = rounds
        # literal occurrences unit propagation read: the unit clauses'
        # literals and the occurrences of the variables they pinned (a
        # pass over every literal each round reads rounds x literals);
        # the pure rule's passes are not counted
        self.visited = visited


def _as_buffers(clauses):
    """(lits int64, offsets int64, n) view of either CNF buffers or a
    legacy clause list; None when empty/unconvertible."""
    if not hasattr(clauses, "lits"):
        try:
            clauses = CNF.from_clauses(list(clauses))
        except (TypeError, ValueError):
            return None
    if len(clauses) == 0:
        return None
    lits = np.asarray(clauses.lits, dtype=np.int64)
    offsets = np.asarray(clauses.offsets, dtype=np.int64)
    return lits, offsets, len(clauses)


def _ranges(starts, counts):
    """The concatenated aranges [starts[i], starts[i] + counts[i])."""
    ends = np.cumsum(counts)
    return (np.repeat(starts - (ends - counts), counts)
            + np.arange(counts.sum()))


def _occurrence_index(var, num_vars):
    """CSR from variable to literal positions: the positions of variable
    v are order[start[v]:start[v + 1]], ascending. Below 2**16 variables
    the key is 16 bits wide, which numpy sorts by radix."""
    key = var.astype(np.uint16) if num_vars < 1 << 16 else var
    order = np.argsort(key, kind="stable")
    start = np.zeros(num_vars + 2, dtype=np.int64)
    np.cumsum(np.bincount(var, minlength=num_vars + 1), out=start[1:])
    return order, start


def preprocess_cnf(num_vars: int, clauses,
                   allow_pure: bool = True) -> Optional[PreprocessResult]:
    """Simplify `clauses` (same variable numbering); None = not applicable
    (empty/oversize instance or nothing to do).

    Level-synchronous unit propagation over an occurrence index: each
    clause keeps a satisfied flag and a count of false literals, updated
    only at the occurrences of the variables a round pins, and a round
    examines only the clauses those pins touched (round 1: the clauses of
    length 1). No other clause can have become unit or empty, so every
    round decides exactly what a pass over all literals would."""
    buffers = _as_buffers(clauses)
    if buffers is None or num_vars <= 0:
        return None
    lits, offsets, n_clauses = buffers
    if n_clauses > PREPROCESS_CLAUSE_CAP:
        return None
    lengths = offsets[1:] - offsets[:-1]
    if (lengths == 0).any():
        # an already-empty clause: syntactic conflict
        return PreprocessResult(None, True, 0, 0, 0)
    var = np.abs(lits)
    if var.max(initial=0) > num_vars or var.min(initial=1) == 0:
        return None  # malformed instance: leave it to the solver

    assign = np.zeros(num_vars + 1, dtype=np.int8)  # 0 free, +1/-1 pinned
    sat = np.zeros(n_clauses, dtype=bool)
    n_false = np.zeros(n_clauses, dtype=np.int64)  # one per occurrence
    index = None  # built at the first pin
    pinned_occ = []  # the occurrences of every pinned variable
    forced_by_up = 0
    forced_by_pure = 0
    visited = 0

    def pin(pinned, values):
        """Assign the free, distinct `pinned`, update the clauses at
        their occurrences; the touched clauses, ascending."""
        nonlocal index
        assign[pinned] = values
        if index is None:
            index = _occurrence_index(var, num_vars)
        order, start = index
        occ = order[_ranges(start[pinned], start[pinned + 1] - start[pinned])]
        pinned_occ.append(occ)
        clause = np.searchsorted(offsets, occ, side="right") - 1
        true = (lits[occ] > 0) == (assign[var[occ]] > 0)
        sat[clause[true]] = True
        falsified, count = np.unique(clause[~true], return_counts=True)
        n_false[falsified] += count
        return np.unique(clause)

    candidates = np.flatnonzero(lengths == 1)
    rounds = 0
    for rounds in range(1, MAX_ROUNDS + 1):
        live = candidates[~sat[candidates]]
        free = lengths[live] - n_false[live]
        if (free == 0).any():
            return PreprocessResult(None, True, forced_by_up,
                                    forced_by_pure, 0, visited=visited)
        units = live[free == 1]
        if len(units):
            # each unit clause's one free literal
            at = _ranges(offsets[units], lengths[units])
            visited += len(at)
            at = at[assign[var[at]] == 0]
            # distinct (variable, polarity) pairs, by variable
            forced = np.unique(2 * var[at] + (lits[at] > 0))
            unit_vars = forced >> 1
            # conflicting forcings in one round (x and -x both unit)
            if (unit_vars[1:] == unit_vars[:-1]).any():
                return PreprocessResult(None, True, forced_by_up,
                                        forced_by_pure, 0, visited=visited)
            forced_by_up += len(unit_vars)
            candidates = pin(unit_vars, 2 * (forced & 1) - 1)
            visited += len(pinned_occ[-1])
        elif allow_pure:
            # purity depends on every live literal: one pass over them
            live_lit = np.repeat(~sat, lengths) & (assign[var] == 0)
            pos = np.zeros(num_vars + 1, dtype=bool)
            neg = np.zeros(num_vars + 1, dtype=bool)
            pos[var[live_lit & (lits > 0)]] = True
            neg[var[live_lit & (lits < 0)]] = True
            pure = np.flatnonzero(pos ^ neg)
            if not len(pure):
                break
            forced_by_pure += len(pure)
            candidates = pin(pure, np.where(pos[pure], 1, -1))
        else:
            break

    assigned = int(np.count_nonzero(assign))
    if assigned == 0:
        return None  # nothing learned; keep the original buffers

    # rebuild: live clauses minus falsified literals, plus one unit clause
    # per pinned variable (pins the model so replay/validation stays exact)
    live = ~sat
    kept_counts = (lengths - n_false)[live]
    if (kept_counts == 0).any():
        # a clause lost every literal after the rounds budget ran out with
        # forcings still pending: that is a conflict, not an empty clause
        return PreprocessResult(None, True, forced_by_up, forced_by_pure, 0,
                                visited=visited)
    keep = np.ones(len(lits), dtype=bool)
    keep[np.concatenate(pinned_occ)] = False
    satisfied = np.flatnonzero(sat)
    keep[_ranges(offsets[satisfied], lengths[satisfied])] = False
    kept_lits = lits[keep]

    pinned_vars = np.nonzero(assign)[0]
    unit_lits = pinned_vars * assign[pinned_vars]

    new_lits = np.concatenate([
        kept_lits, unit_lits.astype(np.int64)]).astype(np.int32)
    new_lengths = np.concatenate([
        kept_counts, np.ones(len(unit_lits), dtype=np.int64)])
    new_offsets = np.zeros(len(new_lengths) + 1, dtype=np.int64)
    np.cumsum(new_lengths, out=new_offsets[1:])
    new_cnf = CNF(new_lits, new_offsets, len(new_lengths), False)
    removed = n_clauses - int(np.count_nonzero(live))
    return PreprocessResult(new_cnf, False, forced_by_up, forced_by_pure,
                            removed, rounds, visited)


class Component:
    """One variable-disjoint sub-instance, densely renumbered."""

    __slots__ = ("num_vars", "cnf", "orig_vars", "trivial_bits")

    def __init__(self, num_vars, cnf, orig_vars, trivial_bits=None):
        self.num_vars = num_vars    # local (dense) variable count
        self.cnf = cnf              # CNF in local numbering
        self.orig_vars = orig_vars  # local var i+1 -> orig_vars[i]
        # all-unit consistent components (preprocessing leaves one unit
        # clause per pinned var) carry their model directly — no solver
        # round-trip needed. Contradictory unit components deliberately do
        # NOT settle here: the CDCL must prove that UNSAT so the
        # detection-path crosscheck policy applies.
        self.trivial_bits = trivial_bits


def split_components(num_vars: int, clauses) -> Optional[List[Component]]:
    """Partition an instance into connected components (variables linked by
    sharing a clause). Returns None when the instance is one component,
    empty, or past SPLIT_CLAUSE_CAP."""
    buffers = _as_buffers(clauses)
    if buffers is None or num_vars <= 0:
        return None
    lits, offsets, n_clauses = buffers
    if n_clauses > SPLIT_CLAUSE_CAP or n_clauses < SPLIT_MIN_CLAUSES:
        return None
    if ((offsets[1:] - offsets[:-1]) == 0).any():
        return None  # empty clause: the solver's problem, not a split's
    var = np.abs(lits)
    if var.max(initial=0) > num_vars:
        return None
    from mythril_tpu_torch.preanalysis.components import connected_labels

    lengths = offsets[1:] - offsets[:-1]
    clause_ids = np.repeat(np.arange(n_clauses, dtype=np.int64), lengths)
    # bipartite incidence: var nodes [0..num_vars], clause nodes after
    labels = connected_labels(
        num_vars + 1 + n_clauses, var, clause_ids + num_vars + 1)
    if labels is None:
        return None
    clause_label = labels[var[offsets[:-1]]]
    distinct = np.unique(clause_label)
    if len(distinct) < 2:
        return None

    components: List[Component] = []
    for root in distinct:
        clause_mask = clause_label == root
        lit_mask = clause_mask[clause_ids]
        comp_lits = lits[lit_mask]
        comp_vars = np.unique(np.abs(comp_lits))
        remap = np.zeros(num_vars + 1, dtype=np.int64)
        remap[comp_vars] = np.arange(1, len(comp_vars) + 1)
        local = np.sign(comp_lits) * remap[np.abs(comp_lits)]
        comp_lengths = lengths[clause_mask]
        comp_offsets = np.zeros(len(comp_lengths) + 1, dtype=np.int64)
        np.cumsum(comp_lengths, out=comp_offsets[1:])
        cnf = CNF(local.astype(np.int32), comp_offsets,
                  len(comp_lengths), False)
        trivial_bits = None
        if (comp_lengths == 1).all():
            signs = np.sign(local)
            order = np.argsort(np.abs(local), kind="stable")
            lv, ls = np.abs(local)[order], signs[order]
            contradictory = ((lv[1:] == lv[:-1])
                             & (ls[1:] != ls[:-1])).any()
            if not contradictory:
                trivial_bits = [False] * (len(comp_vars) + 1)
                for lit in local:
                    trivial_bits[abs(int(lit))] = lit > 0
        components.append(
            Component(len(comp_vars), cnf, comp_vars.tolist(),
                      trivial_bits=trivial_bits))
    return components


def merge_component_bits(num_vars: int, components: List[Component],
                         bits_per_component: List[List[bool]]) -> List[bool]:
    """Recompose per-component models into one full-space assignment
    (variables in no clause default to False, matching the CDCL's model
    completion)."""
    merged = [False] * (num_vars + 1)
    for component, bits in zip(components, bits_per_component):
        for local, orig in enumerate(component.orig_vars, start=1):
            merged[orig] = bool(bits[local])
    return merged
