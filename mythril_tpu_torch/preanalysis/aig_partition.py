"""Variable-disjoint partition of an optimized AIG with per-component
root projection.

An instance rewritten by aig_opt is a fresh AIG holding EXACTLY the live
cone of its asserted roots, so partitioning is a single native
connectivity pass over its gate table (no cone re-extraction): two roots
share a component iff their cones are connected through shared gates or
inputs. Each component carries its own projected root set and lazily
materializes its own dense-renumbered CNF sub-instance (aig.to_cnf over
the projected roots — the same exporter the monolith uses), so:

  - the device router (gpu/router.py) dispatches eligible components
    INDIVIDUALLY while tiny or oversized siblings settle on the host
    CDCL — a deep monolith with small independent sub-cones no longer
    forfeits the device path;
  - components whose every root is an input literal (the unit roots the
    sweep emits for pinned inputs) are trivial: their model is their
    literals, no solver of any kind needed.

Partitioning applies ONLY to AIGs carrying the `_aig_opt_cone` marker:
the shared global blaster AIG holds every cone ever blasted and walking
it per query would be both wrong (foreign cones) and unaffordable.

Ported from mythril_tpu.preanalysis.aig_partition with the import root
changed, and the cone walk and connectivity in native code (aig_native,
one union-find pass over the cone): both packages must split a query
into the same components.
"""

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from mythril_tpu_torch.preanalysis import aig_native
from mythril_tpu_torch.smt.bitblast import AIG

_CACHE_MAX = 256
_NOT_APPLICABLE = object()
_cache: "OrderedDict" = OrderedDict()

# a partition only pays when the router can do something with it; past
# this many components the instance is pathological and the bookkeeping
# (per-component CNF + fingerprints) would dominate
MAX_COMPONENTS = 512


class AIGComponent:
    """One variable-disjoint sub-cone of an optimized instance."""

    __slots__ = ("roots", "trivial_assignment", "_instance")

    def __init__(self, roots: List[int], trivial_assignment):
        self.roots = roots  # projected root literals (optimized numbering)
        # {aig var: bool} when every root is an input literal (no gates):
        # the component's model IS its literals — solved inline, no
        # dispatch, no CDCL. None for components with real structure.
        self.trivial_assignment = trivial_assignment
        self._instance = None  # lazy (num_vars, cnf, dense) sub-instance

    def instance(self, aig: AIG):
        """The component's own blasted sub-instance: dense variable remap
        + CNF over just this component's cone (cached — sibling queries
        and repeated dispatches share one emission)."""
        if self._instance is None:
            self._instance = aig.to_cnf(list(self.roots))
        return self._instance


class AIGPartition:
    __slots__ = ("aig", "components")

    def __init__(self, aig: AIG, components: List[AIGComponent]):
        self.aig = aig
        self.components = components


def partition_roots(aig: AIG, roots: List[int],
                    root_labels=None) -> Optional[AIGPartition]:
    """Partition an optimized AIG's roots into variable-disjoint
    components; None when not applicable (unmarked AIG, single
    component, constant roots, or a pathological component count).

    Connectivity is computed over the CONE of this root set, not the
    whole gate table: the session strash AIG (aig_opt._StrashSession)
    accumulates every sibling query's rewrite, so a whole-graph pass
    would both cost O(session) per query and glue THIS query's disjoint
    components together through foreign gates that merely share their
    inputs. `root_labels` (per root, a label of its component that sorts
    as the component's smallest var) comes from aig_opt's native pass
    when it has walked this cone already; else aig_native's pass labels
    the roots here. Components come out in the order of their smallest
    var."""
    if not getattr(aig, "_aig_opt_cone", False):
        return None
    if not roots or any(lit >> 1 == 0 for lit in roots):
        return None  # constant roots: the monolith path handles them
    if root_labels is None:
        _gates, root_labels = aig_native.cone_components(aig, roots)
    groups: Dict[int, List[int]] = {}
    for lit, label in zip(roots, root_labels):
        groups.setdefault(label, []).append(lit)
    if len(groups) < 2 or len(groups) > MAX_COMPONENTS:
        return None

    gate_lhs = aig.gate_lhs
    components: List[AIGComponent] = []
    for label in sorted(groups):
        comp_roots = groups[label]
        trivial = None
        if all(gate_lhs[lit >> 1] < 0 for lit in comp_roots):
            trivial = {}
            for lit in comp_roots:
                var, value = lit >> 1, not (lit & 1)
                if trivial.get(var, value) != value:
                    trivial = None  # contradictory units: let a solver say
                    break
                trivial[var] = value
        components.append(AIGComponent(comp_roots, trivial))
    return AIGPartition(aig, components)


def partition_for_aig_roots(aig_roots) -> Optional[AIGPartition]:
    """The gate the router's component dispatch uses to decide whether a
    prepared instance's (aig, roots, dense) triple is partitioned: the
    AIG must carry the aig_opt rewrite marker, the triple must carry a
    dense map, and any failure degrades to None (monolithic handling)."""
    try:
        aig = aig_roots[0]
    except (TypeError, IndexError, KeyError):
        return None
    if not getattr(aig, "_aig_opt_cone", False):
        return None
    try:
        if len(aig_roots) < 3 or aig_roots[2] is None:
            return None
        return partition_cached(aig, aig_roots[1])
    except Exception:
        return None  # partitioning must never break a solve


def component_vars(component_dense):
    """The component's global (optimized-AIG) vars — the iteration space
    for merging its sub-model into the parent query's bit space. Derived
    from the dense map (not a PackedCircuit): it exists for every
    component, including cones past the device compile caps."""
    return np.nonzero(component_dense.arr)[0]


def partition_cached(aig: AIG, roots,
                     root_labels=None) -> Optional[AIGPartition]:
    key = (getattr(aig, "uid", id(aig)), tuple(roots))
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return None if hit is _NOT_APPLICABLE else hit
    result = partition_roots(aig, list(roots), root_labels)
    _cache[key] = _NOT_APPLICABLE if result is None else result
    while len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return result


def merge_component_bits(component_dense, query_dense, var_map,
                         component_bits, merged: List[bool]) -> None:
    """Copy one solved component's model bits into the full query's bit
    space: component-dense -> global (optimized-AIG) var -> query-dense.
    `var_map` is the component PackedCircuit's local->global map (or an
    iterable of the component's global vars)."""
    for gvar in var_map:
        if gvar == 0:
            continue
        cvar = component_dense.get(gvar)
        qvar = query_dense.get(gvar)
        if cvar is not None and qvar is not None and qvar < len(merged):
            merged[qvar] = bool(component_bits[cvar])


def apply_trivial_assignment(component: AIGComponent, query_dense,
                             merged: List[bool]) -> bool:
    """Write a trivial component's pinned literals into the query's bit
    space; False when the component is not trivial."""
    if component.trivial_assignment is None:
        return False
    for var, value in component.trivial_assignment.items():
        qvar = query_dense.get(var)
        if qvar is not None and qvar < len(merged):
            merged[qvar] = value
    return True


def reset_cache() -> None:
    """Testing hook."""
    _cache.clear()
