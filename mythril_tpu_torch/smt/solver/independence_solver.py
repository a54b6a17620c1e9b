"""Independence solver — partition constraints into variable-disjoint
buckets and solve each bucket separately (reference
laser/smt/solver/independence_solver.py:38, rebuilt on the Term DAG
instead of z3 expression trees).

Two constraints are dependent iff they share a free symbol (bitvector
symbol, array, or uninterpreted function); dependence buckets are the
connected components of that relation, maintained incrementally as
conditions arrive. check() solves every bucket with its own Solver — one
UNSAT bucket proves the whole set UNSAT; all-SAT merges the per-bucket
assignments into one Model (model completion covers untouched symbols).

Like the reference's, this solver is opt-in (the batched device fan-out in
support/model.py is the production path); it pays off on queries whose
constraint sets contain large independent clusters, e.g. multi-contract
world states."""

from typing import Dict, List, Optional, Set

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver.frontend import SAT, UNSAT, UNKNOWN, Solver


def _condition_symbols(raw: terms.Term) -> Set[str]:
    names = set()
    for node in terms.walk_terms([raw]):
        if node.op in ("sym", "array"):
            names.add(node.params[0])
        elif node.op == "apply":
            names.add(node.params[0].name)
    return names


class DependenceBucket:
    """Conditions that transitively share symbols."""

    def __init__(self):
        self.variables: Set[str] = set()
        self.conditions: List[terms.Term] = []


class DependenceMap:
    """Incrementally-maintained connected components over shared symbols
    (reference independence_solver.py:38-101)."""

    def __init__(self):
        self.buckets: List[DependenceBucket] = []
        self.variable_map: Dict[str, DependenceBucket] = {}

    def add_condition(self, raw: terms.Term) -> None:
        symbols = _condition_symbols(raw)
        relevant = []
        seen = set()
        for name in symbols:
            bucket = self.variable_map.get(name)
            if bucket is not None and id(bucket) not in seen:
                seen.add(id(bucket))
                relevant.append(bucket)
        if relevant:
            target = relevant[0]
            for other in relevant[1:]:
                target.variables |= other.variables
                target.conditions += other.conditions
                self.buckets.remove(other)
        else:
            target = DependenceBucket()
            self.buckets.append(target)
        target.variables |= symbols
        target.conditions.append(raw)
        for name in target.variables:
            self.variable_map[name] = target


class IndependenceSolver:
    """Drop-in Solver variant: same add/check/model surface."""

    def __init__(self, timeout: Optional[float] = None):
        self.timeout = timeout
        self.raw_constraints: List[terms.Term] = []
        self._models: List[Model] = []
        self._last_status: Optional[str] = None

    def set_timeout(self, timeout_ms: int) -> None:
        self.timeout = timeout_ms / 1000.0

    def add(self, *constraints) -> None:
        for constraint in constraints:
            if isinstance(constraint, (list, tuple)):
                self.add(*constraint)
                continue
            raw = getattr(constraint, "raw", constraint)
            self.raw_constraints.append(raw)

    append = add

    def check(self, *extra) -> str:
        dep_map = DependenceMap()
        for raw in self.raw_constraints:
            dep_map.add_condition(raw)
        for constraint in extra:
            dep_map.add_condition(getattr(constraint, "raw", constraint))
        self._models = []
        self._last_status = None
        unknown = False
        for bucket in dep_map.buckets:
            sub = Solver(timeout=self.timeout)
            sub.add(bucket.conditions)
            status = sub.check()
            if status == UNSAT:
                self._last_status = UNSAT
                return UNSAT  # one impossible bucket sinks the whole set
            if status != SAT:
                # keep scanning: a later bucket may still prove UNSAT (a
                # timeout on one cluster must not hide a provable verdict)
                unknown = True
                continue
            self._models.append(sub.model())
        self._last_status = UNKNOWN if unknown else SAT
        return self._last_status

    def model(self) -> Model:
        if self._last_status != SAT:
            raise ValueError("no model available (last check was not sat)")
        return Model(sub_models=self._models)
