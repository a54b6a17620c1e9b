"""Per-path constraint set (reference laser/ethereum/state/constraints.py).

A list of Bool expressions; keccak axioms are injected at solve time via
get_all_constraints (reference :77,132-133) rather than stored per state."""

from typing import Iterable, List, Optional

from mythril_tpu_torch.smt import Bool, simplify
from mythril_tpu_torch.smt.solver.frontend import UnsatError, SolverTimeOutException


class Constraints(list):
    def __init__(self, constraint_list: Optional[Iterable[Bool]] = None):
        super().__init__(constraint_list or [])
        self._is_possible: Optional[bool] = None

    def append(self, constraint: Bool) -> None:
        if isinstance(constraint, bool):
            constraint = Bool.value(constraint)
        super().append(simplify(constraint))
        self._is_possible = None

    def pop(self, index: int = -1) -> Bool:
        self._is_possible = None
        return super().pop(index)

    @property
    def is_possible(self) -> bool:
        """SAT probe with caching; unknown counts as possible (can't prune)."""
        if self._is_possible is not None:
            return self._is_possible
        from mythril_tpu_torch.support.model import get_model

        try:
            get_model(self.get_all_constraints())
            self._is_possible = True
        except UnsatError:
            self._is_possible = False
        except SolverTimeOutException:
            self._is_possible = True
        return self._is_possible

    def get_all_constraints(self) -> List[Bool]:
        from mythril_tpu_torch.laser.function_managers import keccak_function_manager

        return list(self) + keccak_function_manager.create_conditions()

    as_list = get_all_constraints

    def copy(self) -> "Constraints":
        dup = Constraints(self)
        dup._is_possible = self._is_possible
        return dup

    __copy__ = copy

    def __deepcopy__(self, memo) -> "Constraints":
        return self.copy()

    def __add__(self, other) -> "Constraints":
        dup = self.copy()
        for constraint in other:
            dup.append(constraint)
        return dup

    def __iadd__(self, other) -> "Constraints":
        for constraint in other:
            self.append(constraint)
        return self

    def __hash__(self):  # hashable for the model cache
        return hash(tuple(hash(c) for c in self))
