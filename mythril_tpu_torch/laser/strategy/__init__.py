"""Search strategies — the scheduler of the worklist engine
(reference laser/ethereum/strategy/__init__.py; consumed at svm.py:336).

A strategy is an iterator over GlobalStates, drawing from (and owning the
ordering policy of) the engine's work_list. Composable by wrapping."""

from typing import List

from mythril_tpu_torch.laser.state.global_state import GlobalState


class BasicSearchStrategy:
    def __init__(self, work_list: List[GlobalState], max_depth: int, **kwargs):
        self.work_list = work_list
        self.max_depth = max_depth
        # static per-function effect hints (a preanalysis.CodeSummary with
        # `function_effects`: selector -> FunctionEffects), or None when
        # pre-analysis is disabled/unavailable. Strategies MAY use this to
        # deprioritize provably effect-free cones; the engine's fork
        # pruning consumes the same summary to skip feasibility solves
        # for inert states (svm.exec). Dropping states based on it would
        # be unsound — hints only reorder or skip redundant solver work.
        self.effect_hints = kwargs.get("effect_hints")

    def __iter__(self):
        return self

    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError

    def run_check(self) -> bool:
        """Gate consulted by stochastic pruning (reference svm.py:351)."""
        return True

    def __next__(self) -> GlobalState:
        # exhaustion is signalled by get_strategic_global_state (empty pop
        # raises IndexError), NOT by checking work_list here — strategies
        # like DelayConstraintStrategy refill the worklist from a pending
        # pool exactly when it runs dry
        while True:
            try:
                state = self.get_strategic_global_state()
            except IndexError:
                raise StopIteration
            if state.mstate.depth < self.max_depth:
                return state
            # depth-capped states are dropped (their world state was already
            # harvested if a tx ended)


class CriterionSearchStrategy(BasicSearchStrategy):
    """Stop once a criterion is satisfied (concolic search)."""

    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth, **kwargs)
        self._satisfied = False

    def set_criterion_satisfied(self):
        self._satisfied = True

    def __next__(self):
        if self._satisfied:
            raise StopIteration
        return super().__next__()
