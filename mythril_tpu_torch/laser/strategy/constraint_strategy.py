"""DelayConstraintStrategy — "pending" scheduling
(reference laser/ethereum/strategy/constraint_strategy.py:10).

Skips per-fork satisfiability checks during exploration: states whose
reachability was not yet proven are parked in `pending_worklist`; when the
ready worklist drains, pending states are solved (models feeding the
global quick-sat cache) and revived if reachable. Trades solver latency
off the hot path for batched/delayed checks — on the device backend the
drained pending batch is exactly the sibling-path bundle the batched
solver wants.
"""

import logging

from mythril_tpu_torch.laser.strategy import BasicSearchStrategy
from mythril_tpu_torch.service.scheduler import get_scheduler

log = logging.getLogger(__name__)

# sibling states drained per batched solve — the device fan-out unit
DRAIN_BATCH = 32


class DelayConstraintStrategy(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth, **kwargs)
        self.pending_worklist = []

    def run_check(self) -> bool:
        """Forks are accepted unchecked; reachability is decided lazily."""
        return False

    def get_strategic_global_state(self):
        while not self.work_list:
            if not self.pending_worklist:
                raise StopIteration
            # drain a sibling-path bundle through ONE batched solve: with
            # --solver-backend=gpu every eligible query rides a single
            # router dispatch (support/model.get_models_batch)
            batch = self.pending_worklist[:DRAIN_BATCH]
            del self.pending_worklist[:DRAIN_BATCH]
            # batched-fork sibling pairs that landed in the same drain
            # slice (laser/frontier dense.PendingFork tags both sides):
            # the fork lane packs each pair's shared cone once and rides
            # both sides on one ragged stream with the fork literals as
            # extra assumption roots — verdict handling is identical
            by_token = {}
            for index, state in enumerate(batch):
                token = getattr(state, "_fork_pair_token", None)
                if token is not None:
                    by_token.setdefault(id(token), []).append(index)
                    state._fork_pair_token = None  # drained once
            pairs = [tuple(indices) for indices in by_token.values()
                     if len(indices) == 2]
            # engine-path pruning verdicts: wrongly pruning costs coverage,
            # not a false "safe" verdict — no UNSAT crosscheck (explicit;
            # matches get_model's non-detection default). The drained
            # bundle rides the coalescing scheduler: one window flush per
            # drain (service/scheduler.py)
            constraint_sets = [
                s.world_state.constraints.get_all_constraints()
                for s in batch
            ]
            if pairs:
                outcomes = get_scheduler().solve_fork_batch(
                    constraint_sets, pairs, crosscheck=False)
            else:
                outcomes = get_scheduler().solve_batch(
                    constraint_sets, crosscheck=False)
            fork_sides = {index for pair in pairs for index in pair}
            for index, (state, (status, _model)) in enumerate(
                    zip(batch, outcomes)):
                if status == "unsat":
                    if index in fork_sides:
                        # a batched-fork side died on a solver-confirmed
                        # (host CDCL) verdict — the fork lane's prune
                        from mythril_tpu_torch.smt.solver.statistics import (
                            SolverStatistics,
                        )

                        SolverStatistics().add_fork_pruned()
                    continue  # proven unreachable: pruned
                # sat (model already fed to the quick-sat cache by
                # get_models_batch) or unknown (cannot prune): revive
                self.work_list.append(state)
        return self.work_list.pop(0)
