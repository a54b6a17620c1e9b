"""Beam search (reference laser/ethereum/strategy/beam.py:6): keep only
the `beam_width` states with the highest summed annotation
search_importance (PotentialIssuesAnnotation contributes 10 per recorded
issue, analysis/potential_issues.py)."""

from mythril_tpu_torch.laser.strategy import BasicSearchStrategy


class BeamSearch(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, beam_width: int = 8, **kwargs):
        super().__init__(work_list, max_depth, **kwargs)
        self.beam_width = beam_width

    @staticmethod
    def beam_priority(state) -> int:
        return sum(a.search_importance for a in state.annotations)

    def sort_and_eliminate_states(self) -> None:
        self.work_list.sort(key=self.beam_priority, reverse=True)
        del self.work_list[self.beam_width:]

    def get_strategic_global_state(self):
        self.sort_and_eliminate_states()
        if self.work_list:
            return self.work_list.pop(0)
        raise StopIteration  # beam truncation emptied the worklist
