"""DFS/BFS/random strategies (reference laser/ethereum/strategy/basic.py)."""

import random

from mythril_tpu_torch.laser.strategy import BasicSearchStrategy


class DepthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self):
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self):
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self):
        if not self.work_list:
            raise IndexError  # exhausted (see BasicSearchStrategy.__next__)
        index = random.randrange(len(self.work_list))
        return self.work_list.pop(index)


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """1/(depth+1)-weighted choice (reference basic.py:86)."""

    def get_strategic_global_state(self):
        weights = [
            1 / (state.mstate.depth + 1) for state in self.work_list
        ]
        total = sum(weights)
        pick = random.uniform(0, total)
        acc = 0.0
        for i, weight in enumerate(weights):
            acc += weight
            if acc >= pick:
                return self.work_list.pop(i)
        return self.work_list.pop()
