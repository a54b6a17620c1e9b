"""IssueAnnotation — carries (detector, issue, conditions) on states
(reference analysis/issue_annotation.py:47). The suicide, exceptions and
integer modules annotate the states their issues fire on, and
pre-analysis reads the annotations. The JAX package's summaries mode,
whose plugin re-solves the conditions under substitution, is not ported
yet."""

from typing import List

from mythril_tpu_torch.laser.state.annotation import MergeableStateAnnotation


class IssueAnnotation(MergeableStateAnnotation):
    def __init__(self, conditions: List, issue, detector):
        """conditions: independently-satisfiable Bool conditions proving
        the issue; issue: the Issue record; detector: its module."""
        self.conditions = conditions
        self.issue = issue
        self.detector = detector

    @property
    def persist_to_world_state(self) -> bool:
        return True

    @property
    def persist_over_calls(self) -> bool:
        return True

    def __copy__(self):
        return IssueAnnotation(
            conditions=list(self.conditions),
            issue=self.issue,
            detector=self.detector,
        )

    clone = __copy__

    def check_merge_annotation(self, other: "IssueAnnotation") -> bool:
        return (self.issue.address == other.issue.address
                and type(self.detector) is type(other.detector))

    def merge_annotation(self, other: "IssueAnnotation") -> "IssueAnnotation":
        return self
