"""State annotations — the metadata/taint channel used by every detection
module and plugin (reference laser/ethereum/state/annotation.py:74)."""


class StateAnnotation:
    @property
    def persist_to_world_state(self) -> bool:
        """Carried from the tx-final state into the world state."""
        return False

    @property
    def persist_over_calls(self) -> bool:
        """Survives into nested call frames."""
        return False

    @property
    def search_importance(self) -> int:
        """Weight used by beam search (higher = keep)."""
        return 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotations that state merging knows how to combine."""

    def check_merge_annotation(self, other) -> bool:
        raise NotImplementedError

    def merge_annotation(self, other):
        raise NotImplementedError
