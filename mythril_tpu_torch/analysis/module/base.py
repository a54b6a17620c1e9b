"""DetectionModule base (reference analysis/module/base.py:120).

A module declares hook opcodes (pre/post) or a POST entry point; `execute`
runs the module's `_analyze_state` with an issue cache keyed by
(address, bytecode_hash) so re-visited program points are skipped."""

import logging
from enum import Enum
from typing import List, Optional, Set, Tuple

from mythril_tpu_torch.gpu import device as device_mod
from mythril_tpu_torch.support import model as model_mod

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    POST = 1        # runs over the recorded statespace after execution
    CALLBACK = 2    # runs from opcode hooks during execution


class DetectionModule:
    name = "detection module"
    swc_id = ""
    description = ""
    entry_point: EntryPoint = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []
    # static-gating declaration (preanalysis): the opcodes at least one of
    # which must be EXECUTABLE for this module to ever raise an issue.
    # None (default) falls back to pre_hooks + post_hooks — always sound.
    # Override with a tighter set when some hooks are mere taint
    # observers: e.g. TxOrigin hooks JUMPI but cannot fire without ORIGIN
    # having executed. Declaring an opcode here that is NOT required for
    # an issue would be a soundness bug (findings would silently vanish
    # on contracts lacking it).
    trigger_opcodes: Optional[List[str]] = None

    def __init__(self):
        self.issues: List = []
        self.cache: Set[Tuple[int, bytes]] = set()
        # modules managing their own dedupe (e.g. Exceptions keying by last
        # JUMP) set this False (reference base.py auto_cache)
        self.auto_cache: bool = True
        # hook context, set per-invocation by execute(): which opcode fired
        # the hook and whether it was a pre- or post-hook (post-hooks see the
        # state AFTER execution, pc already advanced)
        self.current_opcode: Optional[str] = None
        self.is_prehook: bool = True

    def reset_module(self):
        self.issues = []

    def reset_cache(self):
        """Clear the (address, bytecode-hash) dedupe cache. Called at the
        start of each analysis session (core.fire_lasers) so repeated
        library-level analyses of the same bytecode re-detect issues; the
        reference never needs this because each CLI run is one process."""
        self.cache = set()

    def update_cache(self, issues=None):
        issues = issues if issues is not None else self.issues
        for issue in issues:
            self.cache.add((issue.address, issue.bytecode_hash))

    def _cache_key(self, global_state) -> Tuple[int, str]:
        instruction = global_state.get_current_instruction()
        address = instruction.address if instruction is not None else -1
        return (
            address,
            "0x" + global_state.environment.code.bytecode_hash.hex(),
        )

    def execute(self, target, opcode: Optional[str] = None,
                prehook: bool = True) -> Optional[List]:
        """target: GlobalState for CALLBACK modules, statespace for POST."""
        if self.entry_point == EntryPoint.CALLBACK:
            self.current_opcode = opcode
            self.is_prehook = prehook
            if (
                self.auto_cache
                and prehook
                and self._cache_key(target) in self.cache
            ):
                return None
        # inline detection-context flip (not the contextmanager): this is
        # the engine's hottest path — every opcode x every callback module
        previous_context = model_mod._in_detection_context
        model_mod._in_detection_context = True
        try:
            if self.entry_point == EntryPoint.CALLBACK:
                result = self._analyze_state(target)
            else:
                result = self._analyze_statespace(target)
        finally:
            model_mod._in_detection_context = previous_context
        if device_mod._fault is not None:
            # the module caught a device failure from its solve as if the
            # query had no answer: the analysis stops with it instead
            device_mod.raise_recorded_fault()
        if result:
            from mythril_tpu_torch.support.args import args

            if args.use_issue_annotations and \
                    self.entry_point == EntryPoint.CALLBACK:
                # summaries mode: direct results would be solved under
                # parametric (summary-symbol) state — a false-positive
                # source; carry them as annotations for substituted
                # re-solving instead (reference base.py:94)
                from mythril_tpu_torch.analysis.issue_annotation import (
                    IssueAnnotation,
                )
                from mythril_tpu_torch.smt import And

                # modules that solved precise conditions (e.g. suicide's
                # attacker constraints) annotate themselves; only add the
                # coarse reachability fallback for issues they didn't, or a
                # weaker duplicate could confirm a false positive on
                # substituted re-solving
                already = {
                    id(a.issue)
                    for a in target.annotations
                    if isinstance(a, IssueAnnotation)
                }
                for issue in result:
                    if id(issue) in already:
                        continue
                    target.annotate(IssueAnnotation(
                        conditions=[And(
                            *target.world_state.constraints)],
                        issue=issue,
                        detector=self,
                    ))
                return result
            self.issues.extend(result)
            if self.auto_cache:
                self.update_cache(result)
        return result

    def _analyze_state(self, global_state) -> List:
        return []

    def _analyze_statespace(self, statespace) -> List:
        return []

    def __repr__(self):
        return f"<DetectionModule {self.name} swc={self.swc_id}>"
