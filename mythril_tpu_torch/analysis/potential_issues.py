"""Two-phase issue confirmation (reference analysis/potential_issues.py:126).

Modules record PotentialIssues (predicate constraints, no tx model yet) in a
state annotation; at transaction end check_potential_issues re-solves
world_constraints + issue constraints and promotes survivors to Issues with
a concrete transaction sequence."""

import logging
from typing import List

from mythril_tpu_torch.laser.state.annotation import StateAnnotation
from mythril_tpu_torch.smt.solver.frontend import SolverTimeOutException, UnsatError

log = logging.getLogger(__name__)


class PotentialIssue:
    def __init__(
        self,
        contract,
        function_name,
        address,
        swc_id,
        title,
        bytecode,
        detector,
        severity,
        description_head,
        description_tail,
        constraints=None,
    ):
        self.title = title
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.severity = severity
        self.swc_id = swc_id
        self.bytecode = bytecode
        self.constraints = constraints or []
        self.detector = detector


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues: List[PotentialIssue] = []

    @property
    def search_importance(self):
        return 10 * len(self.potential_issues)

    def clone(self):
        # per-path copy: an issue detected on one branch must be confirmed
        # with THAT branch's world state at its transaction end, so the
        # concretized tx sequence matches the function the issue fired in
        # (reference deep-copies annotations with the state)
        dup = PotentialIssuesAnnotation()
        dup.potential_issues = list(self.potential_issues)
        return dup


def get_potential_issues_annotation(global_state) -> PotentialIssuesAnnotation:
    for annotation in global_state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation):
            return annotation
    annotation = PotentialIssuesAnnotation()
    global_state.annotate(annotation)
    return annotation


def _detector_cache_key(potential_issue):
    """(address, bytecode hash) — the detector's per-issue dedup key."""
    try:
        from mythril_tpu_torch.utils.keccak import keccak256

        raw = potential_issue.bytecode or b""
        if isinstance(raw, str):
            raw = bytes.fromhex(raw.removeprefix("0x"))
        bytecode_hash = "0x" + keccak256(raw).hex()
    except ValueError:
        bytecode_hash = ""
    return potential_issue.address, bytecode_hash


def check_potential_issues(global_state) -> None:
    """Called at transaction end (engine svm._end_transaction).

    Confirmation is two-stage: all candidate issues' feasibility checks
    (world constraints + issue predicate, a detection-critical verdict) go
    through ONE get_models_batch call first — the batched device fan-out the
    router size-buckets — and only the satisfiable survivors pay the full
    exploit concretization with lexicographic minimization. UNSAT/UNKNOWN
    candidates stay recorded: constraints may become satisfiable after a
    later transaction mutates state (reference potential_issues.py:97-99)."""
    annotation = get_potential_issues_annotation(global_state)
    unsatisfied = []
    candidates = []
    for potential_issue in annotation.potential_issues:
        # per-path annotation copies mean sibling end states each carry the
        # same recorded issue; once one path confirmed it (detector cache
        # hit, keyed like Issue.bytecode_hash), skip re-confirming the rest
        if _detector_cache_key(potential_issue) in potential_issue.detector.cache:
            continue
        candidates.append(potential_issue)

    if len(candidates) > 1:
        # batched pre-filter: one device-routable fan-out over every
        # candidate's feasibility cone. The pre-filter solves a SUBSET of
        # the final constraints (no calldata-size caps yet), so UNSAT here
        # soundly implies the full confirmation is UNSAT too; SAT survivors
        # still get the full minimized solve below (and its model now sits
        # in the model cache).
        from mythril_tpu_torch.service.scheduler import get_scheduler
        from mythril_tpu_torch.support.model import detection_context

        # a failure here raises (a device fault is never confirmed around
        # on the host); the JAX package logs it and confirms one by one
        with detection_context():
            # every candidate's feasibility cone rides the coalescing
            # scheduler: one window flush, one batched router fan-out
            # (crosscheck=None: resolved against the ambient detection
            # context at flush time — inside this `with`)
            outcomes = get_scheduler().solve_batch([
                (global_state.world_state.constraints
                 + candidate.constraints).get_all_constraints()
                for candidate in candidates
            ])
        survivors = []
        for candidate, (status, _model) in zip(candidates, outcomes):
            if status == "unsat":
                unsatisfied.append(candidate)
            else:
                survivors.append(candidate)
        candidates = survivors

    for potential_issue in candidates:
        # re-check the detector cache per candidate: an earlier confirm in
        # THIS loop may have cached the same (address, bytecode) key (two
        # recordings of one issue along a looping path) — without this the
        # duplicate would re-confirm and report twice
        if _detector_cache_key(potential_issue) in potential_issue.detector.cache:
            continue
        try:
            from mythril_tpu_torch.analysis.solver import get_transaction_sequence

            transaction_sequence = get_transaction_sequence(
                global_state,
                global_state.world_state.constraints + potential_issue.constraints,
            )
        except (UnsatError, SolverTimeOutException):
            # keep it: constraints may become satisfiable after a later
            # transaction mutates state (reference potential_issues.py:97-99)
            unsatisfied.append(potential_issue)
            continue
        from mythril_tpu_torch.analysis.report import Issue

        issue = Issue(
            contract=potential_issue.contract,
            function_name=potential_issue.function_name,
            address=potential_issue.address,
            title=potential_issue.title,
            bytecode=potential_issue.bytecode,
            swc_id=potential_issue.swc_id,
            severity=potential_issue.severity,
            description_head=potential_issue.description_head,
            description_tail=potential_issue.description_tail,
            transaction_sequence=transaction_sequence,
        )
        from mythril_tpu_torch.support.args import args

        if args.use_issue_annotations:
            # summaries mode: carry the proof obligation on the state so
            # the summary plugin can re-solve it under substitution
            from mythril_tpu_torch.analysis.issue_annotation import (
                IssueAnnotation,
            )
            from mythril_tpu_torch.smt import And

            global_state.annotate(IssueAnnotation(
                conditions=[And(
                    *(list(global_state.world_state.constraints)
                      + list(potential_issue.constraints))
                )],
                issue=issue,
                detector=potential_issue.detector,
            ))
        else:
            potential_issue.detector.issues.append(issue)
            potential_issue.detector.update_cache([issue])
    annotation.potential_issues = unsatisfied
