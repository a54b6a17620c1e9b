"""Static pre-analysis: bytecode passes ahead of LASER, and passes over
blasted instances ahead of the device solve.

  cfg, effects   one CFG + effect-summary pass per code object: module
                 gating (`modules_gated`), fork-prune hints
                 (`queries_avoided`) and the strategies' effect hints
  aig_opt        constant sweep + session strash rewrite of each prepared
                 cone (smt/solver/frontend._prepare)
  aig_partition  variable-disjoint components of a rewritten cone, each
                 dispatched on its own by the router (gpu/router.py)
  cnf_prep       unit propagation + pure literals over the CNF, and the
                 component split at the host-CDCL settle
  cubes          the cube-and-conquer plans of the device's second pass

MYTHRIL_GPU_PREANALYSIS=0 (or `args.no_preanalysis`) turns the subsystem
off; MYTHRIL_GPU_PREANALYSIS=1 force-enables it over the flag.
"""

import logging
import os
from typing import FrozenSet, Optional

from mythril_tpu_torch.preanalysis.effects import (  # noqa: F401 (public API)
    EFFECT_OPCODES,
    CodeSummary,
    FunctionEffects,
)

log = logging.getLogger(__name__)


def enabled() -> bool:
    """Master switch: env override first, then the no_preanalysis flag."""
    env = os.environ.get("MYTHRIL_GPU_PREANALYSIS", "")
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_preanalysis", False)


# -- per-code summaries (cached on the Disassembly object) -------------------


def get_code_summary(disassembly) -> Optional[CodeSummary]:
    """CodeSummary for a Disassembly, computed once and cached on the
    object (code objects are immutable). None for empty or symbolic code
    (deploy-time-patched bytes make the static sweep unreliable)."""
    if disassembly is None:
        return None
    cached = getattr(disassembly, "_preanalysis_summary", _MISS)
    if cached is not _MISS:
        return cached
    summary = None
    from mythril_tpu_torch import resilience

    try:
        if (isinstance(disassembly.bytecode, bytes) and disassembly.bytecode
                and not resilience.fuse_blown("preanalysis.summary")):
            from mythril_tpu_torch.observe.tracer import span as trace_span

            with trace_span("preanalysis.summary", cat="analyze",
                            code_bytes=len(disassembly.bytecode)):
                summary = CodeSummary(disassembly)
    except Exception:
        # pre-analysis must never break an analysis: degrade to "no info"
        # (nothing gated, every module attaches); repeated faults blow
        # the session fuse so a deterministic fault stops re-firing
        log.exception("preanalysis failed; continuing without summaries")
        resilience.note_stage_failure("preanalysis.summary")
        summary = None
    try:
        disassembly._preanalysis_summary = summary
    except AttributeError:
        pass
    return summary


# -- consumer 1: module gating -----------------------------------------------


def gating_opcodes(contract, dynloader=None) -> Optional[FrozenSet[str]]:
    """The statically-reachable opcode set usable for detector gating, or
    None when gating would be unsound / is disabled:

      - pre-analysis disabled
      - a dynamic loader is configured (other contracts' code can run)
      - creation-mode analysis (the installed runtime code is a run-time
        artifact; its opcode set is not statically known)
      - CFG recovery failed (unresolved dynamic jump: degrade to
        "everything reachable", gate nothing)
      - CREATE/CREATE2 reachable (deployed child code is unknowable)
    """
    if not enabled() or dynloader is not None:
        return None
    try:
        if contract.is_create_mode or not contract.code_bytes:
            return None
        summary = get_code_summary(contract.disassembly)
    except AttributeError:
        return None
    if summary is None or not summary.resolved:
        return None
    reachable = summary.reachable_opcodes
    if reachable & {"CREATE", "CREATE2"}:
        return None
    return reachable


# -- consumer 2: fork-prune hints --------------------------------------------


def _detector_interesting_opcodes() -> FrozenSet[str]:
    """Opcodes whose reachability makes a cone non-inert: state effects
    plus every registered detection module's TRIGGER opcodes (the opcodes
    a module needs executed to ever raise — or solve for — an issue).
    Computed once per process (the module registry is a singleton).

    Observer hooks (e.g. TxOrigin's JUMPI taint check) are deliberately
    NOT in this set: a state can ride pre-acquired taint into an
    observer hook inside an otherwise-inert cone and cost one wasted
    (UNSAT) confirmation solve — a bounded performance leak, never a
    finding, since every module's issue path is solver-confirmed and an
    unsat state confirms nothing."""
    global _interesting_cache
    if _interesting_cache is not None:
        return _interesting_cache
    from mythril_tpu_torch.analysis.module import EntryPoint, ModuleLoader
    from mythril_tpu_torch.analysis.module.util import module_trigger_opcodes

    ops = set(EFFECT_OPCODES)
    for module in ModuleLoader().get_detection_modules():
        if module.entry_point != EntryPoint.CALLBACK:
            continue
        if getattr(module, "symbolic_jump_only", False):
            # inert_at only holds over cones the CFG fully RESOLVED —
            # every jump target a push constant, so the engine sees
            # concrete (never symbolic) destinations and this module's
            # predicate can never pass inside the cone
            continue
        ops |= module_trigger_opcodes(module)
    _interesting_cache = frozenset(ops)
    return _interesting_cache


_interesting_cache: Optional[FrozenSet[str]] = None
_MISS = object()


def prune_check_skippable(global_state) -> bool:
    """True iff the stochastic fork-pruning feasibility solve for this
    state can be skipped (the state is KEPT unchecked — always
    findings-sound) without generating downstream solver traffic: the
    state is a top-level frame with no pending issue obligations, and
    every path from its pc to transaction end within its code object
    provably avoids state effects and detector hook opcodes."""
    if not enabled():
        return False
    stack = getattr(global_state, "transaction_stack", None)
    if not stack or len(stack) != 1 or stack[-1][1] is not None:
        return False  # inner frame: the caller's cone is not covered
    from mythril_tpu_torch.analysis.issue_annotation import IssueAnnotation
    from mythril_tpu_torch.analysis.potential_issues import (
        PotentialIssuesAnnotation,
    )

    for annotation in global_state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation) \
                and annotation.potential_issues:
            return False  # pending confirmations would solve at tx end
        if isinstance(annotation, IssueAnnotation):
            return False
    summary = get_code_summary(global_state.environment.code)
    if summary is None:
        return False
    return summary.inert_at(global_state.mstate.pc,
                            _detector_interesting_opcodes())


def reset_caches() -> None:
    """Drop the rewrite cache, the session strash table, the partition
    cache and the interesting-opcode set (support/model.clear_caches)."""
    global _interesting_cache
    from mythril_tpu_torch.preanalysis import aig_opt, aig_partition

    _interesting_cache = None
    aig_opt.reset_cache()
    aig_partition.reset_cache()
