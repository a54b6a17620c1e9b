"""FrontierStepper — the engine side of the vmapped frontier.

Sits in LaserEVM.exec between the strategy and execute_state. For each
state the strategy yields, it tries to execute the straight-line run at
the state's pc as ONE batched device step over every eligible sibling
(same code object, same pc) it can pull from the worklist. Everything the
per-state path would have done for those opcodes is either replicated
exactly (stack/memory/pc/gas, in the kernel), fired host-side once per
state (execute_state laser hooks and the first opcode's pre hooks —
eligibility requires every such hook to opt in), or provably a no-op for
straight-line fast-set runs (manage_cfg, fork pruning, depth accounting).

Hook contract (opt-in via function attributes):
  frontier_once_ok    an execute_state laser hook whose effect is
                      equivalent when fired once per run instead of once
                      per instruction (its condition only reads run-
                      invariant state, e.g. the transaction stack) —
                      fired host-side per state at run start.
  frontier_batch      optional companion: called once per successful
                      batched run with (completed_states, run) to replay
                      per-instruction accounting batch-wise (coverage
                      marks the whole run's pcs).
  frontier_transparent  a pre/post/instr hook that is purely
                      observational per-instruction telemetry and may be
                      skipped for batched runs (the instruction
                      profiler; the interp_opcode_wall_top histogram
                      covers the fallback path it still profiles).

Any unmarked execute_state hook disables the stepper for the whole
engine; any unmarked pre/post/instr hook on an opcode cuts runs before
that opcode — detection modules and pruners always see their states
individually.
"""

import logging
import random
import time
from typing import List, Optional

from mythril_tpu_torch.laser.frontier import dense, fastset, kernel, symlane
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState
from mythril_tpu_torch.observe.tracer import NULL_SPAN, span as trace_span

log = logging.getLogger(__name__)

# cap on sibling states per batched step (bounds encode latency; BFS
# worklists happily exceed this on dispatch fans)
MAX_BATCH = 64

_MISS = object()
# run-cache sentinel: no batchable run at this pc, but the NEXT
# instruction after one fast op is a JUMPI — a fork-capable site the
# current configuration leaves to the per-state interpreter (feature
# off / hook-gated / fork-less prefix below MIN_RUN_OPS). try_step
# counts the handoff as a fallback exit so the branch_fusion on/off
# legs expose exactly the exits device-side branching removes.
_FORK_SITE = object()
# likewise for symbolic-lane-capable sites (one fast op, then a
# RETURN/STOP halt or a CALLDATALOAD): no run compiled here, and the
# handoff is counted — dialect or symbolic-operand reason — so the
# symlane on/off legs expose exactly the exits the lane removes.
# (pc, reason) pairs; the pc disambiguates from _FORK_SITE handling.
_LANE_SITE_HALT = object()
_LANE_SITE_SYMBOLIC = object()
_LANE_SITES = (_LANE_SITE_HALT, _LANE_SITE_SYMBOLIC)


class StepResults(list):
    """try_step's successor list, carrying the opcode the exec loop must
    hand manage_cfg: None for straight-line runs (no CFG opcodes inside),
    "JUMPI" when the batch forked — the successors then get the same
    conditional-edge nodes the per-state JUMPI handler's states get.
    Plain list at every other call site."""

    op_code: Optional[str] = None


def _span_skipped(state, pc: int) -> bool:
    """True while `state` sits inside the run span it last exited (bailed
    mid-batch or failed encoding): the per-state interpreter owns it from
    the run start through end_pc (re-batching at every interior pc would
    cost O(run length) kernel launches per bail). The flag clears itself
    the first time the state is seen OUTSIDE the span, so a later
    loop-back into the same run — where the bail cause may no longer
    hold — batches again."""
    span = getattr(state, "_frontier_skip_span", None)
    if span is None:
        return False
    if span[0] <= pc < span[1]:
        return True
    state._frontier_skip_span = None
    return False


class FrontierStepper:
    def __init__(self, svm):
        from mythril_tpu_torch.laser import frontier

        self.svm = svm
        # numpy on the host, cuda (K6) on the card, torch the plain
        # version (kernel.resolve_backend); the device the step runs on
        self.backend = kernel.resolve_backend()
        self.device = kernel.backend_device(self.backend)
        self._runs = {}          # (bytecode_hash, pc) -> Run | None
        self._blocked = {}       # opcode name -> interior-blocked bool
        self._guards = {}        # opcode name -> predicates tuple | None
        self._engine_ok: Optional[bool] = None
        # device-side branching: fork symbolic JUMPI batch-wise
        # (MYTHRIL_GPU_FRONTIER_FORK / --no-frontier-fork, on top of the
        # vmap-frontier switch); the depth cap bounds how deep batched
        # forking applies (0 = uncapped — the per-state path has no cap,
        # this is an operator brake on fork fan-out)
        self.fork_enabled = frontier.fork_enabled()
        self.fork_depth_cap = frontier.fork_depth_cap()
        self._fork_ok: Optional[bool] = None
        # symbolic-value lanes (MYTHRIL_GPU_FRONTIER_SYMLANE): opaque
        # term-handle slots ride compute ops via the structural replay,
        # CALLDATALOAD promotes in-batch, RETURN/STOP become terminal
        # micro-ops the halt epilogue settles host-side
        self.symlane = frontier.symlane_enabled()
        # cross-fork re-batching (MYTHRIL_GPU_FRONTIER_MULTIPC): fork
        # cohorts chain through their next dense run without the
        # one-iteration worklist stall; the width caps how many cohort
        # groups one top-level step may chain
        self.multipc_width = frontier.multipc_width()
        self._chain_depth = 0
        self._chain_budget = 0
        log.debug("frontier stepper ready (backend=%s, fork=%s, "
                  "symlane=%s, multipc=%d)", self.backend,
                  self.fork_enabled, self.symlane, self.multipc_width)

    # -- engine / hook gates -------------------------------------------------

    def _check_engine(self) -> bool:
        """All execute_state laser hooks must be frontier-aware; checked
        once (hooks are registered before sym_exec starts)."""
        if self._engine_ok is None:
            self._engine_ok = all(
                getattr(hook, "frontier_once_ok", False)
                for hook in self.svm._hooks["execute_state"]
            )
            if not self._engine_ok:
                log.debug("frontier disabled: unmarked execute_state hook")
        return self._engine_ok

    def _hook_entries(self, tables, name):
        for table in tables:
            entries = table.get(name)
            if entries:
                for hook in entries:
                    yield hook

    def _interior_blocked(self, name: str) -> bool:
        cached = self._blocked.get(name)
        if cached is None:
            svm = self.svm
            cached = any(
                not getattr(hook, "frontier_transparent", False)
                for hook in self._hook_entries(
                    (svm.pre_hooks, svm.post_hooks,
                     svm.instr_pre_hook, svm.instr_post_hook), name)
            )
            self._blocked[name] = cached
        return cached

    def _interior_guards(self, name: str) -> Optional[tuple]:
        """Value predicates when EVERY non-transparent hook on `name` is
        conditionally transparent (frontier_transparent_unless): the op
        may enter a run guarded — a row whose written value trips a
        predicate bails and replays per-state, where the hook fires.
        None when any hook is unconditionally opaque."""
        cached = self._guards.get(name, _MISS)
        if cached is not _MISS:
            return cached
        svm = self.svm
        predicates = []
        for hook in self._hook_entries(
                (svm.pre_hooks, svm.post_hooks,
                 svm.instr_pre_hook, svm.instr_post_hook), name):
            if getattr(hook, "frontier_transparent", False):
                continue
            predicate = getattr(hook, "frontier_transparent_unless", None)
            if predicate is None:
                predicates = None
                break
            predicates.append(predicate)
        result = tuple(predicates) if predicates is not None else None
        self._guards[name] = result
        return result

    def _fork_allowed(self) -> bool:
        """Batched JUMPI forking is available: the feature switch is on
        and JUMPI carries no non-transparent POST hooks. Pre hooks are
        fine — the fork epilogue fires them host-side on the exact
        pre-JUMPI state, as execute_state would — but the per-state path
        fires post hooks on BOTH sides before the exec loop's
        feasibility prune, and the whole point of the fused path is to
        mask infeasible sides before they materialize."""
        if self._fork_ok is None:
            svm = self.svm
            self._fork_ok = self.fork_enabled and not any(
                not getattr(hook, "frontier_transparent", False)
                for hook in self._hook_entries(
                    (svm.post_hooks, svm.instr_post_hook), "JUMPI")
            )
        return self._fork_ok

    def _first_post_blocked(self, name: str) -> bool:
        svm = self.svm
        return any(
            not getattr(hook, "frontier_transparent", False)
            for hook in self._hook_entries(
                (svm.post_hooks, svm.instr_post_hook), name)
        )

    # -- run cache -----------------------------------------------------------

    def _run_for(self, code, pc: int) -> Optional[fastset.Run]:
        key = (code.bytecode_hash, pc)
        cached = self._runs.get(key, _MISS)
        if cached is not _MISS:
            return cached
        run = None
        # cheap peek before paying full extraction: most pcs are visited
        # once per leg (the cache rarely amortizes), and most fail
        # because fewer than MIN_RUN_OPS fast opcodes follow — a set
        # probe over the next few instruction names settles that at a
        # fraction of the compile cost
        if self._peek_fast(code, pc):
            from mythril_tpu_torch import preanalysis

            summary = preanalysis.get_code_summary(code)
            if summary is not None:
                run = fastset.extract_run(
                    summary, pc, self._interior_blocked,
                    self._first_post_blocked,
                    guards_for=self._interior_guards,
                    allow_fork=self._fork_allowed(),
                    allow_halt=self.symlane,
                    allow_symbolic=self.symlane)
        if run is None:
            site = self._minimal_site(code, pc)
            if site is not None:
                run = site
        self._runs[key] = run
        return run

    @staticmethod
    def _minimal_site(code, pc: int):
        """One fast op, then a lane-capable terminator: the minimal
        batched run's shape. When no run compiled here the interpreter
        takes the op — exactly the exit the fork / symbolic-lane
        features exist to remove, so the handoff is counted (by
        reason) for the on/off comparators."""
        index = code.index_of_address(pc)
        if index is None or index + 1 >= len(code.instruction_list):
            return None
        instrs = code.instruction_list
        if not fastset.is_fast_op(instrs[index].opcode):
            return None
        follower = instrs[index + 1].opcode
        if follower == "JUMPI":
            return _FORK_SITE
        if follower in ("RETURN", "STOP"):
            return _LANE_SITE_HALT
        if follower == "CALLDATALOAD":
            return _LANE_SITE_SYMBOLIC
        return None

    def _peek_fast(self, code, pc: int) -> bool:
        index = code.index_of_address(pc)
        if index is None:
            return False
        instrs = code.instruction_list
        fork_ok = self._fork_allowed()
        lane_ok = self.symlane
        seen_calldataload = False
        for k in range(fastset.MIN_RUN_OPS):
            if index + k >= len(instrs):
                return False
            name = instrs[index + k].opcode
            if fork_ok and name == "JUMPI":
                # a fork terminal satisfies the peek with any fast
                # prefix at all (the batched fork is the win even on
                # short runs)
                return k >= 1
            if lane_ok and name in ("RETURN", "STOP"):
                # a halt terminal satisfies the peek even BARE (a
                # cohort landing on a STOP settles through the halt
                # epilogue with no kernel work)
                return True
            if lane_ok and name == "CALLDATALOAD":
                # promoted op: a calldataload-bearing run is worth a
                # batch at 2 ops (extraction enforces the floor), so
                # any fast prefix before it — or any fast op after a
                # LEADING calldataload — satisfies the peek
                if k >= 1:
                    return True
                seen_calldataload = True
                continue
            if not fastset.is_fast_op(name):
                # [CALLDATALOAD, fast-op, blocked] still compiles a
                # 2-op promoted run — only a sub-2-op shape fails
                return seen_calldataload and k >= 2
        return True

    # -- sibling scheduling --------------------------------------------------

    def _loop_vetter(self):
        """The bounded-loops wrapper's per-yield accounting, if present in
        the strategy chain — sibling states bypass strategy.__next__, so
        the stepper must apply the same vetting or loops run unbounded."""
        strategy = self.svm.strategy
        while strategy is not None:
            vet = getattr(strategy, "vet_state", None)
            if vet is not None:
                return vet
            strategy = getattr(strategy, "super_strategy", None)
        return None

    def _admit(self, state, run):
        """Per-row batch admission: ("kernel", None) for the exact
        kernel decode, ("sym", None) for the symbolic lane's structural
        replay, or (None, fallback-reason bucket). The prechecks run
        ONCE here (state_encodable would re-run them — and rebuild the
        dense memory window — per sibling)."""
        reason = dense.state_prechecks(state, run)
        if reason is not None:
            return None, reason
        if self.symlane:
            return symlane.admit(state, run)
        if dense.consumed_windows_concrete(state, run):
            return "kernel", None
        return None, "symbolic"

    def _collect_siblings(self, lead, run, plans) -> List:
        svm = self.svm
        # bytecode-hash equality, not object identity: sibling states of
        # one contract share the Disassembly, but separately-loaded equal
        # code executes identically and batches just as well
        code_hash = lead.environment.code.bytecode_hash
        pc = lead.mstate.pc
        vet = self._loop_vetter()
        batch = [lead]
        kept = []
        taken = 0
        for state in svm.work_list:
            verdict = None
            if (taken < MAX_BATCH - 1
                    and state.mstate.pc == pc
                    and state.environment.code.bytecode_hash == code_hash
                    and state.mstate.depth < svm.max_depth
                    and self._span_allows(state, pc, run)
                    and self._fork_admissible(state, run)):
                verdict, _reason = self._admit(state, run)
            if verdict is not None:
                if vet is not None and not vet(state):
                    # loop bound exceeded: dropped exactly as the
                    # strategy's own filter would have dropped it
                    taken += 1
                    continue
                plans[id(state)] = verdict
                batch.append(state)
                taken += 1
            else:
                kept.append(state)
        if taken:
            svm.work_list[:] = kept
        return batch

    def _retract_loop_visit(self, state, run) -> None:
        """A bailed state will be re-yielded at the SAME pc and vetted by
        the bounded-loops wrapper again — but its JUMPDEST trace entry
        for this visit was already appended (by the strategy yield for
        the lead, by _collect_siblings' vetting for siblings). Pop it so
        one real visit counts once, or loop bounds would trip at half the
        true iteration count on repeatedly-bailing runs."""
        if run.first_instr.opcode != "JUMPDEST" \
                or self._loop_vetter() is None:
            return
        from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
            JumpdestCountAnnotation,
        )

        for annotation in state.annotations:
            if isinstance(annotation, JumpdestCountAnnotation):
                if annotation.trace and annotation.trace[-1] == \
                        run.start_pc:
                    annotation.trace.pop()
                return

    # -- the batched step ----------------------------------------------------

    def try_step(self, lead) -> Optional[List]:
        """Batched-step the run at `lead`'s pc. Returns the successor
        list (completed states at the run-end pc + bailed states,
        untouched, flagged to replay per-state), or None when the normal
        per-state path must handle `lead`."""
        if not self._check_engine():
            return None
        from mythril_tpu_torch import resilience

        if resilience.fuse_blown("frontier.step"):
            # disable-for-session degradation: repeated batch-path faults
            # blew the fuse; the per-state interpreter owns every state
            return None
        pc = lead.mstate.pc
        # a pc past the code end (implicit STOP) has no instruction index
        # and falls out of _run_for's peek — the per-state path owns it
        run = self._run_for(lead.environment.code, pc)
        if run is None:
            _span_skipped(lead, pc)  # self-clears once outside the span
            return None
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        if run is _FORK_SITE:
            # fork-capable site the configuration leaves per-state: the
            # interpreter takes this branch (one visit, one exit)
            SolverStatistics().add_fork_site_exit(reason="dialect")
            return None
        if run is _LANE_SITE_HALT:
            # halt-capable site left per-state (symbolic lane off, or
            # no compilable prefix): the interpreter ends the frame
            SolverStatistics().add_fork_site_exit(reason="dialect")
            return None
        if run is _LANE_SITE_SYMBOLIC:
            # CALLDATALOAD site left per-state: the symbolic-operand
            # exit the lane exists to remove
            SolverStatistics().add_fork_site_exit(reason="symbolic")
            return None
        if not self._span_allows(lead, pc, run):
            return None
        verdict = None
        if self._fork_admissible(lead, run):
            verdict, refusal = self._admit(lead, run)
        else:
            refusal = "dialect"  # depth-capped fork: operator brake
        if verdict is None:
            if (run.fork is not None or run.halt is not None) \
                    and len(run.ops) == 2:
                # the MINIMAL fork/halt run refused a row: no shorter
                # retry site exists before the terminator — a real exit
                SolverStatistics().add_fork_site_exit(reason=refusal)
            lead._frontier_skip_span = (run.start_pc, run.end_pc)
            return None
        if self._chain_depth == 0:
            # top-level entry: arm the cross-fork re-batching budget
            # (consumed by _rebatch_cohorts, bounding how many cohort
            # groups may chain under this one strategy yield)
            self._chain_budget = self.multipc_width
        with trace_span("laser.frontier_step", cat="laser", pc=pc) as sp:
            self._chain_depth += 1
            try:
                return self._step_batch(lead, run, sp, verdict)
            finally:
                self._chain_depth -= 1

    @staticmethod
    def _span_allows(state, pc: int, run) -> bool:
        """Skip-span check that does NOT let a longer run's span eat a
        terminal: a state that failed encoding at a block-head run (its
        consumed slots held symbolic calldata) gets a span covering the
        whole block tail, but the SHORT fork/halt run at the terminator
        — dispatch ladders are exactly [PUSH dest, JUMPI] after a
        per-state EQ — may still batch. A terminal run whose OWN start
        pc set the span (a genuine batch bail) still defers to the
        per-state interpreter, so a persistently-bailing row costs one
        batch attempt per pc, never a loop."""
        if not _span_skipped(state, pc):
            return True
        if run.fork is None and run.halt is None:
            return False
        span = state._frontier_skip_span
        return span is not None and span[0] != pc

    def _fork_admissible(self, state, run) -> bool:
        """Fork-depth cap (MYTHRIL_GPU_FRONTIER_FORK_DEPTH, 0 =
        uncapped): rows past the cap take the per-state JUMPI instead of
        the batched fork — an operator brake on fork fan-out, never a
        semantic change (the interpreter forks them identically)."""
        if run.fork is None or not self.fork_depth_cap:
            return True
        return state.mstate.depth < self.fork_depth_cap

    def _step_batch(self, lead, run, sp=NULL_SPAN,
                    lead_verdict: str = "kernel") -> Optional[List]:
        """The batched step itself (traced as laser.frontier_step)."""
        svm = self.svm
        plans = {id(lead): lead_verdict}
        batch = self._collect_siblings(lead, run, plans)

        # host-side per-state prologue: execute_state hooks (all
        # frontier_once_ok), the run-start statespace snapshot, and the
        # first opcode's non-transparent pre hooks
        first_name = run.first_instr.opcode
        first_pre = [
            hook for hook in self._hook_entries(
                (svm.pre_hooks, svm.instr_pre_hook), first_name)
            if not getattr(hook, "frontier_transparent", False)
        ]
        survivors = []
        snapshots = {}
        for state in batch:
            try:
                for hook in svm._hooks["execute_state"]:
                    hook(state)
            except PluginSkipState:
                continue
            if svm.requires_statespace and state.node is not None:
                # capture the run-start snapshot NOW (it must show the
                # pre-run stack) but commit it only if the state
                # completes the batch — a bailed state re-records when
                # it replays per-state, and committing both would
                # duplicate the snapshot
                from mythril_tpu_torch.laser.svm import _StateSnapshot

                snapshots[id(state)] = (
                    state.node, _StateSnapshot(state, run.first_instr))
            try:
                for hook in first_pre:
                    hook(state)
            except PluginSkipState:
                continue
            survivors.append(state)
        if not survivors:
            return []

        # the registered fault site frontier.step: a fault in encode or in
        # a host step sends every collected survivor down the existing
        # bail path — untouched original states, flagged to replay the
        # whole run per-state — so it can cost wall, never a state or a
        # finding; repeated faults blow the session fuse. A fault of the
        # CUDA step (an injected one included) is not replayed: it is
        # recorded as a DeviceFault and stops the analysis, as K1's do
        from mythril_tpu_torch import resilience

        on_device = self.backend == "cuda"
        try:
            if not on_device:
                resilience.maybe_inject("frontier.step")
            # the lane's tag/handle capture costs a window snapshot per
            # row: build it only when some collected row actually takes
            # the structural-replay decode
            lane_rows = any(verdict == "sym" for verdict in plans.values())
            frame = dense.encode_frontier(survivors, run, lane=lane_rows)
            if not on_device:
                outputs = kernel.step_batch(run, frame, self.backend,
                                            self.device)
        except Exception:
            log.warning("frontier batch step failed; per-state replay for "
                        "%d state(s)", len(survivors), exc_info=True)
            resilience.note_stage_failure("frontier.step")
            for state in survivors:
                state._frontier_skip_span = (run.start_pc, run.end_pc)
                self._retract_loop_visit(state, run)
            return StepResults(survivors)
        if on_device:
            from mythril_tpu_torch.gpu.device import record_fault

            try:
                resilience.maybe_inject("frontier.step")
                outputs = kernel.step_batch(run, frame, self.backend,
                                            self.device)
            except Exception as error:
                raise record_fault(error) from error
        (stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log,
         fork_out) = outputs

        results = StepResults()
        completed = []
        pending_forks = []  # dense.PendingFork per forked row, in order
        halt_rows = []      # (state, popped halt operands) per halt row
        bails_dynamic = bails_hook = bails_symbolic = 0
        sym_rows = 0
        for i, state in enumerate(survivors):
            plan = plans.get(id(state), "kernel")
            row_ok = bool(ok[i])
            bail_reason = "dynamic"
            if row_ok and run.mem_guards and dense.guard_tripped(
                    run, mem_log, i):
                # a conditionally-transparent hook is NOT inert for this
                # row's written value (hevm marker): replay per-state so
                # the hook fires exactly as it always did
                row_ok = False
                bail_reason = "hook"
            rep = None
            if row_ok and plan == "sym":
                # symbolic lane: replay the structural op log over the
                # row's ORIGINAL window objects — the opaque lanes'
                # terms, bit-identical to the interpreter's handlers.
                # A replay fault degrades the row to per-state replay,
                # never to a wrong term.
                try:
                    rep = symlane.replay(state, run,
                                         window=frame.handles[i])
                except Exception:
                    log.warning("symbolic-lane replay failed; per-state "
                                "replay", exc_info=True)
                    row_ok = False
            fork_operands = None
            halt_operands = ()
            if row_ok and run.fork is not None:
                from mythril_tpu_torch.laser.instructions import concrete_or_none

                # read the popped (dest, cond) objects BEFORE decode
                # rebuilds the stack window; a symbolic destination
                # bails the row pre-decode so the untouched original
                # replays per-state and raises the exact
                # InvalidJumpDestination the interpreter raises
                fork_operands = (rep.terminal if rep is not None else
                                 dense.fork_operands(state, run,
                                                     fork_out, i))
                if concrete_or_none(fork_operands[0]) is None:
                    row_ok = False
                    bail_reason = "symbolic"
            if row_ok and run.halt is not None \
                    and run.halt.kind == "return":
                halt_operands = (rep.terminal if rep is not None else
                                 dense.halt_operands(state, run,
                                                     fork_out, i))
            if row_ok:
                if rep is not None:
                    symlane.decode_sym_state(state, run, rep, mem_log,
                                             msize, min_gas, max_gas, i)
                    sym_rows += 1
                else:
                    dense.decode_state(state, run, stack_out, mem,
                                       written, msize, min_gas, max_gas,
                                       i, mem_log=mem_log)
                snapshot = snapshots.get(id(state))
                if snapshot is not None:
                    snapshot[0].states.append(snapshot[1])
                completed.append(state)
                if run.fork is not None:
                    pf = self._fork_row(state, run, fork_operands)
                    if pf is not None:
                        pending_forks.append(pf)
                    # pf None: PluginSkipState from a JUMPI pre hook —
                    # the row completes with no successors, exactly as
                    # execute_state returns [] on a skipped state
                elif run.halt is not None:
                    halt_rows.append((state, halt_operands))
                else:
                    results.append(state)
            else:
                # replay the WHOLE run on the per-state interpreter from
                # the untouched original state; the span flag keeps every
                # pc of this run off the batch path for it
                state._frontier_skip_span = (run.start_pc, run.end_pc)
                self._retract_loop_visit(state, run)
                if bail_reason == "hook":
                    bails_hook += 1
                elif bail_reason == "symbolic":
                    bails_symbolic += 1
                else:
                    bails_dynamic += 1
                results.append(state)

        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        # completed rows of a run that CUT at an unforked JUMPI or an
        # unpromoted RETURN/STOP exit the batch dialect to the
        # interpreter (dialect reason); rows cutting at a CALLDATALOAD
        # the lane was off for are symbolic-operand exits — on top of
        # being stepped rows, so the branch_fusion / symlane on/off
        # legs expose exactly the exits each feature removes
        cut_exits = symbolic_cuts = 0
        if run.fork is None and run.halt is None:
            if run.cut_at_jumpi or run.cut_at_halt:
                cut_exits = len(completed)
            elif run.cut_at_calldataload:
                symbolic_cuts = len(completed)
        stats.add_frontier_step(
            states=len(completed), slots=len(survivors),
            fallback_exits=bails_dynamic, cut_exits=cut_exits,
            hook_exits=bails_hook, symbolic_exits=bails_symbolic,
            symbolic_cuts=symbolic_cuts, sym_rows=sym_rows)
        sp.set(states=len(completed), slots=len(survivors),
               fallbacks=(bails_dynamic + bails_hook + bails_symbolic
                          + cut_exits + symbolic_cuts),
               ops=len(run.ops), sym_rows=sym_rows)
        if completed:
            for hook in svm._hooks["execute_state"]:
                replay = getattr(hook, "frontier_batch", None)
                if replay is not None:
                    replay(completed, run)
        if run.halt is not None:
            successors = self._halt_epilogue(run, halt_rows)
            if not completed:
                # every row bailed: pure replay, the straight-line bail
                # shape (no RETURN/STOP executed)
                return results
            # bailed rows replay per-state and re-enter the worklist
            # directly — the exec loop's new_states must carry only the
            # frame successors (manage_cfg gives them RETURN nodes; a
            # bailed, untouched original must not get one)
            if results:
                svm.work_list.extend(results)
            results = StepResults(successors)
            results.op_code = ("RETURN" if run.halt.kind == "return"
                               else "STOP")
            return results
        if run.fork is not None:
            successors = self._fork_epilogue(run, pending_forks)
            if not completed and not successors:
                # every row bailed: pure replay, exactly the
                # straight-line bail shape (no JUMPI executed)
                return results
            # bailed rows replay per-state and re-enter the worklist
            # directly — the exec loop's new_states must carry only the
            # fork successors (manage_cfg gives them JUMPI nodes; a
            # bailed, untouched original must not get one)
            if results:
                svm.work_list.extend(results)
            results = StepResults(successors)
            results.op_code = "JUMPI"
            if successors and self.multipc_width and self._chain_budget:
                # cross-fork re-batching: both cohorts stay dense
                # through their next run instead of re-entering the
                # worklist for one serialized iteration
                results = StepResults(self._rebatch_cohorts(successors))
        return results

    # -- the batched fork (device-side branching) ---------------------------

    def _fork_pre_hooks(self) -> List:
        hooks = getattr(self, "_fork_pre", None)
        if hooks is None:
            svm = self.svm
            hooks = [
                hook for hook in self._hook_entries(
                    (svm.pre_hooks, svm.instr_pre_hook), "JUMPI")
                if not getattr(hook, "frontier_transparent", False)
            ]
            self._fork_pre = hooks
        return hooks

    def _terminal_prologue(self, state, pc: int, operands, hooks,
                           run) -> bool:
        """Mirror of execute_state at a run terminator, shared by the
        fork and halt rows: reconstruct the exact pre-terminal machine
        state (`operands` pushed back in the given order, pc at the
        instruction), record the statespace snapshot, fire the
        non-transparent pre hooks host-side, pop the operands back.
        Returns False when a hook skipped the state (no successors, as
        execute_state returns [])."""
        svm = self.svm
        mstate = state.mstate
        mstate.pc = pc
        for entry in operands:
            mstate.stack.append(entry)
        if svm.requires_statespace and state.node is not None:
            from mythril_tpu_torch.laser.svm import _StateSnapshot

            code = state.environment.code
            index = code.index_of_address(pc)
            instr = (code.instruction_list[index]
                     if index is not None else run.first_instr)
            state.node.states.append(_StateSnapshot(state, instr))
        skipped = False
        try:
            for hook in hooks:
                hook(state)
        except PluginSkipState:
            skipped = True
        for _ in operands:
            mstate.stack.pop()
        return not skipped

    def _fork_row(self, state, run, operands):
        """Per-row JUMPI prologue: the terminal reconstruction above
        (condition below destination, as the handler's pops see them),
        then pop into a pending-fork entry. None when a hook skipped
        the state."""
        dest_obj, cond_obj = operands
        fired = self._terminal_prologue(state, run.fork.pc,
                                        (cond_obj, dest_obj),
                                        self._fork_pre_hooks(), run)
        state.mstate.pc = run.end_pc
        if not fired:
            return None
        return dense.build_pending_fork(state, dest_obj, cond_obj)

    # -- the batched halt (terminal RETURN/STOP micro-ops) -------------------

    def _halt_epilogue(self, run, halt_rows) -> List:
        """Mirror of execute_state at the halting instruction for every
        completed row: reconstruct the exact pre-halt machine state
        (operands back on the stack, pc at the RETURN/STOP), record the
        statespace snapshot, fire the non-transparent pre hooks
        host-side, then drive the interpreter's own transaction-end
        machinery — return-data built from the POST-decode memory via
        Memory.get_byte, so symbolic bytes the run stored come out as
        the exact terms the interpreter's RETURN would read — with
        execute_state's signal handling (TransactionEndSignal ->
        _end_transaction, VmException -> frame revert) and its post-hook
        kept-loop, verbatim. Deliberately NOT timed into the
        interp_opcode_wall histogram: these rows no longer take the
        per-state path, which is the point."""
        if not halt_rows:
            return []
        op_name = "RETURN" if run.halt.kind == "return" else "STOP"
        pre_hooks, post_hooks = self._halt_hook_lists(op_name)
        # a BARE halt run (no prefix ops) already fired the terminal's
        # pre hooks and committed its snapshot in the batch prologue —
        # the halting instruction IS the run's first instruction, and
        # the prologue saw the exact pre-halt stack; re-firing here
        # would double every hook and snapshot
        bare = len(run.ops) == 1
        successors = []
        for state, operands in halt_rows:
            if bare:
                state.mstate.pc = run.halt.pc
            else:
                push = ()
                if op_name == "RETURN":
                    offset_obj, length_obj = operands
                    push = (length_obj, offset_obj)  # offset on top
                if not self._terminal_prologue(state, run.halt.pc,
                                               push, pre_hooks, run):
                    continue  # no successors, as execute_state returns []
            for successor in self._run_halting_op(state, op_name,
                                                  operands):
                try:
                    for hook in post_hooks:
                        hook(successor)
                except PluginSkipState:
                    continue
                successors.append(successor)
        return successors

    def _halt_hook_lists(self, op_name: str):
        """Cached non-transparent (pre, post) hook lists for a halting
        opcode — the _fork_pre_hooks discipline; registration precedes
        sym_exec, so the lists never change within a run."""
        cached = getattr(self, "_halt_hooks", None)
        if cached is None:
            cached = self._halt_hooks = {}
        lists = cached.get(op_name)
        if lists is None:
            svm = self.svm
            lists = (
                [hook for hook in self._hook_entries(
                    (svm.pre_hooks, svm.instr_pre_hook), op_name)
                 if not getattr(hook, "frontier_transparent", False)],
                [hook for hook in self._hook_entries(
                    (svm.post_hooks, svm.instr_post_hook), op_name)
                 if not getattr(hook, "frontier_transparent", False)],
            )
            cached[op_name] = lists
        return lists

    def _run_halting_op(self, state, op_name: str, operands) -> List:
        """RETURN/STOP semantics for one reconstructed row, with
        execute_state's exception arms: the interpreter's own
        transaction machinery does all the work, so frame reverts,
        caller resumption, world-state harvesting and potential-issue
        checks are the per-state path's code, not a copy. Halting ops
        charge no opcode gas (the signal propagates before
        instructions.execute's accrual — the terminal micro-op's spec
        gas is 0 on both bounds), and RETURN's memory-expansion fee is
        charged here by the same mem_extend call the handler makes."""
        svm = self.svm
        from mythril_tpu_torch.laser.evm_exceptions import VmException
        from mythril_tpu_torch.laser.instructions import concrete_or_none
        from mythril_tpu_torch.laser.state.return_data import ReturnData
        from mythril_tpu_torch.laser.transaction.models import (
            TransactionEndSignal,
        )

        try:
            try:
                transaction = state.current_transaction
                if op_name == "STOP":
                    transaction.end(state, return_data=None, revert=False)
                else:
                    offset_obj, length_obj = operands
                    # both dynamically concrete by admission (an opaque
                    # operand bailed the row to the per-state path,
                    # where the handler concretizes via the solver)
                    length_c = min(concrete_or_none(length_obj), 0x10000)
                    offset_c = concrete_or_none(offset_obj)
                    if length_c:
                        state.mstate.mem_extend(offset_c, length_c)
                    data = [
                        state.mstate.memory.get_byte(offset_c + k)
                        for k in range(length_c)
                    ]
                    transaction.end(
                        state, return_data=ReturnData(data, length_c))
                return []  # unreachable: transaction.end always raises
            except VmException as error:
                # exceptional halt: the frame reverts, exactly as the
                # exec loop's VmException arm handles it
                transaction, return_snapshot = \
                    state.transaction_stack[-1]
                svm._fire_transaction_end_hooks(
                    state, transaction, return_snapshot, True)
                return svm.handle_vm_exception(
                    state, op_name, str(error))[0]
        except TransactionEndSignal as signal:
            return svm._end_transaction(state, signal, op_name)

    # -- cross-fork re-batching (multi-pc) -----------------------------------

    def _rebatch_cohorts(self, successors) -> List:
        """Both forked cohorts stay dense through their NEXT run
        instead of re-entering the worklist for one serialized
        iteration: the fork step's successor set is a multi-pc batch
        keyed on (code-hash, pc-set) — each distinct pc's cohort (the
        groups the dense frame's per-row pc table already names)
        chains through its own compiled run right here, bounded by the
        MYTHRIL_GPU_FRONTIER_MULTIPC budget armed at the top-level
        step. manage_cfg runs FIRST with the fork's op code, so every
        successor gets the exact JUMPI conditional-edge node exec
        would have assigned — the chained results then return to exec
        with op_code None and are never node-managed twice. Cohort
        leads pass the same bounded-loops vetting a strategy yield
        applies; siblings are vetted by _collect_siblings as usual."""
        svm = self.svm
        svm.manage_cfg("JUMPI", successors)
        vet = self._loop_vetter()
        groups = {}
        for state in successors:
            key = (state.environment.code.bytecode_hash,
                   state.mstate.pc)
            groups.setdefault(key, []).append(state)
        out = []
        for group in groups.values():
            if self._chain_budget <= 0:
                out.extend(group)
                continue
            probe = self._run_for(group[0].environment.code,
                                  group[0].mstate.pc)
            if probe is None or probe is _FORK_SITE \
                    or probe in _LANE_SITES:
                # nothing batchable here; site-exit accounting happens
                # when the strategy yields these states normally
                out.extend(group)
                continue
            pending = list(group)
            lead = None
            while pending:
                candidate = pending.pop(0)
                if candidate.mstate.depth >= svm.max_depth:
                    # past the depth bound: hand it back unchained so
                    # the strategy discards it on yield, exactly as the
                    # per-state path would — chaining it would execute
                    # a run the depth filter forbids
                    out.append(candidate)
                    continue
                if vet is None or vet(candidate):
                    lead = candidate
                    break
                # loop bound exceeded: dropped exactly as the
                # strategy's own filter would have dropped it
            if lead is None:
                continue
            self._chain_budget -= 1
            mark = len(svm.work_list)
            svm.work_list.extend(pending)
            stepped = self.try_step(lead)
            if stepped is None:
                # the lead could not batch after all: undo — retract
                # the vet's trace entry (the strategy will vet again on
                # yield) and hand the whole cohort back to the caller
                restored = svm.work_list[mark:]
                del svm.work_list[mark:]
                self._retract_chain_vet(lead)
                out.append(lead)
                out.extend(restored)
            else:
                # a chained step's own terminal results still carry an
                # op code (an inner fork past the budget, a halt run's
                # frame successors): run the node management exec would
                # have run — dropping it here loses the conditional-
                # edge nodes AND the function-entry naming that rides
                # them (found as findings attributed to "fallback" on
                # the dispatch ladder)
                inner_op = getattr(stepped, "op_code", None)
                if inner_op is not None:
                    svm.manage_cfg(inner_op, stepped)
                # non-collected siblings stay in the worklist (unvetted
                # — the strategy vets them on yield, as for any
                # successor set exec extends)
                out.extend(stepped)
        return out

    def _retract_chain_vet(self, state) -> None:
        """A chained cohort lead that failed to batch will be re-vetted
        when the strategy yields it — pop the trace entry this chain's
        vet appended so one real visit counts once (the sibling-side
        twin of _retract_loop_visit)."""
        instruction = state.instruction
        if instruction is None or instruction.opcode != "JUMPDEST" \
                or self._loop_vetter() is None:
            return
        from mythril_tpu_torch.laser.strategy.extensions.bounded_loops import (
            JumpdestCountAnnotation,
        )

        for annotation in state.annotations:
            if isinstance(annotation, JumpdestCountAnnotation):
                if annotation.trace \
                        and annotation.trace[-1] == state.mstate.pc:
                    annotation.trace.pop()
                return

    def _prune_decision(self) -> str:
        """The exec loop's fork-pruning policy, verbatim (one random
        draw per fork batch instead of per row — pruning is sound either
        way, so the draw granularity cannot move a finding)."""
        from mythril_tpu_torch.support.args import args

        svm = self.svm
        pruning_factor = args.pruning_factor
        if pruning_factor is None:
            pruning_factor = 1.0 if svm.execution_timeout > 300 else 0.0
        if (pruning_factor > 0.0 and svm.strategy.run_check()
                and random.random() < pruning_factor):
            return "solve"
        if not svm.strategy.run_check():
            return "park"
        return "keep"

    def _side_skippable(self, pf, run, fall: bool) -> bool:
        """preanalysis.prune_check_skippable for one PENDING side without
        materializing it: everything the check reads (frame stack,
        annotations, code, pc) is shared with the row's state except the
        pc, which is swapped in for the probe."""
        if self.svm.preanalysis is None:
            return False
        from mythril_tpu_torch import preanalysis as pre_mod

        state = pf.state
        old_pc = state.mstate.pc
        state.mstate.pc = run.end_pc if fall else pf.dest
        try:
            return pre_mod.prune_check_skippable(state)
        finally:
            state.mstate.pc = old_pc

    def _fork_epilogue(self, run, pending_forks) -> List:
        """Split the decoded rows into taken/fall-through cohorts and
        settle the sibling feasibility checks as ONE coalesced bundle
        whose blasted cones ride a single ragged stream with the fork
        literals as extra assumption roots (service/scheduler
        solve_fork_batch → gpu/router fork lane). The host CDCL remains
        the sole UNSAT oracle — an infeasible side is masked dead here,
        before it ever materializes as a Python GlobalState."""
        if not pending_forks:
            return []
        svm = self.svm
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        start = time.monotonic()
        with trace_span("frontier.fork", cat="laser",
                        rows=len(pending_forks)) as sp:
            symbolic = [pf for pf in pending_forks if pf.symbolic]
            decision = self._prune_decision() if symbolic else "keep"
            keep = {}  # id(pf) -> [keep_fall, keep_jump]
            if decision == "solve" and symbolic:
                bundle, pairs, sides = [], [], []
                for pf in symbolic:
                    fall_c, jump_c = pf.side_constraints()
                    check_fall = not self._side_skippable(pf, run,
                                                          fall=True)
                    check_jump = not self._side_skippable(pf, run,
                                                          fall=False)
                    avoided = (not check_fall) + (not check_jump)
                    if avoided:
                        # skipped sides are KEPT unchecked, exactly as
                        # the exec loop's preanalysis filter keeps them
                        stats.add_queries_avoided(avoided)
                    index_fall = index_jump = None
                    if check_fall:
                        index_fall = len(bundle)
                        bundle.append(fall_c)
                        sides.append((pf, 0))
                    if check_jump:
                        index_jump = len(bundle)
                        bundle.append(jump_c)
                        sides.append((pf, 1))
                    if index_fall is not None and index_jump is not None:
                        pairs.append((index_fall, index_jump))
                if bundle:
                    from mythril_tpu_torch.service.scheduler import get_scheduler

                    outcomes = get_scheduler().solve_fork_batch(
                        bundle, pairs, crosscheck=False)
                    pruned = 0
                    for (pf, side), (status, _model) in zip(sides,
                                                            outcomes):
                        if status == "unsat":
                            keep.setdefault(id(pf), [True, True])[side] \
                                = False
                            pruned += 1
                    if pruned:
                        stats.add_fork_pruned(pruned)
            successors = []
            parkable = []  # (pending fork, its materialized sides)
            cohort_extra = 0  # materialized rows beyond one per slot
            for pf in pending_forks:
                flags = keep.get(id(pf), (True, True))
                sides_out = pf.materialize(keep_fall=flags[0],
                                           keep_jump=flags[1])
                successors.extend(sides_out)
                cohort_extra += max(0, len(sides_out) - 1)
                if pf.symbolic:
                    parkable.append(sides_out)
            if decision == "park" and parkable:
                parked = {id(s) for s in self._park_successors(
                    [side for sides in parkable for side in sides])}
                for sides in parkable:
                    if len(sides) == 2 and all(id(s) in parked
                                               for s in sides):
                        # sibling-pair token, set ONLY on sides that
                        # actually parked: the delayed-solving drain
                        # recovers the pairing and routes the bundle
                        # through the fork lane (and clears the token),
                        # so a token can never outlive its one drain —
                        # stale tokens would re-pair long-diverged
                        # states and corrupt the fork counters
                        token = object()
                        for side in sides:
                            side._fork_pair_token = token
                successors = [s for s in successors
                              if id(s) not in parked]
            if symbolic:
                stats.add_frontier_fork(len(symbolic),
                                        time.monotonic() - start,
                                        cohort_rows=cohort_extra)
            sp.set(forked=len(symbolic), successors=len(successors))
        return successors

    def _park_successors(self, successors) -> List:
        """Delayed-solving strategy mirror of the exec loop's pending
        branch: forked sides failing the quick model-cache probe park in
        the base strategy's pending_worklist (batch-solved when the
        ready worklist drains). Returns the PARKED states."""
        base = self.svm.strategy
        while hasattr(base, "super_strategy"):
            base = base.super_strategy
        pending = getattr(base, "pending_worklist", None)
        if pending is None:
            return []
        from mythril_tpu_torch.support.model import model_cache

        parked = []
        for state in successors:
            if model_cache.check_quick_sat(
                    state.world_state.constraints.get_all_constraints()
            ) is None:
                pending.append(state)
                parked.append(state)
        return parked
