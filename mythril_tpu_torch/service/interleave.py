"""Interleaved corpus analysis: N contracts' analyses take turns in one
process, so their sibling solve queries share one coalescing window and
ride one K1 stream (mythril_tpu/service/interleave.py).

  baton        N analyses run on N threads, but only ONE executes at any
               instant: a baton (a condition variable and the current slot
               id) is handed off at explicit yield points. The engine's
               process-global state is never mutated concurrently, and
               every device launch (K1's rounds, K6's steps) runs and
               synchronises inside one holder's turn, so no launch is in
               flight across a hand-off. The win is windows that mix
               origins, not CPU overlap.
  yield points (a) every `quantum` exec-loop iterations (laser/svm.py
               calls tick()), for fairness; (b) the scheduler's solve
               seam: an analysis whose sibling bundle was buffered PARKS
               instead of demanding a flush, the baton passes on, and only
               when every live analysis is parked (or none can progress)
               does the holder flush the window, carrying every parked
               origin's queries in one router dispatch.
  contexts     each origin's slice of the engine state (tenancy.py) is
               switched at every hand-off, so per-contract findings do
               not depend on the schedule: interleaved host-backend
               reports are byte-identical to the sequential (interleave 1)
               ones.

Differences from the JAX package: an error that escapes an analysis (a
DeviceFault: the per-contract capture in core.py catches everything else)
stops the whole run. The slot records it as the coordinator's `failure`
and cancels the coordinator, so every other slot unwinds with
BatchCancelled at its next yield point; the caller joins the slot threads
and re-raises the failure on its own thread. A window flush that fails
with a DeviceFault is not degraded to unknown: it propagates.

The serve daemon (serve/daemon.py) runs each admitted batch as one
cohort: it mints tenant-qualified origins, asks for warm contexts (each
origin's solve memos survive its requests), passes the module templates
it captured once at start, and tears down with uninstall(
keep_tenancy=True, expected=coordinator): a compare-and-swap, so an
abandoned batch body unwinding late cannot pop its successor's
coordinator, and the module state it restores is restored under the same
lock.

Knobs: MYTHRIL_GPU_CORPUS_INTERLEAVE / --corpus-interleave selects the
interleaved run (core.MythrilAnalyzer._fire_lasers_interleaved);
MYTHRIL_GPU_INTERLEAVE_QUANTUM sets the exec iterations a turn (16).

Spans (cat "interleave"): `interleave.turn`, a slot's hold of the baton
(origin, ticks: the exec-loop yield points it passed); `interleave.switch`,
one engine-context save or restore at a hand-off (origin, op);
`interleave.park`, a slot waiting on its parked handles (handles);
`interleave.flush`, the coordinator's flush of the shared window
(origins, queries). Counters (SolverStatistics): interleave_handoffs,
interleave_switch_wall (the saves' and restores' seconds),
interleave_flushes and interleave_flush_origins (the distinct origins of
each flushed window, summed).
"""

import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

from mythril_tpu_torch.observe.tracer import span as trace_span
from mythril_tpu_torch.service import tenancy
from mythril_tpu_torch.service.tenancy import EngineContext
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

log = logging.getLogger(__name__)

DEFAULT_QUANTUM = 16  # exec-loop iterations a baton turn

_active: Optional["Coordinator"] = None


class BatchCancelled(BaseException):
    """Raised inside a slot thread at its next yield point once its
    coordinator was cancelled (another slot failed). A BaseException, so
    it cuts through the engine's per-contract `except Exception`: a
    cancelled analysis must die, not be recorded as a failed contract."""


def active() -> Optional["Coordinator"]:
    """The live coordinator, or None outside an interleaved corpus run."""
    return _active


def current_origin() -> Optional[str]:
    """Origin tag of the analysis holding the baton; None outside an
    interleaved run."""
    coordinator = _active
    return coordinator._current_origin if coordinator is not None else None


# the slot thread's own coordinator (set at attach, cleared at detach): a
# slot of a cancelled coordinator dies at its next tick even when that
# coordinator is no longer installed
_thread_coordinator = threading.local()


def tick() -> None:
    """Exec-loop yield point (laser/svm.py): hand the baton on every
    `quantum` iterations. A thread-local and a global load and a None
    check when no coordinator is live."""
    own = getattr(_thread_coordinator, "value", None)
    if own is not None:
        own.maybe_switch()
        return
    coordinator = _active
    if coordinator is not None:
        coordinator.maybe_switch()


@contextmanager
def blaster_scope(origin):
    """Temporarily install `origin`'s blaster over the ambient one: the
    per-query seam get_models_batch uses in a mixed window flush, where
    one baton holder prepares several origins' queries. No-op outside the
    coordinator, for untagged queries, and when `origin` holds the
    baton."""
    if _active is None or origin is None or origin == current_origin():
        yield
        return
    from mythril_tpu_torch.smt.solver import frontend

    saved = (frontend._global_blaster, frontend._global_blaster_generation)
    tenancy.install_blaster(origin)
    try:
        yield
    finally:
        tenancy.stash_blaster(origin)
        (frontend._global_blaster,
         frontend._global_blaster_generation) = saved


class Coordinator:
    """Cooperative round-robin scheduler over N analysis slots
    (mythril_tpu/service/interleave.py:138).

    Exactly one slot holds the baton (self._current); the rest wait on the
    shared condition, which guards every queue and flag. The engine
    context is saved and restored inside the hand-off while the world is
    stopped (the old holder has not released the baton, the new one has
    not started), so the swap needs no other lock."""

    def __init__(self, tasks, quantum: Optional[int] = None,
                 origins: Optional[List[str]] = None, warm: bool = False,
                 module_templates=None):
        """`tasks`: (idx, contract) pairs in corpus order. Origin tags are
        minted here, index-qualified (contracts loaded from bytecode all
        share the name MAIN), unless the caller passes its own `origins`
        (parallel to `tasks`; the serve daemon's tenant-qualified tags).
        `warm` keeps each origin's solve memos across its runs
        (EngineContext.install_fresh(preserve_caches=True));
        `module_templates` reuses templates the caller captured, instead
        of capturing them here (:148-165)."""
        from mythril_tpu_torch.support.env import env_float
        from mythril_tpu_torch.support import model as model_mod

        self._cond = threading.Condition()
        self._warm = warm
        if origins is not None:
            self._tasks = deque(
                (idx, contract, origin)
                for (idx, contract), origin in zip(tasks, origins))
        else:
            self._tasks = deque(
                (idx, contract, f"{idx}:{getattr(contract, 'name', '?')}")
                for idx, contract in tasks)
        self._waitq: deque = deque()
        self._live = set()
        self._current: Optional[int] = None
        self._contexts = {}          # slot id -> EngineContext or None
        self._wants_flush = set()    # slots parked awaiting a flush
        self._parked_handles = {}    # slot id -> handles it is parked on
        self._tls = threading.local()
        self._current_origin: Optional[str] = None
        self._ticks = 0
        # the baton holder's open interleave.turn span and the yield
        # points it has passed (only the holder touches either)
        self._turn = None
        self._turn_ticks = 0
        self._cancelled = False
        # the first error that escaped a slot's analysis (a DeviceFault);
        # the caller re-raises it once every slot thread has ended
        self.failure: Optional[BaseException] = None
        self.quantum = max(1, int(quantum if quantum is not None
                                  else env_float(
                                      "MYTHRIL_GPU_INTERLEAVE_QUANTUM",
                                      DEFAULT_QUANTUM)))
        self._module_templates = (
            module_templates if module_templates is not None
            else tenancy.capture_module_templates())
        # the module globals from before the run, restored by uninstall()
        # so later origin-less work sees its own caches again
        self._base_model_state = (model_mod._result_cache,
                                  model_mod.model_cache,
                                  model_mod._in_detection_context)

    # -- slot lifecycle ------------------------------------------------------

    def run_slot(self, slot_id: int, analyze_one) -> None:
        """Slot thread main (:201): claim the baton, then loop over the
        corpus tasks, a fresh engine context a contract and a fairness
        yield between contracts. `analyze_one(idx, contract)` is the
        caller's per-contract closure. An error escaping it becomes the
        coordinator's failure and cancels every other slot; the thread
        itself ends quietly, and the caller re-raises the failure."""
        try:
            self._attach(slot_id)
            while self._tasks:
                idx, contract, origin = self._tasks.popleft()
                context = EngineContext(origin, self._module_templates)
                with self._cond:
                    self._contexts[slot_id] = context
                context.install_fresh(preserve_caches=self._warm)
                self._current_origin = origin
                if self._turn is not None:
                    self._turn.set(origin=origin)
                self._ticks = 0
                try:
                    analyze_one(idx, contract)
                finally:
                    if self._warm and not self._cancelled:
                        # a warm origin's last blaster must outlive the
                        # task (hand-offs stash it, the last holder leaves
                        # without one); never on cancellation, when the
                        # live globals may be a sibling's (:216-230)
                        tenancy.stash_blaster(origin)
                    with self._cond:
                        self._contexts[slot_id] = None
                    self._current_origin = None
                # rotate between contracts, so one slot cannot drain the
                # task queue while its siblings wait
                self._handoff(ready_only=True)
        except BatchCancelled:
            pass
        except BaseException as error:  # the caller re-raises it
            # cancel before the baton moves on, so no sibling resumes
            # engine work after the failure
            self._fail(error)
        finally:
            self._detach(slot_id)

    def _fail(self, error: BaseException) -> None:
        with self._cond:
            if self.failure is None:
                self.failure = error
        self.cancel()

    def _attach(self, slot_id: int) -> None:
        self._tls.slot = slot_id
        _thread_coordinator.value = self
        with self._cond:
            self._live.add(slot_id)
            if self._current is None:
                self._current = slot_id
                self._begin_turn()
                return
            self._waitq.append(slot_id)
            while self._current != slot_id:
                self._check_cancelled()
                self._cond.wait()
            self._check_cancelled()
            self._restore(slot_id)
            self._begin_turn()

    def _detach(self, slot_id: int) -> None:
        _thread_coordinator.value = None
        with self._cond:
            self._live.discard(slot_id)
            self._wants_flush.discard(slot_id)
            self._parked_handles.pop(slot_id, None)
            if slot_id in self._waitq:
                self._waitq.remove(slot_id)
            if self._current == slot_id:
                self._end_turn()
                self._current = None
                if self._waitq:
                    # any waiter may run next: a flush-parked slot that
                    # wakes with no ready siblings flushes for itself
                    self._current = self._waitq.popleft()
                    self._cond.notify_all()

    # -- baton hand-off ------------------------------------------------------

    def _pick_next(self, ready_only: bool) -> Optional[int]:
        """Pop the next runnable slot off the wait queue (the caller holds
        the condition). ready_only skips flush-parked slots unless their
        parked handles have since resolved."""
        for _ in range(len(self._waitq)):
            candidate = self._waitq.popleft()
            if ready_only and candidate in self._wants_flush \
                    and not all(handle.done for handle in
                                self._parked_handles.get(candidate, ())):
                self._waitq.append(candidate)
                continue
            return candidate
        return None

    def _handoff(self, ready_only: bool) -> bool:
        """Give the baton to the next runnable slot and wait to get it
        back. False (without switching) when no eligible slot waits. The
        caller holds the baton."""
        me = self._tls.slot
        with self._cond:
            self._check_cancelled()
            next_id = self._pick_next(ready_only)
            if next_id is None:
                return False
            SolverStatistics().add_interleave_handoff()
            self._end_turn()
            self._save(me)
            self._waitq.append(me)
            self._current = next_id
            self._cond.notify_all()
            while self._current != me:
                self._check_cancelled()
                self._cond.wait()
            self._check_cancelled()
            self._restore(me)
            self._begin_turn()
        return True

    def _begin_turn(self) -> None:
        """The baton holder's turn starts: its interleave.turn span opens,
        and _end_turn closes it when the baton moves on."""
        self._turn_ticks = 0
        self._turn = trace_span("interleave.turn", cat="interleave",
                                origin=self._current_origin)
        self._turn.__enter__()

    def _end_turn(self) -> None:
        turn, self._turn = self._turn, None
        if turn is not None:
            turn.set(ticks=self._turn_ticks)
            turn.__exit__(None, None, None)

    def _save(self, slot_id: int) -> None:
        context = self._contexts.get(slot_id)
        if context is not None:
            self._switch(context, "save")
        self._current_origin = None

    def _restore(self, slot_id: int) -> None:
        context = self._contexts.get(slot_id)
        if context is not None:
            self._switch(context, "restore")
            self._current_origin = context.origin
        else:
            self._current_origin = None
        self._ticks = 0

    @staticmethod
    def _switch(context: EngineContext, op: str) -> None:
        """One engine-context save or restore, timed and traced."""
        started = time.monotonic()
        with trace_span("interleave.switch", cat="interleave",
                        origin=context.origin, op=op):
            getattr(context, op)()
        SolverStatistics().add_interleave_switch(time.monotonic() - started)

    def cancel(self) -> None:
        """Abandon every slot: each raises BatchCancelled at its next
        yield point (a quantum tick, a hand-off wait or a solve park)."""
        with self._cond:
            self._cancelled = True
            self._cond.notify_all()

    def _check_cancelled(self) -> None:
        if self._cancelled:
            raise BatchCancelled(
                "this corpus run was cancelled: another analysis failed")

    def maybe_switch(self) -> None:
        """Quantum yield point (module-level tick()). Only the baton holder
        runs engine code, so the tick counter needs no lock. A thread that
        is no slot of this coordinator dies here."""
        self._check_cancelled()
        if getattr(self._tls, "slot", None) is None:
            raise BatchCancelled(
                "engine thread is not a slot of the live coordinator")
        self._ticks += 1
        self._turn_ticks += 1
        if self._ticks < self.quantum:
            return
        self._ticks = 0
        self._handoff(ready_only=True)

    # -- solve-seam parking (service/scheduler.py) ---------------------------

    def park_for_results(self, scheduler, handles: List) -> None:
        """An analysis buffered a sibling bundle: instead of demanding an
        immediate flush (which would make every window single-origin),
        park and let the other analyses run up to their own solve seams.
        When no sibling can progress, whoever holds the baton flushes the
        window, which then carries every parked origin's queries: the
        mixed-origin window K1 runs as one stream."""
        me = self._tls.slot
        with trace_span("interleave.park", cat="interleave",
                        handles=len(handles)):
            while True:
                self._check_cancelled()
                if all(handle.done for handle in handles):
                    return
                with self._cond:
                    self._wants_flush.add(me)
                    self._parked_handles[me] = handles
                try:
                    switched = self._handoff(ready_only=True)
                finally:
                    with self._cond:
                        self._wants_flush.discard(me)
                        self._parked_handles.pop(me, None)
                if not switched:
                    # nobody else can progress: the window is as mixed as
                    # it will get, so flush it here
                    self._flush_safely(scheduler)

    @staticmethod
    def _flush_safely(scheduler) -> None:
        """Flush the shared window. A host error that escapes the
        scheduler's per-query isolation must still resolve every parked
        origin's handles, or a sibling's analysis would wait for ever; the
        leftovers degrade to unknown (a `degraded` event at
        scheduler.flush). A device error propagates: the run stops."""
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError

        queries, origins = scheduler.pending(), 0
        if queries:
            origins = scheduler.pending_origins()
            SolverStatistics().add_interleave_flush(origins)
        try:
            with trace_span("interleave.flush", cat="interleave",
                            origins=origins, queries=queries):
                scheduler.flush()
        except (DeviceFault, NoDeviceError):
            raise
        except Exception:
            log.exception("interleaved window flush failed; degrading "
                          "unresolved handles to unknown")
            from mythril_tpu_torch import resilience

            resilience.record_event("scheduler.flush", "degraded")
            scheduler.clear()


_install_lock = threading.Lock()


def install(coordinator: Coordinator) -> None:
    global _active
    with _install_lock:
        _active = coordinator


def uninstall(keep_tenancy: bool = False,
              expected: Optional[Coordinator] = None) -> None:
    """Tear the coordinator down: put back the memory tiers that were live
    before the run started, and leave the next origin-less solve a fresh
    process-wide blaster rather than the last origin's. The corpus run
    drops the per-origin blasters too (its origins never recur); the
    serve daemon keeps them (`keep_tenancy`), so the next batch starts
    warm. `expected` makes the teardown a compare-and-swap (:416-440):
    when another coordinator is installed, nothing happens. The check,
    the pop and the restore run under one lock, so an abandoned body
    unwinding late can neither pop its successor's coordinator nor
    restore module state under it."""
    global _active
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support import model as model_mod

    with _install_lock:
        if expected is not None and _active is not expected:
            return
        coordinator, _active = _active, None
        if not keep_tenancy:
            tenancy.clear_blasters()
        if coordinator is None:
            return
        (model_mod._result_cache, model_mod.model_cache,
         model_mod._in_detection_context) = coordinator._base_model_state
        frontend._global_blaster = None
        frontend._global_blaster_generation = -1
