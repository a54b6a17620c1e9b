"""Hard deadline around K1's dispatch (the design of
mythril_tpu.resilience.deadline).

The router's dispatch budget bounds K1's round loop only between rounds,
so only if control ever comes back from the backend. A dispatch that
never returns (a wedged launch, a CUDA call that blocks) would hang the
whole analysis with it. The rescue that needs no process kill runs the
call on a separate thread and abandons it at the deadline: the caller
raises, and the wedged call finishes late into a discarded result or
stays stuck in its daemon thread until the process exits.

One PERSISTENT runner thread (not a thread per call): the steady-state
cost of a call is one queue round trip, which the runner counts itself
(SolverStatistics deadline_runner_calls and deadline_handoff_wall: the
wall of each guarded call less the call's own wall on the runner). When a call times out the runner
is marked wedged and abandoned; the next call gets a fresh runner with
fresh queues, so a late result from the wedged thread can never be taken
for the new call's.
"""

import logging
import queue
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class StageDeadlineExceeded(RuntimeError):
    """The wrapped call did not return within its hard deadline."""


class _Runner:
    def __init__(self):
        self._inbox: "queue.Queue" = queue.Queue()
        self._outbox: "queue.Queue" = queue.Queue()
        self.wedged = False
        self._thread = threading.Thread(
            target=self._loop, name="mythril-gpu-stage-runner", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn = self._inbox.get()
            if fn is None:
                return
            begin = time.perf_counter()
            try:
                result = (True, fn())
            except BaseException as error:  # delivered to the caller
                result = (False, error)
            self._outbox.put((*result, time.perf_counter() - begin))

    def call(self, fn: Callable, deadline_s: float):
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        begin = time.perf_counter()
        self._inbox.put(fn)
        try:
            ok, payload, inner_s = self._outbox.get(timeout=deadline_s)
        except queue.Empty:
            self.wedged = True
            raise StageDeadlineExceeded(
                f"stage call exceeded its {deadline_s:.1f}s hard deadline")
        SolverStatistics().add_deadline_handoff(
            time.perf_counter() - begin - inner_s)
        if ok:
            return payload
        raise payload


def new_runner() -> _Runner:
    """A dedicated runner for a caller that must not share the module's
    one: a caller that itself runs under run_with_deadline and crosses it
    again would queue behind itself. The caller owns wedged replacement
    (check `.wedged`, drop the runner, call new_runner() again)."""
    return _Runner()


_runner: Optional[_Runner] = None
_runner_lock = threading.Lock()


def _get_runner() -> _Runner:
    global _runner
    with _runner_lock:
        if _runner is None or _runner.wedged:
            _runner = _Runner()
        return _runner


def run_with_deadline(site: str, fn: Callable, deadline_s: float):
    """Run `fn` under a hard deadline. On timeout: counts a `deadline`
    resilience event for `site` (a flight-recorder trigger) and raises
    StageDeadlineExceeded. Exceptions from `fn` propagate unchanged. A
    non-positive deadline means no bound (inline call)."""
    if deadline_s is None or deadline_s <= 0:
        return fn()
    try:
        runner = _get_runner()
    except Exception as error:  # cannot thread: run inline, unguarded
        from mythril_tpu_torch.resilience import record_event

        record_event(site, "degraded")
        log.warning("%s: no deadline runner (%s): running the call inline "
                    "without its hard deadline", site, error)
        return fn()
    try:
        return runner.call(fn, deadline_s)
    except StageDeadlineExceeded:
        from mythril_tpu_torch.resilience import record_event

        record_event(site, "deadline")
        log.warning("%s exceeded its %.1fs hard deadline: abandoning the "
                    "call", site, deadline_s)
        raise


def reset() -> None:
    """Testing hook: drop the runner. Its thread ends once idle; a wedged
    one ends when its abandoned call returns."""
    global _runner
    with _runner_lock:
        if _runner is not None:
            _runner._inbox.put(None)
        _runner = None
