"""Coalescing solve scheduler (mythril_tpu.service.scheduler).

`submit(constraints) -> SolveHandle` buffers single-query solve traffic;
a flush hands EVERY buffered query to support/model's get_models_batch
in one call — one router dispatch, one ragged stream per chunk, instead
of N solo solves. The engine's seams hand their sibling-query bundles to
solve_batch(), and a batched JUMPI fork's two sides to solve_fork_batch().

Flush triggers (bounded window):
  demand   the first handle whose result is demanded flushes the whole
           buffer (single-threaded callers can never deadlock on a
           buffered handle)
  count    the buffer reaching MYTHRIL_GPU_COALESCE_MAX (default 16; 64
           with the gpu backend, where one ragged launch covers a window)
  age      a submit arriving after the oldest buffered entry has waited
           COALESCE_MS (6 ms)

Synchronous host code (time.monotonic checks, no threads). Every flush is
counted in SolverStatistics (window_flushes, coalesced_queries).

Failure isolation (the registered fault site scheduler.flush, retry
action): a group whose batched solve raises is retried query by query, so
the buffered siblings still get their real verdicts and only a query that
fails alone degrades to unknown. A DeviceFault, or a NoDeviceError, is
not a host error: it propagates at once and is never retried, which would
launch K1 again after the device failed (the JAX package retries those
too, as its device errors fall back to the host).

Differences from the JAX package: the DeviceFault rule above, and the
interleave coordinator's parking and fair per-origin sub-groups wait for
the corpus slice.
"""

import logging
import time
from typing import List, Optional, Tuple

from mythril_tpu_torch.support.env import env_float

log = logging.getLogger(__name__)

COALESCE_MS = 6.0
DEFAULT_COALESCE_MAX = 16
# on the gpu backend ONE ragged launch covers a whole window regardless
# of shape, so a wider window buys amortization
DEFAULT_COALESCE_MAX_RAGGED = 64


class SolveHandle:
    """Future-like result of one submitted query. result() returns the
    get_models_batch outcome tuple: ("sat", Model) / ("unsat", None) /
    ("unknown", None)."""

    __slots__ = ("_scheduler", "_outcome", "_done")

    def __init__(self, scheduler: "CoalescingScheduler"):
        self._scheduler = scheduler
        self._outcome = None
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> Tuple[str, Optional[object]]:
        if not self._done:
            self._scheduler.flush()
        return self._outcome

    def _resolve(self, outcome) -> None:
        self._outcome = outcome
        self._done = True


class CoalescingScheduler:
    def __init__(self):
        from mythril_tpu_torch.support.args import args

        default_max = DEFAULT_COALESCE_MAX
        # widen only where one launch can cover the window
        if args.solver_backend == "gpu":
            default_max = DEFAULT_COALESCE_MAX_RAGGED
        self.max_batch = max(
            1, int(env_float("MYTHRIL_GPU_COALESCE_MAX", default_max)))
        # entries: (handle, constraint list, crosscheck, origin tag)
        self._buffer: List[tuple] = []
        self._oldest: Optional[float] = None

    def pending(self) -> int:
        return len(self._buffer)

    def submit(self, constraints, crosscheck: Optional[bool] = None
               ) -> SolveHandle:
        """Buffer one query; returns a handle."""
        handle = SolveHandle(self)
        self._buffer_one(handle, constraints, crosscheck)
        if len(self._buffer) >= self.max_batch:
            self.flush()
        return handle

    def _buffer_one(self, handle, constraints, crosscheck) -> None:
        from mythril_tpu_torch.service.interleave import current_origin

        now = time.monotonic()
        if (self._buffer and self._oldest is not None
                and (now - self._oldest) * 1000.0 >= COALESCE_MS):
            # the window expired while nobody demanded a result: flush the
            # stale cohort before starting a new one
            self.flush()
            now = time.monotonic()
        if not self._buffer:
            self._oldest = now
        self._buffer.append((handle, list(constraints), crosscheck,
                             current_origin()))

    def solve_batch(self, constraint_sets,
                    crosscheck: Optional[bool] = None) -> List:
        """Seam entry point: buffer every sibling query, then demand all
        results — the whole bundle (plus anything already buffered) rides
        ONE window flush regardless of max_batch (the caller bounds the
        bundle; splitting it would split its stream)."""
        handles = []
        for constraints in constraint_sets:
            handle = SolveHandle(self)
            self._buffer_one(handle, constraints, crosscheck)
            handles.append(handle)
        return [handle.result() for handle in handles]

    def solve_fork_batch(self, constraint_sets, pairs,
                         crosscheck: Optional[bool] = False) -> List:
        """Fork-bundle seam: the taken/fall-through feasibility checks of
        ONE batched JUMPI fork, handed to get_models_batch as one bundle
        with `pairs` — (i, j) index pairs marking two sides of one row —
        forwarded to the router's fork lane, which packs a pair's shared
        cone once and rides both sides on one ragged stream with the fork
        literals as extra roots. Already-buffered traffic flushes first so
        the pair indices stay aligned with the bundle."""
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
        from mythril_tpu_torch.support.model import get_models_batch

        self.flush()
        SolverStatistics().add_window_flush(len(constraint_sets))
        return get_models_batch(constraint_sets, crosscheck=crosscheck,
                                fork_pairs=pairs)

    def flush(self) -> None:
        """Solve everything buffered: one get_models_batch per distinct
        crosscheck flag, submission order preserved per group."""
        if not self._buffer:
            return
        from mythril_tpu_torch.observe.tracer import span as trace_span
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        buffered, self._buffer = self._buffer, []
        self._oldest = None
        SolverStatistics().add_window_flush(len(buffered))
        groups = {}
        for entry in buffered:
            groups.setdefault(entry[2], []).append(entry)
        try:
            with trace_span("scheduler.flush", cat="service",
                            queries=len(buffered), groups=len(groups)):
                for flag, entries in groups.items():
                    outcomes = self._solve_group(flag, entries)
                    for (handle, _c, _f, _o), outcome in zip(entries,
                                                             outcomes):
                        handle._resolve(outcome)
        finally:
            # an error escaping the isolation below (a DeviceFault) reaches
            # the demanding caller; no popped handle may dangle, so the
            # ones still pending degrade to unknown first
            for entry in buffered:
                if not entry[0].done:
                    entry[0]._resolve(("unknown", None))

    @staticmethod
    def _solve_group(flag, entries) -> List:
        """Solve one crosscheck group of a window flush, isolating a
        failing query: on a host error the group is retried query by query
        (a `retry` event), and only a query that fails alone degrades to
        unknown (a `degraded` event). A device error propagates
        unretried."""
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
        from mythril_tpu_torch.resilience import maybe_inject, record_event
        from mythril_tpu_torch.support.model import get_models_batch

        try:
            maybe_inject("scheduler.flush")
            return get_models_batch(
                [constraints for _h, constraints, _f, _o in entries],
                crosscheck=flag,
                origins=[origin for _h, _c, _f, origin in entries])
        except (DeviceFault, NoDeviceError):
            raise
        except Exception:
            log.warning("coalesced solve flush failed; retrying the %d "
                        "buffered quer(ies) individually", len(entries),
                        exc_info=True)
            record_event("scheduler.flush", "retry")
        outcomes = []
        for _handle, constraints, _f, origin in entries:
            try:
                outcomes.append(get_models_batch(
                    [constraints], crosscheck=flag, origins=[origin])[0])
            except (DeviceFault, NoDeviceError):
                raise
            except Exception:
                log.exception("query failed alone after a flush failure; "
                              "degrading it (only) to unknown")
                record_event("scheduler.flush", "degraded")
                outcomes.append(("unknown", None))
        return outcomes

    def clear(self) -> None:
        """Discard buffered state WITHOUT solving (clear_caches/test
        isolation); unresolved handles degrade to unknown."""
        buffered, self._buffer = self._buffer, []
        self._oldest = None
        for handle, _c, _f, _o in buffered:
            handle._resolve(("unknown", None))


_scheduler: Optional[CoalescingScheduler] = None


def get_scheduler() -> CoalescingScheduler:
    global _scheduler
    if _scheduler is None:
        _scheduler = CoalescingScheduler()
    return _scheduler


def reset_scheduler() -> None:
    """Drop the singleton (env is re-read on next access); buffered
    queries degrade to unknown rather than solving during teardown."""
    global _scheduler
    if _scheduler is not None:
        _scheduler.clear()
    _scheduler = None
