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
           with the gpu backend's ragged path, where one launch covers a
           window)
  age      a submit arriving after the oldest buffered entry has waited
           MYTHRIL_GPU_COALESCE_MS (default 6 ms)

MYTHRIL_GPU_COALESCE_MS=0 disables coalescing: solve_batch and
solve_fork_batch become direct get_models_batch calls and submit() solves
at once.

Synchronous host code (time.monotonic checks, no threads of its own).
Every flush is counted in SolverStatistics (window_flushes,
coalesced_queries).

Cross-contract windows (service/interleave.py;
mythril_tpu/service/scheduler.py:150-330): the window is process-global
and every buffered entry carries an origin tag (the contract identity
the interleaved corpus run mints; None outside it). Under the
interleave coordinator solve_batch and solve_fork_batch PARK their
bundle instead of demanding a flush, and the age trigger is suspended,
so bundles from different contracts gather in one window and ride one
router dispatch, whose streams then mix origins. A fork bundle's pairs
travel as shared tokens the flush turns back into the router's
fork_pairs hint. Fair admission: a flush group holding two or more
origins splits into sub-groups that round-robin the origins, each
origin at most MYTHRIL_GPU_ORIGIN_BUDGET (32) queries a sub-group, so a
contract that floods the window cannot push a small one's queries out of
the first dispatch (nothing is dropped, only ordered).

Failure isolation (the registered fault site scheduler.flush, retry
action): a group whose batched solve raises is retried query by query, so
the buffered siblings still get their real verdicts and only a query that
fails alone degrades to unknown. A DeviceFault, or a NoDeviceError, is
not a host error: it propagates at once and is never retried, which would
launch K1 again after the device failed (the JAX package retries those
too, as its device errors fall back to the host). A flush resolves every
handle it popped in its finally, so no parked analysis waits for ever.
"""

import logging
import time
from typing import List, Optional, Tuple

from mythril_tpu_torch.support.env import env_float

log = logging.getLogger(__name__)

COALESCE_MS = 6.0  # default of MYTHRIL_GPU_COALESCE_MS
DEFAULT_COALESCE_MAX = 16
# on the gpu backend ONE ragged launch covers a whole window regardless
# of shape, so a wider window buys amortization
DEFAULT_COALESCE_MAX_RAGGED = 64
# one origin's share of a flush sub-group when the window mixes origins
DEFAULT_ORIGIN_BUDGET = 32


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

        self.window_ms = env_float("MYTHRIL_GPU_COALESCE_MS",
                                   COALESCE_MS)
        default_max = DEFAULT_COALESCE_MAX
        # widen only where one launch can cover the window: the ragged
        # path on the gpu backend
        if args.solver_backend == "gpu":
            from mythril_tpu_torch.gpu.router import ragged_enabled

            if ragged_enabled():
                default_max = DEFAULT_COALESCE_MAX_RAGGED
        self.max_batch = max(
            1, int(env_float("MYTHRIL_GPU_COALESCE_MAX", default_max)))
        self.origin_budget = max(
            1, int(env_float("MYTHRIL_GPU_ORIGIN_BUDGET",
                             DEFAULT_ORIGIN_BUDGET)))
        # entries: (handle, constraint list, crosscheck, origin tag, pair
        # token); the token is one object per fork pair (both sides of one
        # batched JUMPI fork), None for other traffic
        self._buffer: List[tuple] = []
        self._oldest: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.window_ms > 0

    def pending(self) -> int:
        return len(self._buffer)

    def pending_origins(self) -> int:
        """Distinct origin tags among the buffered queries."""
        return len({entry[3] for entry in self._buffer})

    def submit(self, constraints, crosscheck: Optional[bool] = None
               ) -> SolveHandle:
        """Buffer one query; returns a handle. With coalescing disabled the
        query is solved at once."""
        handle = SolveHandle(self)
        if not self.enabled:
            from mythril_tpu_torch.support.model import get_models_batch

            handle._resolve(
                get_models_batch([constraints], crosscheck=crosscheck)[0])
            return handle
        self._buffer_one(handle, constraints, crosscheck)
        if len(self._buffer) >= self.max_batch:
            self.flush()
        return handle

    def _buffer_one(self, handle, constraints, crosscheck,
                    pair_key=None) -> None:
        from mythril_tpu_torch.service import interleave

        now = time.monotonic()
        if (self._buffer and self._oldest is not None
                and interleave.active() is None
                and (now - self._oldest) * 1000.0 >= self.window_ms):
            # the window expired while nobody demanded a result: flush the
            # stale cohort before starting a new one. Under the interleave
            # coordinator the age trigger is suspended: parked bundles wait
            # for sibling contracts' queries by design, and the coordinator
            # flushes the moment no analysis can progress
            self.flush()
            now = time.monotonic()
        if not self._buffer:
            self._oldest = now
        self._buffer.append((handle, list(constraints), crosscheck,
                             interleave.current_origin(), pair_key))

    def solve_batch(self, constraint_sets,
                    crosscheck: Optional[bool] = None) -> List:
        """Seam entry point: buffer every sibling query, then demand all
        results — the whole bundle (plus anything already buffered) rides
        ONE window flush regardless of max_batch (the caller bounds the
        bundle; splitting it would split its stream). Under the interleave
        coordinator the bundle parks instead: the baton passes to sibling
        analyses, whose bundles join the same window. With coalescing
        disabled it is a direct get_models_batch call."""
        if not self.enabled:
            from mythril_tpu_torch.support.model import get_models_batch

            return get_models_batch(constraint_sets, crosscheck=crosscheck)
        handles = []
        for constraints in constraint_sets:
            handle = SolveHandle(self)
            self._buffer_one(handle, constraints, crosscheck)
            handles.append(handle)
        from mythril_tpu_torch.service import interleave

        coordinator = interleave.active()
        if coordinator is not None and handles:
            coordinator.park_for_results(self, handles)
        return [handle.result() for handle in handles]

    def solve_fork_batch(self, constraint_sets, pairs,
                         crosscheck: Optional[bool] = False) -> List:
        """Fork-bundle seam: the taken/fall-through feasibility checks of
        ONE batched JUMPI fork, handed to get_models_batch as one bundle
        with `pairs` — (i, j) index pairs marking two sides of one row —
        forwarded to the router's fork lane, which packs a pair's shared
        cone once and rides both sides on one ragged stream with the fork
        literals as extra roots. Outside the interleave coordinator,
        already-buffered traffic flushes first so the pair indices stay
        aligned with the bundle. Under it the bundle joins the shared
        window like any other traffic, each pair tagged with a token the
        flush turns back into the fork_pairs hint. With coalescing
        disabled it is a direct get_models_batch call."""
        if not self.enabled:
            from mythril_tpu_torch.support.model import get_models_batch

            return get_models_batch(constraint_sets, crosscheck=crosscheck,
                                    fork_pairs=pairs)
        from mythril_tpu_torch.service import interleave

        coordinator = interleave.active()
        if coordinator is None:
            from mythril_tpu_torch.smt.solver.statistics import (
                SolverStatistics,
            )
            from mythril_tpu_torch.support.model import get_models_batch

            self.flush()
            SolverStatistics().add_window_flush(len(constraint_sets))
            return get_models_batch(constraint_sets, crosscheck=crosscheck,
                                    fork_pairs=pairs)
        pair_keys = {}
        for i, j in pairs or ():
            token = object()
            pair_keys[i] = token
            pair_keys[j] = token
        handles = []
        for index, constraints in enumerate(constraint_sets):
            handle = SolveHandle(self)
            self._buffer_one(handle, constraints, crosscheck,
                             pair_key=pair_keys.get(index))
            handles.append(handle)
        if handles:
            coordinator.park_for_results(self, handles)
        return [handle.result() for handle in handles]

    def flush(self) -> None:
        """Solve everything buffered: one _solve_group per distinct
        crosscheck flag and fair-admission sub-group, submission order
        preserved per group."""
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
                    for group in self._origin_groups(entries):
                        outcomes = self._solve_group(flag, group)
                        for entry, outcome in zip(group, outcomes):
                            entry[0]._resolve(outcome)
        finally:
            # an error escaping the isolation below (a DeviceFault) reaches
            # the demanding caller; no popped handle may dangle, so the
            # ones still pending degrade to unknown first
            for entry in buffered:
                if not entry[0].done:
                    entry[0]._resolve(("unknown", None))

    def _origin_groups(self, entries: List[tuple]) -> List[List[tuple]]:
        """Fair admission (mythril_tpu/service/scheduler.py:294): with two
        or more origins in a flush group, round-robin the origins with at
        most origin_budget entries each a sub-group, so every origin in
        the window lands in the first dispatch and a flooding origin's
        overflow rides later sub-groups of the same flush. A fork pair
        travels as one atom. Single-origin and untagged windows pass
        through as one group."""
        origins = {entry[3] for entry in entries}
        if len(origins) < 2:
            return [entries]
        queues = {}   # origin -> atoms (one entry, or a fork pair)
        order = []
        pending_pair = {}  # pair token -> the atom awaiting its second side
        for entry in entries:
            origin = entry[3]
            if origin not in queues:
                queues[origin] = []
                order.append(origin)
            token = entry[4]
            if token is not None and token in pending_pair:
                pending_pair.pop(token).append(entry)
                continue
            atom = [entry]
            queues[origin].append(atom)
            if token is not None:
                pending_pair[token] = atom
        cursors = {origin: 0 for origin in order}
        groups: List[List[tuple]] = []
        while any(cursors[o] < len(queues[o]) for o in order):
            group: List[tuple] = []
            for origin in order:
                queue, cursor = queues[origin], cursors[origin]
                taken = 0
                while cursor < len(queue) and taken < self.origin_budget:
                    group.extend(queue[cursor])
                    taken += len(queue[cursor])
                    cursor += 1
                cursors[origin] = cursor
            groups.append(group)
        return groups

    @staticmethod
    def _solve_group(flag, entries) -> List:
        """Solve one crosscheck group of a window flush, isolating a
        failing query: on a host error the group is retried query by query
        (a `retry` event), and only a query that fails alone degrades to
        unknown (a `degraded` event). A device error propagates
        unretried. The router's fork_pairs hint is rebuilt from the pair
        tokens at the positions the entries occupy (a pair never straddles
        a sub-group); the retry drops it, as it is a packing hint only."""
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
        from mythril_tpu_torch.resilience import maybe_inject, record_event
        from mythril_tpu_torch.support.model import get_models_batch

        fork_pairs = []
        first_side = {}
        for position, entry in enumerate(entries):
            token = entry[4]
            if token is None:
                continue
            if token in first_side:
                fork_pairs.append((first_side.pop(token), position))
            else:
                first_side[token] = position
        try:
            maybe_inject("scheduler.flush")
            return get_models_batch(
                [entry[1] for entry in entries], crosscheck=flag,
                origins=[entry[3] for entry in entries],
                fork_pairs=fork_pairs or None)
        except (DeviceFault, NoDeviceError):
            raise
        except Exception:
            log.warning("coalesced solve flush failed; retrying the %d "
                        "buffered quer(ies) individually", len(entries),
                        exc_info=True)
            record_event("scheduler.flush", "retry")
        outcomes = []
        for entry in entries:
            try:
                outcomes.append(get_models_batch(
                    [entry[1]], crosscheck=flag, origins=[entry[3]])[0])
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
        for entry in buffered:
            entry[0]._resolve(("unknown", None))


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
