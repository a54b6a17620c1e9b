"""Fault containment (mythril_tpu.resilience on the port):

  registry.py   the fault-site registry: each optional stage declares one
                site and one degradation action
  breaker.py    the per-stage circuit breaker the router feeds with
                zero-hit device time
  deadline.py   the hard deadline around K1's dispatch (device.dispatch):
                a dispatch that never returns becomes a recorded
                DeviceFault at its budget plus grace instead of a hang
  faults.py     the deterministic injection harness (MYTHRIL_GPU_FAULTS /
                --inject-fault), which the chaos tests drive
  here          resilience events (counted into SolverStatistics per site,
                marked on the span timeline, handed to the flight
                recorder), the session FUSES of the disable action, and
                the jittered retry of the retry action

The host stages degrade as the JAX package's do, and no degradation can
change findings. The device sites do not degrade on the port: a fault of
K1's dispatch, of the calibration or of the cuda frontier step stops the
analysis as a recorded DeviceFault (the JAX package hands such work to the
host CDCL or the per-state interpreter instead).
"""

import logging
import os
import random
import time
import zlib
from typing import Callable, Dict

from mythril_tpu_torch.resilience import registry  # noqa: F401 (public API)
from mythril_tpu_torch.resilience.deadline import (  # noqa: F401
    StageDeadlineExceeded,
    run_with_deadline,
)
from mythril_tpu_torch.resilience.faults import (  # noqa: F401
    InjectedFault,
    corrupt_text,
    maybe_inject,
)

log = logging.getLogger(__name__)

# failures of a disable-action stage before its session fuse blows: a
# transient hiccup costs one degraded event; a DETERMINISTIC fault (same
# exception every query) reaches the threshold within a few queries and
# the stage stays off for the session instead of failing-and-degrading
# thousands of times
FUSE_THRESHOLD = 3

_fuse_failures: Dict[str, int] = {}
_fuses_blown: Dict[str, bool] = {}


def record_event(site: str, event: str, count: int = 1) -> None:
    """Count one resilience event (SolverStatistics and the stats JSON
    `resilience` section, per site) and mark it on the span timeline as a
    zero-width tagged event. A flight-recorder trigger (breaker_trip
    or deadline) then dumps the ring of recent spans, after the event
    itself entered it, so the dump holds its own trigger."""
    from mythril_tpu_torch.observe import flightrec
    from mythril_tpu_torch.observe.tracer import span as trace_span
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    SolverStatistics().add_resilience_event(site, event, count)
    with trace_span("resilience." + event, cat="resilience", site=site):
        pass
    flightrec.notify(site, event)


def note_stage_failure(site: str, hard: bool = False) -> bool:
    """One failure of a disable-action stage: counts a `degraded` event
    and charges the session fuse (hard=True blows it immediately).
    Returns True when the fuse just blew."""
    record_event(site, "degraded")
    if _fuses_blown.get(site):
        return False
    failures = _fuse_failures.get(site, 0) + 1
    _fuse_failures[site] = failures
    if hard or failures >= FUSE_THRESHOLD:
        _fuses_blown[site] = True
        log.warning("%s disabled for the rest of the session after %d "
                    "failure(s): %s", site, failures,
                    registry.FAULT_SITES[site].degrades_to
                    if site in registry.FAULT_SITES
                    else "the full pipeline takes over")
        return True
    return False


def fuse_blown(site: str) -> bool:
    """Is this disable-action stage off for the session?"""
    return _fuses_blown.get(site, False)


def with_retries(site: str, fn: Callable, attempts: int = 2,
                 base_delay_s: float = 0.002):
    """Run `fn`, retrying a failure with seeded jittered backoff (the
    jitter's RNG seeds on the site name and the pid, so two contending
    processes desynchronize). Each retry counts a `retry` event; the last
    failure propagates for the caller to degrade."""
    rng = random.Random(zlib.crc32(site.encode()) ^ os.getpid())
    for attempt in range(attempts):
        try:
            return fn()
        except Exception:
            if attempt + 1 >= attempts:
                raise
            record_event(site, "retry")
            time.sleep(base_delay_s * (2 ** attempt) * (1 + rng.random()))


def reset_session() -> None:
    """Drop session fuses and failure counts (clear_caches/tests)."""
    _fuse_failures.clear()
    _fuses_blown.clear()
