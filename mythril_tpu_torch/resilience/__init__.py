"""Fault containment for the host-side optional stages.

The part of mythril_tpu.resilience the port's solve path calls:

  breaker.py    the per-stage circuit breaker the router feeds with
                zero-hit device time
  here          resilience events (counted into SolverStatistics per site,
                marked on the span timeline, handed to the flight
                recorder) and the session FUSES of the
                disable-for-session action: the incremental prefix resume
                and the AIG session rewrite degrade ONE query to the full
                pipeline on a fault, and repeated faults turn the stage
                off for the session

The device seam is not contained here: an error from the kernel, its
build or the device propagates to the caller (the JAX package hands such
a window to the host CDCL instead). Its fault-injection harness and the
deadline runner thread are not ported.
"""

import logging
from typing import Dict

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
    zero-width tagged event. A flight-recorder trigger (breaker_trip)
    then dumps the ring of recent spans, after the event itself entered
    it, so the dump holds its own trigger."""
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
                    "failure(s)", site, failures)
        return True
    return False


def fuse_blown(site: str) -> bool:
    """Is this disable-action stage off for the session?"""
    return _fuses_blown.get(site, False)


def reset_session() -> None:
    """Drop session fuses and failure counts (clear_caches/tests)."""
    _fuse_failures.clear()
    _fuses_blown.clear()
