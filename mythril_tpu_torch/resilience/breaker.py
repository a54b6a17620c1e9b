"""Per-stage circuit breaker with half-open re-probe (a copy of
mythril_tpu.resilience.breaker with the knob prefix changed).

The router (gpu/router.py) feeds it zero-hit device time: a device path
that keeps burning time without finding a model stops being used, and
comes back after a cooldown. Three states:

  closed     stage runs normally; failures accumulate (count + wasted
             seconds against an optional waste budget).
  open       stage is off; every allow() is refused until the cooldown
             elapses. A HARD failure opens immediately regardless of
             counts.
  half-open  after the cooldown, exactly ONE probe is admitted. Success
             closes the breaker (meters reset); failure re-opens it for
             another cooldown.

Transitions are counted into SolverStatistics (breaker_trip /
breaker_probe events).
"""

import logging
import time

log = logging.getLogger(__name__)

DEFAULT_COOLDOWN_S = 30.0
DEFAULT_FAILURE_THRESHOLD = 3

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def _count(site: str, event: str) -> None:
    from mythril_tpu_torch.resilience import record_event

    record_event(site, event)


class StageBreaker:
    """One breaker per registered stage; the owning stage consults
    allow() before running and reports record_success/record_failure."""

    def __init__(self, site: str, failure_threshold: int =
                 DEFAULT_FAILURE_THRESHOLD,
                 waste_budget_s: float = 0.0,
                 cooldown_s: float = 0.0):
        self.site = site
        self.failure_threshold = failure_threshold
        # 0 = no waste budget (count-threshold only); the router passes
        # its MYTHRIL_GPU_DEVICE_MAX_WASTE budget here
        self.waste_budget_s = waste_budget_s
        self.cooldown_s = cooldown_s if cooldown_s > 0 else DEFAULT_COOLDOWN_S
        self.state = CLOSED
        self.failures = 0
        self.waste_s = 0.0
        self.trips = 0
        self._reopen_at = 0.0
        self._probe_admitted_at = 0.0

    # -- queries --------------------------------------------------------------

    def allow(self) -> bool:
        """May the stage run now? Open breakers refuse until the cooldown
        elapses, then admit exactly one half-open probe. An admitted probe
        that never reports an outcome (the caller was admitted but found
        no eligible work to dispatch — e.g. every query in the window was
        filtered before the device call) EXPIRES after another cooldown
        and a new probe is admitted, so an outcome-less admission can
        never leave the stage off for good."""
        if self.state == CLOSED:
            return True
        now = time.monotonic()
        if self.state == OPEN and now >= self._reopen_at:
            self.state = HALF_OPEN
            self._probe_admitted_at = now
            _count(self.site, "breaker_probe")
            log.info("%s breaker half-open: admitting one re-probe",
                     self.site)
            return True
        if self.state == HALF_OPEN \
                and now - self._probe_admitted_at >= self.cooldown_s:
            self._probe_admitted_at = now
            _count(self.site, "breaker_probe")
            log.info("%s breaker: outstanding re-probe reported no "
                     "outcome for %.0fs; admitting a fresh one",
                     self.site, self.cooldown_s)
            return True
        # open and cooling down, or a half-open probe already in flight
        return False

    @property
    def tripped(self) -> bool:
        """True while the stage is off (open and still cooling down, or
        a half-open probe in flight)."""
        return self.state != CLOSED

    # -- transitions ----------------------------------------------------------

    def record_success(self) -> None:
        if self.state != CLOSED:
            log.info("%s breaker closed: re-probe succeeded", self.site)
        self.state = CLOSED
        self.failures = 0
        self.waste_s = 0.0

    def record_failure(self, wasted_s: float = 0.0, hard: bool = False,
                       count: bool = True) -> None:
        """One stage failure. `wasted_s` charges the waste budget (the
        router's fruitless device seconds); `hard` trips immediately
        (deadline exceeded: the backend is wedged, not slow);
        count=False charges ONLY the waste budget — a zero-hit device
        dispatch is a legitimate outcome (the CDCL settles it), not an
        error, so it must never reach the count threshold on a healthy
        fast device."""
        self.waste_s += wasted_s
        if count:
            self.failures += 1
        if self.state == HALF_OPEN and (count or hard):
            # only a real ERROR re-opens a probe immediately; a clean
            # zero-hit probe (count=False) is a legitimate outcome on an
            # UNSAT-heavy stretch — it stays half-open (one dispatch per
            # cooldown) and re-trips only through the waste budget below,
            # which _trip resets, so the budget meters the window SINCE
            # the last trip rather than instantly re-tripping forever
            self._trip("re-probe failed")
            return
        if hard:
            self._trip("hard failure")
            return
        if count and self.failures >= self.failure_threshold:
            self._trip(f"{self.failures} consecutive failures")
            return
        if self.waste_budget_s and self.waste_s > self.waste_budget_s:
            self._trip(f"{self.waste_s:.1f}s wasted "
                       f"(budget {self.waste_budget_s:.1f}s)")

    def force_open(self, reason: str = "forced") -> None:
        """Administrative trip (e.g. backend unavailable at startup)."""
        if self.state != OPEN:
            self._trip(reason)

    def _trip(self, reason: str) -> None:
        self.state = OPEN
        self.trips += 1
        # meters measure the window since the last trip: without the
        # reset, a breaker opened on waste would re-trip on the first
        # half-open probe's epsilon of new waste, terminally
        self.failures = 0
        self.waste_s = 0.0
        self._reopen_at = time.monotonic() + self.cooldown_s
        _count(self.site, "breaker_trip")
        log.warning("%s breaker OPEN (%s): degrading to the sound path "
                    "for %.0fs, then one re-probe", self.site, reason,
                    self.cooldown_s)

    def reset(self) -> None:
        self.state = CLOSED
        self.failures = 0
        self.waste_s = 0.0
        self._reopen_at = 0.0
