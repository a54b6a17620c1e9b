"""Always-on flight recorder: a bounded ring of recent spans and resilience
events, dumped as a post-mortem artifact when something trips (a copy of
mythril_tpu.observe.flightrec with the knob prefix changed).

The span tracer answers "what happened" only when MYTHRIL_GPU_TRACE was
armed before the run. The ring records the most recent spans at all times
(the tracer feeds it whether or not full tracing is armed), and is dumped
to disk at the first sign of trouble:

  trigger                       where it fires
  breaker_trip                  resilience/breaker.py _trip (any site)
  deadline                      resilience/deadline.py run_with_deadline
                                (K1's dispatch abandoned at its deadline)
  run incomplete                fire_lasers' finally with completed=False
                                (a module exception, a DeviceFault)

Each dump is a self-describing JSON artifact (metrics.stamp(): schema
version, git rev, platform) carrying the trigger, the ring in time order
and the per-site resilience event counts at dump time. Dumps are capped
per process (MAX_DUMPS): the first dumps show what led up to a fault.

Knobs: MYTHRIL_GPU_FLIGHTREC=0 turns the recorder off (span() reverts to
the shared no-op object); MYTHRIL_GPU_FLIGHTREC_DIR picks the dump
directory (default: the system temp dir); MYTHRIL_GPU_FLIGHTREC_CAP sizes
the ring (default 512 events).
"""

import json
import logging
import os
import tempfile
import time
from collections import deque
from typing import Optional

log = logging.getLogger(__name__)

FLIGHTREC_ENV = "MYTHRIL_GPU_FLIGHTREC"
DIR_ENV = "MYTHRIL_GPU_FLIGHTREC_DIR"
CAP_ENV = "MYTHRIL_GPU_FLIGHTREC_CAP"
DEFAULT_CAP = 512
MAX_DUMPS = 4

# resilience event names that dump the ring
TRIGGER_EVENTS = ("breaker_trip", "deadline")
RUN_INCOMPLETE = "run_incomplete"

_dumps_written = 0


def ring_capacity() -> int:
    """Ring size in events; 0 turns the recorder off."""
    if os.environ.get(FLIGHTREC_ENV, "1") == "0":
        return 0
    try:
        return max(int(os.environ.get(CAP_ENV, DEFAULT_CAP)), 0)
    except ValueError:
        return DEFAULT_CAP


def install() -> None:
    """Ensure the tracer singleton exists with a ring of the capacity the
    knobs set now (none when off): called at analyzer start
    (fire_lasers), so a process that changes the knobs between runs gets
    the ring it asked for."""
    from mythril_tpu_torch.observe.tracer import get_tracer

    tracer = get_tracer()
    cap = ring_capacity()
    ring = tracer._ring
    if (ring.maxlen if ring is not None else 0) != cap:
        tracer.attach_ring(deque(maxlen=cap) if cap > 0 else None)


def notify(site: str, event: str) -> Optional[str]:
    """Resilience-event hook (resilience.record_event, after the event
    entered the ring): dump the ring when `event` is a trigger. Returns
    the dump's path when one was written."""
    if event not in TRIGGER_EVENTS:
        return None
    return _dump({"site": site, "event": event})


def notify_run_incomplete() -> Optional[str]:
    """fire_lasers' finally saw completed=False: dump the ring before the
    tracer resets."""
    return _dump({"site": "analyze.run", "event": RUN_INCOMPLETE})


def dump_now(reason: str = "manual") -> Optional[str]:
    """Operator hook: dump the ring on demand."""
    return _dump({"site": "operator", "event": reason})


def _dump(trigger: dict) -> Optional[str]:
    global _dumps_written
    if ring_capacity() <= 0 or _dumps_written >= MAX_DUMPS:
        return None
    # called from inside resilience.record_event while a breaker or a
    # deadline is mid-degradation: the recorder must never turn that into a failure,
    # so nothing here escapes
    try:
        from mythril_tpu_torch.observe import metrics
        from mythril_tpu_torch.observe.tracer import Tracer
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        tracer = Tracer._instance
        events = tracer.ring_events() if tracer is not None else []
        stats = SolverStatistics()
        payload = metrics.stamp()
        payload.update({
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "trigger": trigger,
            "ring_capacity": ring_capacity(),
            "events": events,
            "resilience": {site: dict(site_events) for site, site_events
                           in list(stats.resilience_events.items())},
        })
        directory = os.environ.get(DIR_ENV) or tempfile.gettempdir()
        prefix = f"mythril_tpu_torch_flightrec_{os.getpid()}_"
        path = os.path.join(directory, f"{prefix}{_dumps_written}.json")
        os.makedirs(directory, exist_ok=True)
        # O_EXCL: the default directory is the world-writable temp dir and
        # the name is predictable, so never follow a planted symlink; a
        # taken name falls back to a random one
        try:
            handle = os.open(path,
                             os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except OSError:
            handle, path = tempfile.mkstemp(prefix=prefix, suffix=".json",
                                            dir=directory)
        with os.fdopen(handle, "w") as fd:
            json.dump(payload, fd)
    except Exception as error:
        log.warning("flight-recorder dump failed (%s)", error)
        return None
    _dumps_written += 1
    log.warning("flight recorder dumped %d recent events to %s "
                "(trigger: %s at %s)", len(events), path,
                trigger.get("event"), trigger.get("site"))
    return path


def reset() -> None:
    """Testing hook: allow MAX_DUMPS fresh dumps."""
    global _dumps_written
    _dumps_written = 0
