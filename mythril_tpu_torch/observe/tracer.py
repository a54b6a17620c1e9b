"""Hierarchical span tracer with Chrome-trace-event / Perfetto export.

Usage (the instrumented seams of the port):

    from mythril_tpu_torch.observe.tracer import span

    with span("device.kernel", cat="device", cones=n) as sp:
        ...
        sp.set(rounds=rounds)      # attach attributes discovered mid-span

Full tracing is OFF unless MYTHRIL_GPU_TRACE names a path (or enable()
is called). The flight recorder's ring (observe/flightrec.py) is on
unless MYTHRIL_GPU_FLIGHTREC=0: every completed span also lands in a
bounded deque, so a post-mortem dump has the recent timeline even when
nothing was armed. With both off, span() returns ONE shared no-op
object, so a disabled seam costs a global load, a truthiness check and
an empty context manager. Completed spans append under one lock;
Perfetto nests complete ("X") events by containment per (pid, tid) lane,
so no parent tracking is needed. Export is the Chrome trace event format
(`traceEvents` array).

One clock: a span's start and end are integer time.time_ns() readings,
nanoseconds since the Unix epoch, the clock torch.profiler's (kineto's)
events are stamped on. So a span and the device activity of a profiled
run lie on one time line, and a gap in the device's activity can be
named by the span open across it. An event's `ts` and `dur` are those
readings in microseconds (the Chrome format's unit); the exported file
moves `ts` to start at its earliest event.
"""

import json
import logging
import os
import threading
import time
from collections import deque
from functools import wraps
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

TRACE_ENV = "MYTHRIL_GPU_TRACE"


class _NullSpan:
    """Shared do-nothing span — the entire disabled-mode code path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records itself into the tracer on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_start_ns")

    def __init__(self, tracer, name, cat, attrs):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = attrs

    def __enter__(self):
        self._start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._record(self.name, self.cat, self._start_ns,
                             time.time_ns(), self.args)
        return False

    def set(self, **attrs):
        self.args.update(attrs)
        return self


class Tracer:
    """Process-global span collector (singleton, like SolverStatistics)."""

    _instance: Optional["Tracer"] = None

    def __new__(cls):
        if cls._instance is None:
            inst = super().__new__(cls)
            inst.enabled = False
            inst.path = None
            inst._events = []
            inst._lock = threading.Lock()
            inst._pid = os.getpid()
            # the flight recorder's bounded ring (0 capacity: no ring)
            from mythril_tpu_torch.observe import flightrec

            cap = flightrec.ring_capacity()
            inst._ring = deque(maxlen=cap) if cap > 0 else None
            # THE hot-path flag span() reads: full tracing or the ring
            # wants events
            inst._active = inst._ring is not None
            cls._instance = inst
            path = os.environ.get(TRACE_ENV)
            if path:
                inst.enable(path)
        return cls._instance

    def enable(self, path: Optional[str] = None) -> None:
        """Start collecting spans; write() exports them to `path`."""
        self.path = path
        self._pid = os.getpid()
        self.enabled = True
        self._active = True

    def reset(self) -> None:
        """Drop collected events and the ring's, and disable full
        tracing; the ring stays installed."""
        with self._lock:
            self._events = []
            if self._ring is not None:
                self._ring.clear()
        self.enabled = False
        self._active = self._ring is not None
        self.path = None

    def attach_ring(self, ring) -> None:
        """Install (or replace) the flight recorder's span ring; None
        detaches it and restores the pure no-op disabled path."""
        with self._lock:
            self._ring = ring
        self._active = self.enabled or self._ring is not None

    def ring_events(self) -> List[dict]:
        """The ring's spans in completion order (oldest first)."""
        with self._lock:
            return list(self._ring) if self._ring is not None else []

    def _record(self, name, cat, start_ns, end_ns, attrs) -> None:
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": start_ns / 1e3,
            "dur": (end_ns - start_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            if self._ring is not None:
                self._ring.append(event)
            if self.enabled:
                self._events.append(event)

    def drain_events(self) -> List[dict]:
        """Take every collected event: a --jobs worker's side of the
        merge (plain dicts that pickle back to the parent;
        mythril_tpu/observe/tracer.py:204)."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def absorb_events(self, events) -> None:
        """Fold a worker's drained events into this (the parent's)
        tracer (:211). They carry the worker's pid, so each worker keeps
        its own process lane in the merged timeline."""
        if not events:
            return
        with self._lock:
            self._events.extend(events)

    def summary(self) -> Dict[str, list]:
        """{stage name: [span count, total seconds]} over every event."""
        out: Dict[str, list] = {}
        with self._lock:
            events = list(self._events)
        for event in events:
            record = out.setdefault(event["name"], [0, 0.0])
            record[0] += 1
            record[1] += event["dur"] / 1e6
        for record in out.values():
            record[1] = round(record[1], 4)
        return out

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def write(self, path: Optional[str] = None) -> Optional[str]:
        """Export the collected timeline as Chrome trace JSON. Returns the
        written path, or None when there was nowhere to write."""
        path = path or self.path
        if not path:
            return None
        events = self.events()
        base = min((e["ts"] for e in events), default=0.0)
        out_events = [dict(e, ts=round(e["ts"] - base, 3)) for e in events]
        # one process lane for the analyzer and one for each --jobs
        # worker whose events were absorbed
        pids = list(dict.fromkeys([self._pid]
                                  + [e["pid"] for e in out_events]))
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": ("mythril_tpu_torch" if pid == self._pid
                                   else f"mythril_tpu_torch worker {pid}")}}
                for pid in pids]
        try:
            with open(path, "w") as fd:
                json.dump({"traceEvents": meta + out_events,
                           "displayTimeUnit": "ms"}, fd)
        except OSError as error:
            log.warning("could not write trace to %s (%s)", path, error)
            return None
        return path


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)


def get_tracer() -> Tracer:
    return Tracer()


def span(name: str, cat: str = "stage", **attrs):
    """A span context manager, or the shared no-op when neither full
    tracing nor the flight recorder's ring wants events. THE hot-path
    entry point: keep the inactive branch allocation-free."""
    tracer = Tracer._instance
    if tracer is None:
        tracer = Tracer()
    if not tracer._active:
        return NULL_SPAN
    return _Span(tracer, name, cat, attrs)


def traced(name: str, cat: str = "stage"):
    """Decorator form of span() for whole-function stages."""

    def decorate(func):
        @wraps(func)
        def wrapped(*args, **kwargs):
            with span(name, cat):
                return func(*args, **kwargs)

        return wrapped

    return decorate
