"""Fleet supervisor: spawns the shard workers, routes /analyze by
content digest, health-probes, crash-only restarts, and rolls every
shard's live metrics into one /metrics (mythril_tpu.fleet.supervisor on
the port's sources).

On the card: every shard is a process with its own CUDA context on the
one card. The supervisor resolves the device and builds every kernel of
the path before it spawns a shard, and each shard loads that build (the
libraries under mythril_tpu_torch/_build/ are newer than their sources),
so two nvcc builds never race there. A shard's argv carries the solver
backend and the torch device, so a CPU test fleet runs on the CPU and a
fleet on the card runs on the card. A shard that met a device fault
answers `device_fault` and exits 2; the probe restarts it crash-only,
and its new incarnation must find and build for the card, or it fails to
start (it exits before announcing).

Front-door endpoints (loopback, like the single-process daemon):

  POST /analyze   routed to the digest's rendezvous shard and proxied;
                  a shard that dies or faults mid-request re-routes the
                  request ONCE to a surviving shard (fleet.shard
                  `worker_requeue`), then answers `incomplete` — zero
                  lost requests, never a hang.
  POST /evict     broadcast to every live shard (a tenant's warm memos
                  may live on any shard its digests routed to).
  GET  /healthz   fleet rollup: per-shard liveness, ports, restarts.
  GET  /fleetz    per-shard heat map (requests, warm hits, net-tier
                  hits) for the soak harness — read from each shard's
                  /snapshot.
  GET  /metrics   one Prometheus exposition for the whole fleet: each
                  shard's /snapshot merged (counters summed, ratio
                  gauges recomputed from the merged counters) with the
                  supervisor's own snapshot, plus per-shard heat-map
                  series labelled {shard="N"}.

Failure model (registered fault site fleet.shard, retry): the
supervisor never trusts a shard to stay up. A dead process or three
consecutive failed health probes triggers a crash-only restart —
fleet_shard_restarts, `retry` event — and the replacement re-warms from
the shared network tier, so the only cost of a shard death is the warm
MEMORY affinity of its digests until traffic re-warms it. SIGTERM
drains the fleet: stop admitting, SIGTERM every worker (each finishes
its in-flight requests under the daemon's drain), then stop the front.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from mythril_tpu_torch.fleet import probe_interval_s, start_timeout_s
from mythril_tpu_torch.fleet.router import ShardRouter, request_digest
from mythril_tpu_torch.serve.daemon import (
    DEFAULT_DEADLINE_S,
    DEFAULT_DRAIN_TIMEOUT_S,
)

log = logging.getLogger(__name__)

# consecutive failed health probes before a live-looking process is
# declared wedged and crash-only restarted
PROBE_FAILURE_LIMIT = 3


class _Shard:
    """One worker incarnation (the proc handle is Popen-like: tests
    inject stubs through the supervisor's spawn override)."""

    def __init__(self, shard_id: int):
        self.shard_id = shard_id
        self.proc = None
        self.port: Optional[int] = None
        self.restarts = 0
        self.probe_failures = 0

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None \
            and self.port is not None


class FleetSupervisor:
    def __init__(self, shards: int, tx_count: int = 1,
                 modules: Optional[List[str]] = None,
                 http_port: Optional[int] = None,
                 spawn=None):
        self.shard_count = max(1, int(shards))
        self.tx_count = tx_count
        self.modules = modules
        self.http_port = http_port
        self.port: Optional[int] = None
        # spawn(shard_id, announce_path) -> Popen-like; the default
        # launches the real worker module. Tests inject stub shards.
        self._spawn = spawn or self._spawn_worker
        self.router = ShardRouter(range(self.shard_count))
        # the device the shards run on, as the supervisor's args name it
        self.solver_backend = "gpu"
        self.torch_device: Optional[str] = None
        self._shards: Dict[int, _Shard] = {
            sid: _Shard(sid) for sid in range(self.shard_count)}
        self._lock = threading.Lock()
        self._draining = False
        self.drained = threading.Event()
        self._probe_stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._run_dir: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
        from mythril_tpu_torch.support.args import args

        self.solver_backend = args.solver_backend
        self.torch_device = args.torch_device
        if self.solver_backend == "gpu":
            # NoDeviceError without a card and without a device named; the
            # shards load this build instead of racing their own
            from mythril_tpu_torch import core
            from mythril_tpu_torch.gpu.device import resolve_device

            if resolve_device(self.torch_device).type == "cuda":
                core.build_device_kernels()
        SolverStatistics().enabled = True
        faults.configure_from_env(getattr(args, "inject_fault", None))
        self._run_dir = tempfile.mkdtemp(prefix="mythril-fleet-")
        for shard in self._shards.values():
            self._start_shard(shard)
        if self.http_port is not None:
            self._http = ThreadingHTTPServer(
                ("127.0.0.1", self.http_port), _FleetHandler)
            self._http.daemon_threads = True
            self._http.fleet = self
            self.port = self._http.server_address[1]
            self._http_thread = threading.Thread(
                target=self._http.serve_forever,
                name="mythril-fleet-http", daemon=True)
            self._http_thread.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="mythril-fleet-probe",
            daemon=True)
        self._probe_thread.start()
        log.info("fleet supervisor up: %d shard(s), port=%s",
                 self.shard_count, self.port)
        return self

    def _spawn_worker(self, shard_id: int, announce_path: str):
        """Launch one real worker process. stdout/stderr go to a log
        file (a filled pipe nobody drains would wedge the worker)."""
        log_path = os.path.join(self._run_dir,
                                f"shard-{shard_id}.log")
        log_fd = open(log_path, "ab")
        argv = [sys.executable, "-m", "mythril_tpu_torch.fleet.worker",
                "--shard-id", str(shard_id),
                "--announce", announce_path,
                "--tx-count", str(self.tx_count),
                "--solver-backend", self.solver_backend]
        if self.torch_device:
            argv += ["--torch-device", self.torch_device]
        if self.modules:
            argv += ["--modules", ",".join(self.modules)]
        proc = subprocess.Popen(argv, stdout=log_fd, stderr=log_fd,
                                close_fds=True)
        log_fd.close()
        return proc

    def _start_shard(self, shard: _Shard) -> bool:
        """Spawn one incarnation and wait for its announce handshake.
        The announce path is per-incarnation so a crashed worker's
        stale announcement can never be mistaken for the new one."""
        announce = os.path.join(
            self._run_dir,
            f"shard-{shard.shard_id}.{shard.restarts}.json")
        try:
            shard.proc = self._spawn(shard.shard_id, announce)
        except Exception as error:
            log.error("spawning shard %d failed: %r",
                      shard.shard_id, error)
            shard.proc = None
            return False
        deadline = time.monotonic() + start_timeout_s()
        while time.monotonic() < deadline:
            if shard.proc.poll() is not None:
                log.error("shard %d exited rc=%s before announcing",
                          shard.shard_id, shard.proc.poll())
                return False
            try:
                with open(announce) as fd:
                    info = json.load(fd)
                shard.port = int(info["port"])
                shard.probe_failures = 0
                log.info("shard %d announced on port %d",
                         shard.shard_id, shard.port)
                return True
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)
        log.error("shard %d did not announce within %.0fs",
                  shard.shard_id, start_timeout_s())
        return False

    # -- health probe / crash-only restart ----------------------------------

    def _probe_loop(self) -> None:
        interval = probe_interval_s()
        while not self._probe_stop.wait(interval):
            if self._draining:
                return
            for shard in list(self._shards.values()):
                if self._draining or self._probe_stop.is_set():
                    return
                self._probe_shard(shard)

    def _probe_shard(self, shard: _Shard) -> None:
        if shard.proc is None or shard.proc.poll() is not None:
            self._restart_shard(shard, "process dead")
            return
        try:
            code, _health = _http_call(
                shard.port, "GET", "/healthz",
                timeout=max(1.0, probe_interval_s()))
            if code in (200, 503):   # 503 = draining, still alive
                shard.probe_failures = 0
                return
            shard.probe_failures += 1
        except Exception:
            shard.probe_failures += 1
        if shard.probe_failures >= PROBE_FAILURE_LIMIT:
            self._restart_shard(
                shard, f"{shard.probe_failures} failed probes")

    def _restart_shard(self, shard: _Shard, reason: str) -> None:
        """Crash-only: kill whatever is left, spawn a replacement. The
        replacement re-warms from the shared network tier — nothing a
        dead shard settled is lost to the fleet."""
        from mythril_tpu_torch.resilience import record_event
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        log.warning("restarting shard %d (%s)", shard.shard_id, reason)
        if shard.proc is not None and shard.proc.poll() is None:
            try:
                shard.proc.kill()
                shard.proc.wait(timeout=10.0)
            except Exception:
                pass
        with self._lock:
            shard.port = None
            shard.probe_failures = 0
            shard.restarts += 1
        SolverStatistics().add_fleet_shard_restart()
        record_event("fleet.shard", "retry")
        self._start_shard(shard)

    # -- routing / proxy -----------------------------------------------------

    def _live_shard_ids(self, exclude=()) -> List[int]:
        with self._lock:
            return [shard.shard_id for shard in self._shards.values()
                    if shard.alive and shard.shard_id not in exclude]

    def handle_analyze(self, payload: dict):
        """Route one request to its digest's shard and proxy it; on a
        shard fault, re-route ONCE to a surviving shard, then answer
        `incomplete` (the fleet-level mirror of the daemon's
        requeue-once-then-incomplete worker discipline)."""
        from mythril_tpu_torch.resilience import maybe_inject, record_event
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        if self._draining:
            return 503, {"status": "rejected", "reason": "draining"}
        stats = SolverStatistics()
        digest = request_digest(payload.get("code", ""))
        timeout = float(payload.get("deadline_s")
                        or DEFAULT_DEADLINE_S) * 2 + 90.0
        tried: List[int] = []
        last_error = "no live shards"
        for attempt in range(2):
            shard_id = self.router.route(
                digest, live=self._live_shard_ids(exclude=tried))
            if shard_id is None:
                break
            with self._lock:
                port = self._shards[shard_id].port
            try:
                maybe_inject("fleet.shard")
                code, outcome = _http_call(
                    port, "POST", "/analyze", payload, timeout=timeout)
                if isinstance(outcome, dict):
                    outcome.setdefault("shard", shard_id)
                return code, outcome
            except Exception as error:
                last_error = repr(error)
                tried.append(shard_id)
                if attempt == 0:
                    record_event("fleet.shard", "worker_requeue")
                    stats.add_fleet_requeue()
                    log.warning(
                        "shard %d failed request mid-proxy (%s); "
                        "re-routing once to a surviving shard",
                        shard_id, last_error)
        record_event("fleet.shard", "degraded")
        return 504, {"status": "incomplete",
                     "reason": f"shard failure: {last_error}"}

    def handle_evict(self, tenant: str):
        """Broadcast eviction: a tenant's warm memos may live on every
        shard its digests routed to. Busy on any shard = busy."""
        results = {}
        for shard_id in self._live_shard_ids():
            with self._lock:
                port = self._shards[shard_id].port
            try:
                code, _body = _http_call(
                    port, "POST", "/evict", {"tenant": tenant},
                    timeout=90.0)
                results[shard_id] = code
            except Exception:
                results[shard_id] = None
        if results and all(code == 200 for code in results.values()):
            return 200, {"status": "ok", "evicted": tenant}
        return 409, {"status": "busy", "tenant": tenant,
                     "shards": {str(k): v for k, v in results.items()}}

    # -- observability -------------------------------------------------------

    def healthz(self) -> dict:
        with self._lock:
            shards = {
                str(shard.shard_id): {
                    "alive": shard.alive,
                    "port": shard.port,
                    "restarts": shard.restarts,
                }
                for shard in self._shards.values()}
        live = sum(1 for row in shards.values() if row["alive"])
        status = "draining" if self._draining else (
            "ok" if live == self.shard_count else "degraded")
        return {"status": status, "shards": shards,
                "live": live, "total": self.shard_count}

    def _shard_snapshots(self) -> Dict[int, Optional[dict]]:
        """Each live shard's /snapshot (None for dead/unreachable)."""
        snaps: Dict[int, Optional[dict]] = {}
        for shard_id in sorted(self._shards):
            with self._lock:
                shard = self._shards[shard_id]
                port = shard.port if shard.alive else None
            snap = None
            if port is not None:
                try:
                    _code, snap = _http_call(port, "GET", "/snapshot",
                                             timeout=10.0)
                except Exception:
                    snap = None
            snaps[shard_id] = snap if isinstance(snap, dict) else None
        return snaps

    def fleetz(self) -> dict:
        """The heat map the soak harness reads: per-shard request and
        warm-hit tallies from each shard's live snapshot."""
        health = self.healthz()
        snaps = self._shard_snapshots()
        heat = {}
        for shard_id, snap in snaps.items():
            row = dict(health["shards"][str(shard_id)])
            if snap is not None:
                counters = snap.get("counters", {})
                row.update({
                    "requests_admitted":
                        counters.get("serve_requests_admitted", 0),
                    "requests_completed":
                        counters.get("serve_requests_completed", 0),
                    "memo_hits": (counters.get("memory_hits", 0)
                                  + counters.get("quick_sat_hits", 0)),
                    "persistent_hits":
                        counters.get("persistent_hits", 0),
                    "net_tier_hits": counters.get("net_tier_hits", 0),
                    "net_tier_stores":
                        counters.get("net_tier_stores", 0),
                    "cdcl_settles": counters.get("cdcl_settles", 0),
                })
            heat[str(shard_id)] = row
        health["shards"] = heat
        return health

    def metrics_text(self) -> str:
        """One fleet-wide Prometheus exposition: every live shard's
        snapshot merged with the supervisor's own (counters summed,
        ratio gauges recomputed), plus per-shard heat-map series."""
        from mythril_tpu_torch.observe import metrics

        snaps = self._shard_snapshots()
        merged = metrics.merge_snapshots(
            [metrics.snapshot()]
            + [snap for snap in snaps.values() if snap is not None])
        lines = [metrics.prometheus_text(
            merged, scrape_stamp=True).rstrip("\n")]
        for series, key in (
                ("fleet_shard_requests", "serve_requests_completed"),
                ("fleet_shard_warm_hits", None),
                ("fleet_shard_net_tier_hits", "net_tier_hits")):
            prom = metrics.PROM_PREFIX + series
            lines.append(f"# TYPE {prom} counter")
            for shard_id, snap in snaps.items():
                if snap is None:
                    continue
                counters = snap.get("counters", {})
                if key is None:   # warm hits: every cache tier
                    value = (counters.get("memory_hits", 0)
                             + counters.get("quick_sat_hits", 0)
                             + counters.get("persistent_hits", 0))
                else:
                    value = counters.get(key, 0)
                lines.append(f'{prom}{{shard="{shard_id}"}} {value}')
        return "\n".join(lines) + "\n"

    # -- drain ---------------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, SIGTERM every worker (each drains its
        in-flight requests under the daemon's drain), then stop the
        front door. True = every shard exited within the budget."""
        budget = timeout if timeout is not None \
            else DEFAULT_DRAIN_TIMEOUT_S
        start = time.monotonic()
        self._draining = True
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=probe_interval_s() + 5.0)
        clean = True
        for shard in self._shards.values():
            if shard.proc is not None and shard.proc.poll() is None:
                try:
                    shard.proc.terminate()
                except Exception:
                    pass
        for shard in self._shards.values():
            if shard.proc is None:
                continue
            remaining = max(0.5, budget - (time.monotonic() - start))
            try:
                shard.proc.wait(timeout=remaining)
            except Exception:
                clean = False
                try:
                    shard.proc.kill()
                    shard.proc.wait(timeout=10.0)
                except Exception:
                    pass
        if self._http is not None:
            try:
                self._http.shutdown()
                self._http.server_close()
            except Exception:
                pass
            if self._http_thread is not None:
                self._http_thread.join(timeout=5.0)
            self._http = None
        self.drained.set()
        log.info("fleet drained in %.2fs (clean=%s)",
                 time.monotonic() - start, clean)
        return clean


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def fleet(self) -> FleetSupervisor:
        return self.server.fleet

    def log_message(self, fmt, *args):
        log.debug("fleet http: " + fmt, *args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Optional[dict]:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(length) or b"{}")
        except Exception:
            return None

    def do_GET(self):
        if self.path == "/healthz":
            health = self.fleet.healthz()
            self._send_json(200 if health["status"] == "ok" else 503,
                            health)
            return
        if self.path == "/fleetz":
            self._send_json(200, self.fleet.fleetz())
            return
        if self.path == "/metrics":
            self._send_text(200, self.fleet.metrics_text())
            return
        self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path == "/analyze":
            payload = self._read_body()
            if not payload or "code" not in payload:
                self._send_json(400, {"error": "body must be JSON with "
                                               "at least a `code` key"})
                return
            code, outcome = self.fleet.handle_analyze(payload)
            self._send_json(code, outcome)
            return
        if self.path == "/evict":
            payload = self._read_body()
            if not payload or "tenant" not in payload:
                self._send_json(400, {"error": "body must be JSON with "
                                               "a `tenant` key"})
                return
            code, outcome = self.fleet.handle_evict(payload["tenant"])
            self._send_json(code, outcome)
            return
        self._send_json(404, {"error": f"unknown path {self.path}"})


def _http_call(port: int, method: str, path: str,
               payload: Optional[dict] = None,
               timeout: float = 30.0):
    """One loopback HTTP round trip to a shard; raises on transport
    failure (the caller's requeue discipline handles it)."""
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps(payload).encode() if payload is not None \
            else None
        headers = {"Content-Type": "application/json"} \
            if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        response = conn.getresponse()
        raw = response.read()
        try:
            return response.status, json.loads(raw)
        except ValueError:
            return response.status, raw.decode(errors="replace")
    finally:
        conn.close()


def serve_forever_fleet(supervisor: FleetSupervisor) -> int:
    """CLI entry: start the fleet, announce, block until drained."""
    import signal

    supervisor.start()

    def _handler(_signum, _frame):
        threading.Thread(target=supervisor.drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
    print(f"mythril_tpu_torch fleet listening on "
          f"http://127.0.0.1:{supervisor.port} "
          f"({supervisor.shard_count} shards; POST /analyze, "
          f"POST /evict, GET /healthz, GET /fleetz, GET /metrics); "
          f"SIGTERM drains", flush=True)
    supervisor.drained.wait()
    return 0
