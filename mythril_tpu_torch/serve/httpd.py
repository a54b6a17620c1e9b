"""Localhost HTTP listener for the serve daemon
(mythril_tpu.serve.httpd on the port's sources).

Endpoints (loopback only — the daemon is an in-datacenter sidecar, not
an internet service; put real auth/TLS termination in front of it):

  GET  /healthz   liveness + drain state + queue depth + the request
                  admission/disposition counters; `ok` false (503) once
                  the daemon stopped serving, with the reason
  GET  /metrics   the Prometheus text exposition rendered from a
                  FRESH live registry snapshot at scrape time — never
                  the last heartbeat file write, so scrape freshness is
                  independent of MYTHRIL_GPU_HEARTBEAT_INTERVAL (the
                  mythril_tpu_torch_snapshot_ts gauge pins it)
  GET  /snapshot  the raw live snapshot as JSON (metrics.snapshot()) —
                  what the fleet supervisor's per-shard /metrics rollup
                  fetches and merges
  POST /analyze   {"tenant": ..., "code": "0x...", "name"?, "tx_count"?,
                  "deadline_s"?, "bin_runtime"?} -> the request's
                  terminal outcome JSON. Backpressure is an HTTP answer:
                  429 overloaded, 503 draining — never unbounded queue
                  latency.
  POST /evict     {"tenant": ...} -> session-scoped memo eviction.

ThreadingHTTPServer: each client holds one handler thread while its
request is in flight, so N concurrent clients drive the daemon's queue
exactly like the soak harness does.
"""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

log = logging.getLogger(__name__)

STATUS_CODES = {
    "ok": 200,
    "error": 200,        # answered: the error is the tenant's payload
    "incomplete": 504,
    "device_fault": 500,  # the device path failed: the daemon stops
}
REJECT_CODES = {
    "overloaded": 429,
    "draining": 503,
    "evicting": 503,   # transient: retry once the eviction lands
    "device_fault": 503,  # the daemon stopped serving on a device fault
    "stopped": 503,       # ... or after a batch it could not stop
}


def status_code(outcome: dict) -> int:
    """HTTP code for a terminal outcome: rejections map by reason
    (overloaded/draining backpressure; anything else — e.g. malformed
    bytecode — is the client's 400), answered outcomes by status."""
    if outcome.get("status") == "rejected":
        return REJECT_CODES.get(outcome.get("reason"), 400)
    return STATUS_CODES.get(outcome.get("status"), 200)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def daemon(self):
        return self.server.serve_daemon

    def log_message(self, fmt, *args):  # quiet: route through logging
        log.debug("http: " + fmt, *args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; version=0.0.4"
                   ) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
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
            health = self.daemon.healthz()
            code = 200 if health["ok"] else 503
            self._send_json(code, health)
            return
        if self.path == "/metrics":
            # a fresh snapshot per scrape (prometheus_text defaults to
            # one): freshness never depends on the heartbeat cadence
            from mythril_tpu_torch.observe.metrics import prometheus_text

            self._send_text(200, prometheus_text(scrape_stamp=True))
            return
        if self.path == "/snapshot":
            from mythril_tpu_torch.observe.metrics import snapshot

            self._send_json(200, snapshot())
            return
        self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path == "/analyze":
            payload = self._read_body()
            if not payload or "code" not in payload:
                self._send_json(400, {"error": "body must be JSON with "
                                               "at least a `code` key"})
                return
            request = self.daemon.submit(
                tenant=payload.get("tenant", "anonymous"),
                code=payload["code"],
                name=payload.get("name"),
                tx_count=payload.get("tx_count"),
                deadline_s=payload.get("deadline_s"),
                bin_runtime=bool(payload.get("bin_runtime", False)),
                modules=payload.get("modules"),
            )
            # wait for the DAEMON's terminal answer rather than
            # fabricating one on a guessed bound: queue wait under load
            # can legitimately exceed any per-request deadline multiple
            # (the daemon's own deadline/requeue/drain machinery is
            # what guarantees resolution). The only synthesized answer
            # is for a daemon that drained away underneath the wait.
            outcome = None
            while outcome is None:
                outcome = request.wait(timeout=30.0)
                if outcome is None and self.daemon.drained.is_set():
                    outcome = request.wait(timeout=5.0) or {
                        "status": "incomplete",
                        "reason": "daemon drained",
                        "request_id": request.request_id}
            self._send_json(status_code(outcome), outcome)
            return
        if self.path == "/evict":
            payload = self._read_body()
            if not payload or "tenant" not in payload:
                self._send_json(400, {"error": "body must be JSON with "
                                               "a `tenant` key"})
                return
            if self.daemon.evict_tenant(payload["tenant"]):
                self._send_json(200, {"status": "ok",
                                      "evicted": payload["tenant"]})
            else:
                self._send_json(409, {"status": "busy",
                                      "tenant": payload["tenant"]})
            return
        self._send_json(404, {"error": f"unknown path {self.path}"})


class ServeHTTP:
    """The daemon's listener: loopback-bound, port 0 = ephemeral (tests
    read `.port` after start)."""

    def __init__(self, daemon, port: int):
        self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._server.daemon_threads = True
        self._server.serve_daemon = daemon
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="mythril-serve-http", daemon=True)

    def start(self) -> "ServeHTTP":
        self._thread.start()
        return self

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)
