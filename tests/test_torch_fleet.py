"""The port's sharded serve fleet (mythril_tpu_torch/fleet/), in
process: the router, the shared network tier and the supervisor over stub
shards (the counterparts of tests/test_fleet.py's unit cases), and the
fleet held to the JAX package's.

  * routing: digest-keyed rendezvous hashing, deterministic, balanced and
    minimally disruptive; a faulted router (fleet.route) degrades to
    round-robin;
  * the network tier: a corrupt shared entry is quarantined on the
    reading store as a safe miss (netstore.entry), the writer untouched;
  * the supervisor over stub shards: sticky routing, the fleet rollup and
    merged /metrics, re-routing once (fleet.shard), crash-only restart,
    drain;
  * parity (exact): request_digest, ShardRouter.route and the network
    tier's entry bytes equal the JAX package's for the same codes and
    shard ids, and the router's streams and admission counters on a
    two-tenant window with tenant-qualified origins equal the JAX
    router's (Pallas rules).

The fleet's fault sites cross processes, so their chaos cases live here
(resilience/lint.py reads this file)."""

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from mythril_tpu_torch.resilience import faults
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.torch_serve_helpers import (
    device_args,
    fresh_stats,
    full_reset,
    http_get,
    http_post,
)


@pytest.fixture(autouse=True)
def fleet_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    full_reset()
    device_args()
    stats = fresh_stats()
    yield stats
    full_reset()
    stats.reset()


def _events(site: str) -> dict:
    return SolverStatistics().as_dict()["resilience"]["sites"][site]


def _get_text(port, path):
    _code, text = http_get(port, path)
    return text


# -- router: deterministic, balanced, minimally disruptive --------------------


def test_router_deterministic_and_balanced():
    """Same digest -> same shard, every time — and over a digest corpus
    every shard of 4 receives traffic (rendezvous spreads the keyspace)."""
    from mythril_tpu_torch.fleet.router import ShardRouter, request_digest

    router = ShardRouter(range(4))
    digests = [request_digest(f"0x60{i:02x}") for i in range(64)]
    placement = {d: router.route(d) for d in digests}
    for digest, shard in placement.items():
        for _ in range(3):
            assert router.route(digest) == shard
    assert set(placement.values()) == {0, 1, 2, 3}
    assert SolverStatistics().fleet_shard_routes == 64 * 4


def test_router_rendezvous_minimal_reassignment():
    """Membership change moves ONLY the dead shard's keys: every digest
    that did not route to the removed shard keeps its warm shard."""
    from mythril_tpu_torch.fleet.router import ShardRouter, request_digest

    router = ShardRouter(range(4))
    digests = [request_digest(f"0x61{i:03x}") for i in range(200)]
    before = {d: router.route(d) for d in digests}
    lost = 2
    after = {d: router.route(d, live=[0, 1, 3]) for d in digests}
    assert any(shard == lost for shard in before.values())
    for digest in digests:
        if before[digest] != lost:
            assert after[digest] == before[digest], \
                "an unrelated key moved on membership change"
        else:
            assert after[digest] != lost


def test_route_fault_degrades_to_round_robin():
    """Registered site fleet.route (disable): a faulted scorer still
    places every request on a live shard — round-robin, cycling instead
    of sticky — and the injection reaches the stats JSON."""
    from mythril_tpu_torch.fleet.router import ShardRouter, request_digest

    faults.configure("fleet.route:raise:*")
    router = ShardRouter(range(3))
    digest = request_digest("0x6001")
    picks = [router.route(digest) for _ in range(6)]
    assert all(p in (0, 1, 2) for p in picks)
    assert len(set(picks)) > 1, \
        "round-robin degradation must cycle, not stick"
    recorded = _events("fleet.route")
    assert recorded["injected"] >= 1
    assert SolverStatistics().fleet_shard_routes == 6


# -- the shared network result tier -------------------------------------------


def test_corrupt_shared_entry_quarantined_on_reader_not_writer(tmp_path):
    """A torn/garbled entry in the shared directory — possibly written
    by a DIFFERENT shard — is quarantined by the READING store as a safe
    miss (netstore.entry `quarantine`, net_tier_verify_rejects), and the
    writing store keeps storing and serving untouched."""
    from mythril_tpu_torch.fleet.netstore import NetworkResultStore

    root = str(tmp_path / "net")
    writer = NetworkResultStore(root=root)
    reader = NetworkResultStore(root=root)
    fingerprint = "f" * 64
    assert writer.store_sat(fingerprint, 8, [True] * 9)

    # a sibling shard's torn write lands garbage over the entry
    with open(writer._path(fingerprint), "w") as fd:
        fd.write("{torn cross-host write")

    assert reader.lookup(fingerprint) is None, \
        "a corrupt shared entry must degrade to a miss, never a verdict"
    assert not os.path.exists(writer._path(fingerprint)), \
        "the corpse must be moved aside, never re-read"
    stats = SolverStatistics()
    assert stats.net_tier_verify_rejects == 1
    assert stats.persistent_verify_rejects == 1
    assert _events("netstore.entry")["quarantine"] >= 1

    # the writer's failure domain is untouched: fresh stores round-trip
    other = "a" * 64
    assert writer.store_sat(other, 8, [False] * 9)
    entry = writer.lookup(other)
    assert entry is not None and entry.verdict == "sat"
    assert stats.net_tier_verify_rejects == 1


def test_injected_netstore_corruption_is_reader_side_safe_miss(tmp_path):
    """Same degradation through the fault harness: netstore.entry:corrupt
    garbles the entry at READ time — the store quarantines and misses;
    with the fault disarmed the next write/read round-trips cleanly."""
    from mythril_tpu_torch.fleet.netstore import NetworkResultStore

    store = NetworkResultStore(root=str(tmp_path / "net"))
    fingerprint = "b" * 64
    assert store.store_unsat(fingerprint, crosschecked=True)
    faults.configure("netstore.entry:corrupt:*")
    assert store.lookup(fingerprint) is None
    recorded = _events("netstore.entry")
    assert recorded["injected"] >= 1
    assert recorded["quarantine"] >= 1
    faults.configure(None)
    assert store.store_unsat(fingerprint, crosschecked=True)
    entry = store.lookup(fingerprint)
    assert entry is not None and entry.verdict == "unsat"


def test_injected_netstore_raise_is_quarantined_safe_miss(tmp_path):
    """The site's `raise` kind (an I/O error mid-read, not garbled
    bytes) degrades identically: the entry is quarantined and the lookup
    is a safe miss — a crashing read path must never surface to the
    solver as anything but a cache miss."""
    from mythril_tpu_torch.fleet.netstore import NetworkResultStore

    store = NetworkResultStore(root=str(tmp_path / "net"))
    fingerprint = "c" * 64
    assert store.store_sat(fingerprint, 4, [True] * 5)
    faults.configure("netstore.entry:raise:*")
    assert store.lookup(fingerprint) is None
    recorded = _events("netstore.entry")
    assert recorded["injected"] >= 1
    assert recorded["quarantine"] >= 1
    faults.configure(None)
    assert store.store_sat(fingerprint, 4, [True] * 5)
    entry = store.lookup(fingerprint)
    assert entry is not None and entry.verdict == "sat"


# -- supervisor: stub shards (process machinery without engine cost) ----------


class _StubShard:
    """An in-process stand-in for one worker: a real HTTP server
    answering the worker surface (/healthz, /snapshot, /analyze) plus a
    Popen-like handle, injected through the supervisor's spawn seam."""

    def __init__(self, shard_id: int, announce_path: str,
                 fail_analyze: bool = False):
        self.shard_id = shard_id
        self.fail_analyze = fail_analyze
        self.analyzed = []
        self._rc = None
        stub = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif self.path == "/snapshot":
                    self._json(200, stub.snapshot())
                else:
                    self._json(404, {})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/analyze":
                    if stub.fail_analyze:
                        # die mid-request: force the FIN (close() alone
                        # leaves the fd alive via rfile/wfile refs)
                        self.connection.shutdown(socket.SHUT_RDWR)
                        self.close_connection = True
                        return
                    stub.analyzed.append(payload)
                    self._json(200, {"status": "ok", "issues": [],
                                     "stub": stub.shard_id})
                elif self.path == "/evict":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {})

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._server.daemon_threads = True
        # induced mid-request deaths are the point; keep stderr quiet
        self._server.handle_error = lambda *args: None
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        with open(announce_path, "w") as fd:
            json.dump({"pid": os.getpid(),
                       "port": self._server.server_address[1],
                       "shard_id": shard_id}, fd)

    def snapshot(self) -> dict:
        from mythril_tpu_torch.observe import metrics

        snap = metrics.snapshot()
        snap["counters"] = dict(snap["counters"])
        snap["counters"]["serve_requests_completed"] = len(self.analyzed)
        snap["counters"]["memory_hits"] = 2 * self.shard_id
        snap["counters"]["net_tier_hits"] = 10 + self.shard_id
        return snap

    # Popen-like surface the supervisor drives
    def poll(self):
        return self._rc

    def terminate(self):
        self.kill()

    def kill(self):
        if self._rc is None:
            self._rc = 0
            self._server.shutdown()
            self._server.server_close()

    def wait(self, timeout=None):
        return self._rc if self._rc is not None else 0


class _StubFleet:
    """Spawn seam for FleetSupervisor: records every incarnation so
    tests can kill specific shards and inspect restarts."""

    def __init__(self, fail_analyze=()):
        self.fail_analyze = set(fail_analyze)
        self.spawned = []

    def __call__(self, shard_id, announce_path):
        stub = _StubShard(shard_id, announce_path,
                          fail_analyze=shard_id in self.fail_analyze)
        self.spawned.append(stub)
        return stub

    def current(self, shard_id):
        return [s for s in self.spawned if s.shard_id == shard_id][-1]


def _fleet_post(port, path, payload, timeout=30.0):
    body = json.dumps(payload).encode()
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, json.load(response)
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read() or b"{}")


def _fleet_get(port, path, timeout=30.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as response:
        return response.read().decode()


def test_supervisor_sticky_routing_and_fleet_rollup(monkeypatch):
    """Identical bytecode — even from different tenants — proxies to the
    SAME shard (the warm-memory affinity the router exists for); /fleetz
    reads per-shard heat from the shard snapshots and /metrics merges
    them into one exposition with per-shard heat series."""
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "60")
    stubs = _StubFleet()
    fleet = FleetSupervisor(3, http_port=0, spawn=stubs).start()
    try:
        outs = [
            http_post(fleet.port, "/analyze",
                        {"tenant": tenant, "code": "0x6001"})[1]
            for tenant in ("alice", "bob", "carol")]
        assert {out["status"] for out in outs} == {"ok"}
        assert len({out["shard"] for out in outs}) == 1, \
            "identical digests must stick to one shard"
        assert all(out["shard"] == out["stub"] for out in outs)

        health = json.loads(_get_text(fleet.port, "/healthz"))
        assert health["status"] == "ok" and health["live"] == 3

        heat = json.loads(_get_text(fleet.port, "/fleetz"))["shards"]
        assert sum(row["requests_completed"]
                   for row in heat.values()) == 3
        hot = str(outs[0]["shard"])
        assert heat[hot]["requests_completed"] == 3

        text = _get_text(fleet.port, "/metrics")
        for shard_id in range(3):
            assert (f'mythril_tpu_torch_fleet_shard_requests{{shard='
                    f'"{shard_id}"}}') in text
            assert (f'mythril_tpu_torch_fleet_shard_net_tier_hits{{shard='
                    f'"{shard_id}"}} {10 + shard_id}') in text
        # merged counters: the three shard snapshots' net-tier hits sum
        assert "mythril_tpu_torch_net_tier_hits 33" in text
        assert SolverStatistics().fleet_shard_routes >= 3
    finally:
        assert fleet.drain(timeout=30.0)
    assert fleet.drained.is_set()
    assert all(stub.poll() is not None for stub in stubs.spawned)


def test_fleet_shard_fault_requeues_once_to_survivor(monkeypatch):
    """Registered site fleet.shard (retry): a shard that dies mid-proxy
    re-routes the request ONCE to a surviving shard — answered `ok`,
    `worker_requeue` recorded, fleet_requeues counted — and with every
    shard failing the fleet answers `incomplete`, never hangs."""
    from mythril_tpu_torch.fleet.router import request_digest
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "60")
    code = "0x6002"
    # make the digest's rendezvous winner the failing shard so the
    # first proxy attempt is guaranteed to hit it
    probe = FleetSupervisor(2, spawn=_StubFleet())
    winner = probe.router.route(request_digest(code))
    stubs = _StubFleet(fail_analyze={winner})
    fleet = FleetSupervisor(2, http_port=0, spawn=stubs).start()
    try:
        status, out = http_post(fleet.port, "/analyze",
                                  {"tenant": "alice", "code": code})
        assert status == 200 and out["status"] == "ok"
        assert out["shard"] != winner, \
            "the requeued request must land on the survivor"
        recorded = _events("fleet.shard")
        assert recorded["worker_requeue"] >= 1
        assert SolverStatistics().fleet_requeues >= 1

        # both shards failing: requeue-once then a typed `incomplete`
        stubs.current(1 - winner).fail_analyze = True
        status, out = http_post(fleet.port, "/analyze",
                                  {"tenant": "alice", "code": code})
        assert status == 504 and out["status"] == "incomplete"
        assert _events("fleet.shard")["degraded"] >= 1
    finally:
        fleet.drain(timeout=30.0)


def test_injected_shard_fault_walks_the_full_requeue_discipline(
        monkeypatch):
    """fleet.shard:raise through the fault harness (healthy stubs, the
    proxy crossing itself faults): the injected raise consumes the one
    requeue, the second attempt faults too, and the fleet answers a
    typed `incomplete` — then disarming restores normal service on the
    same fleet, proving the fault left no residue."""
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "60")
    fleet = FleetSupervisor(2, http_port=0, spawn=_StubFleet()).start()
    try:
        faults.configure("fleet.shard:raise:*")
        status, out = http_post(fleet.port, "/analyze",
                                  {"tenant": "alice", "code": "0x6005"})
        assert status == 504 and out["status"] == "incomplete"
        recorded = _events("fleet.shard")
        assert recorded["injected"] >= 2
        assert recorded["worker_requeue"] >= 1
        assert recorded["degraded"] >= 1
        assert SolverStatistics().fleet_requeues >= 1

        faults.configure(None)
        status, out = http_post(fleet.port, "/analyze",
                                  {"tenant": "alice", "code": "0x6005"})
        assert status == 200 and out["status"] == "ok"
    finally:
        fleet.drain(timeout=30.0)


def test_supervisor_crash_only_restarts_dead_shard(monkeypatch):
    """The health probe notices a dead worker process and crash-only
    restarts it: a NEW incarnation announces on a new port,
    fleet_shard_restarts counts it, and the fleet is whole again."""
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "0.2")
    stubs = _StubFleet()
    fleet = FleetSupervisor(2, http_port=0, spawn=stubs).start()
    try:
        victim = stubs.current(0)
        victim.kill()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            health = json.loads(_get_text(fleet.port, "/healthz"))
            if health["shards"]["0"]["restarts"] >= 1 \
                    and health["shards"]["0"]["alive"]:
                break
            time.sleep(0.1)
        else:
            pytest.fail("dead shard was never restarted")
        replacement = stubs.current(0)
        assert replacement is not victim
        assert SolverStatistics().fleet_shard_restarts >= 1
        assert _events("fleet.shard")["retry"] >= 1
        status, out = http_post(fleet.port, "/analyze",
                                  {"tenant": "alice", "code": "0x6003"})
        assert status == 200 and out["status"] == "ok"
    finally:
        fleet.drain(timeout=30.0)


def test_draining_fleet_rejects_new_requests(monkeypatch):
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "60")
    fleet = FleetSupervisor(2, http_port=0, spawn=_StubFleet()).start()
    port = fleet.port
    assert fleet.drain(timeout=30.0)
    status, out = fleet.handle_analyze({"code": "0x6004"})
    assert status == 503
    assert out == {"status": "rejected", "reason": "draining"}
    assert port is not None and fleet.drained.is_set()


# -- parity with the JAX package ---------------------------------------------------


def test_digests_and_routes_equal_the_jax_package():
    """Exact: the same codes give the same digests, and the same digests
    and live sets the same shards, in both packages."""
    from mythril_tpu.fleet import router as ref_router
    from mythril_tpu_torch.fleet import router

    codes = [f"0x60{i:04x}" for i in range(96)]
    live_sets = [None, [0, 1], [0, 2, 3], [1, 3], [2]]
    port_router = router.ShardRouter(range(4))
    ref = ref_router.ShardRouter(range(4))
    for code in codes:
        digest = router.request_digest(code)
        assert digest == ref_router.request_digest(code)
        for shard_id in range(4):
            assert router._score(digest, shard_id) == \
                ref_router._score(digest, shard_id)
        for live in live_sets:
            assert port_router.route(digest, live=live) == \
                ref.route(digest, live=live)


def test_network_tier_entries_equal_the_jax_package(tmp_path):
    """Exact: the same verdicts stored under the same fingerprints write
    byte-identical entries, and each package reads the other's."""
    from mythril_tpu.fleet.netstore import (
        NetworkResultStore as RefNetworkResultStore,
    )
    from mythril_tpu_torch.fleet.netstore import NetworkResultStore

    port_store = NetworkResultStore(root=str(tmp_path / "port"))
    ref_store = RefNetworkResultStore(root=str(tmp_path / "ref"))
    entries = [("1" * 64, "sat", 9, [i % 3 == 0 for i in range(10)]),
               ("2" * 64, "unsat", True, None),
               ("3" * 64, "unsat", False, None),
               ("4" * 64, "sat", 70, [i % 5 == 1 for i in range(71)])]
    for fingerprint, verdict, extra, bits in entries:
        for store in (port_store, ref_store):
            if verdict == "sat":
                assert store.store_sat(fingerprint, extra, bits)
            else:
                assert store.store_unsat(fingerprint, crosschecked=extra)
        with open(port_store._path(fingerprint), "rb") as fd:
            port_bytes = fd.read()
        with open(ref_store._path(fingerprint), "rb") as fd:
            ref_bytes = fd.read()
        assert port_bytes == ref_bytes, fingerprint
    cross = NetworkResultStore(root=str(tmp_path / "ref"))
    for fingerprint, verdict, extra, bits in entries:
        entry = cross.lookup(fingerprint)
        assert entry is not None and entry.verdict == verdict
        if verdict == "sat":
            assert list(entry.bits) == bits


ADMISSION_COUNTERS = ("router_host_direct", "cap_rejects",
                      "device_dispatches", "device_dispatched_queries",
                      "device_slots", "aig_device_components",
                      "router_dispatched_clauses", "xcontract_windows",
                      "xcontract_cones_packed")


@pytest.mark.parametrize("rate", [1e13, 3e7])
def test_two_tenant_window_streams_equal_the_jax_router(monkeypatch,
                                                        fleet_env, rate):
    """Exact: one window of two tenants' queries under tenant-qualified
    origins (as the daemon mints them) gives the same streams (cones,
    components and order) and the same admission and cross-origin
    counters in both routers, the JAX one under its Pallas rules."""
    import mythril_tpu.smt as ref_smt
    import mythril_tpu_torch.smt as port_smt
    from mythril_tpu.smt.solver import frontend as ref_frontend
    from mythril_tpu.smt.solver.statistics import (
        SolverStatistics as RefStatistics,
    )
    from mythril_tpu.support import model as ref_model
    from mythril_tpu.tpu import pallas_kernel
    from mythril_tpu.tpu import router as ref_router_mod
    from mythril_tpu_torch.gpu import backend as port_backend
    from mythril_tpu_torch.gpu import router as router_mod
    from mythril_tpu_torch.serve.daemon import ServeRequest
    from mythril_tpu_torch.smt.solver import frontend as port_frontend
    from tests.test_torch_router import _prepared, _unit_key

    monkeypatch.setenv("MYTHRIL_TPU_KERNEL", "pallas")
    monkeypatch.setenv("MYTHRIL_TPU_CALIBRATE", "0")
    pallas_kernel.reset_kernel_mode()
    for prefix in ("MYTHRIL_TPU_", "MYTHRIL_GPU_"):
        monkeypatch.setenv(prefix + "RAGGED_WINDOW_CAP", "100")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", str(1 << 18))
    monkeypatch.setattr(port_backend, "_backends", {})
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    alice = ServeRequest("alice:prod", "0x6001").origin
    bob = ServeRequest("bob", "0x6002").origin
    ref_model.clear_caches()
    ref_router_mod.reset_router()
    ref_stats = RefStatistics()
    ref_stats.reset()
    ref_stats.enabled = True
    try:
        ref_problems, _pairs = _prepared(ref_frontend, ref_smt, "sibling")
        problems, _pairs = _prepared(port_frontend, port_smt, "sibling")
        origins = [alice if i % 3 else bob for i in range(len(problems))]

        ref_router = ref_router_mod.get_router()
        ref_router._stage_rates["pallas_cells_s"] = rate
        ref_streams = []

        def ref_record(group, remaining, profile):
            ref_streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(ref_router, "_guarded_ragged_dispatch",
                            ref_record)
        ref_router.dispatch(ref_problems, 20.0, ref_stats, origins=origins)

        router = router_mod.get_router("cpu")
        router._rates["kernel_cells_s"] = rate
        streams = []

        def record(group, remaining, profile):
            streams.append([_unit_key(unit) for unit in group])
            return [None] * len(group)

        monkeypatch.setattr(router, "_ragged_dispatch", record)
        router.dispatch(problems, 20.0, fleet_env, origins=origins)

        assert streams == ref_streams
        assert streams
        port_counts = fleet_env.as_dict()
        ref_counts = ref_stats.as_dict()
        for key in ADMISSION_COUNTERS:
            assert port_counts.get(key, 0) == ref_counts.get(key, 0), key
    finally:
        ref_stats.reset()
        ref_model.clear_caches()
        ref_router_mod.reset_router()
        pallas_kernel.reset_kernel_mode()
