"""The port's serve daemon (mythril_tpu_torch/serve/), its admission,
batching and isolation half (the counterparts of tests/test_serve.py's
admission, batching and audit cases), and the daemon held to the JAX
package's:

  * admission: a bounded queue and a per-tenant budget answer
    `overloaded`, a draining daemon `draining`, malformed bytecode is
    rejected at the door;
  * batching: fair tenant round-robin (FIFO under a blown admission fuse),
    one origin never twice in a batch;
  * isolation: tenant-qualified origins with disjoint tiers, colon-escaped
    tenant ids, a cancelled coordinator raising at its yield points;
  * parity (exact): encode_session and origin_in_session equal the JAX
    package's on hypothesis-drawn tenant ids holding ':' and '%'; one
    two-tenant batch through both packages' daemons on the host backend
    gives equal findings by request at issue granularity and equal
    serve_* counters.

Runs take `--torch-device cpu` or the host backend."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mythril_tpu_torch import resilience
from mythril_tpu_torch.serve.daemon import ServeDaemon, ServeRequest
from mythril_tpu_torch.service import tenancy
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, OVERFLOW_ADD, wrap_creation
from tests.torch_serve_helpers import (
    REQUEST_WAIT_S,
    drain,
    device_args,
    fresh_stats,
    full_reset,
    issue_set,
)


@pytest.fixture(autouse=True)
def serve_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("MYTHRIL_GPU_FLIGHTREC_DIR", str(tmp_path / "rec"))
    full_reset()
    device_args()
    stats = fresh_stats()
    yield stats
    full_reset()
    stats.reset()


# -- admission ----------------------------------------------------------------


def test_bounded_queue_rejects_overloaded(serve_env):
    """With the queue full the next submit answers `rejected: overloaded`
    at once (the worker is not started, so nothing drains)."""
    daemon = ServeDaemon(queue_max=2, tenant_budget=8)
    one = daemon.submit("a", wrap_creation(KILLBILLY))
    two = daemon.submit("b", wrap_creation(OVERFLOW_ADD))
    assert not one.done and not two.done
    three = daemon.submit("c", wrap_creation(KILLBILLY))
    assert three.done
    assert three.outcome == {"status": "rejected", "reason": "overloaded",
                             "request_id": three.request_id, "tenant": "c"}
    assert serve_env.serve_requests_admitted == 2
    assert serve_env.serve_requests_rejected == 1


def test_per_tenant_budget_caps_one_tenants_queue_share():
    daemon = ServeDaemon(queue_max=16, tenant_budget=2)
    salted = [wrap_creation(KILLBILLY + b"\x00" * i) for i in range(3)]
    assert not daemon.submit("flood", salted[0]).done
    assert not daemon.submit("flood", salted[1]).done
    assert daemon.submit("flood", salted[2]).outcome["reason"] == \
        "overloaded"
    assert not daemon.submit("small", wrap_creation(OVERFLOW_ADD)).done


def test_malformed_bytecode_rejected_at_admission():
    bad = ServeDaemon().submit("a", "zz-not-hex")
    assert bad.done and bad.outcome["status"] == "rejected"
    assert "bad request" in bad.outcome["reason"]


def test_draining_daemon_rejects_new_requests():
    daemon = ServeDaemon()
    daemon._draining = True
    late = daemon.submit("a", wrap_creation(KILLBILLY))
    assert late.outcome == {"status": "rejected", "reason": "draining",
                            "request_id": late.request_id, "tenant": "a"}


# -- batching -----------------------------------------------------------------


def test_fair_batching_round_robins_tenants():
    daemon = ServeDaemon(batch_max=2, tenant_budget=8)
    flood = [daemon.submit("flood", wrap_creation(KILLBILLY + b"\x00" * i))
             for i in range(3)]
    small = daemon.submit("small", wrap_creation(OVERFLOW_ADD))
    with daemon._cv:
        batch = daemon._next_batch()
    assert [r.tenant for r in batch] == ["flood", "small"]
    assert batch[0] is flood[0] and batch[1] is small


def test_blown_admission_fuse_degrades_to_fifo():
    daemon = ServeDaemon(batch_max=2, tenant_budget=8)
    first = daemon.submit("flood", wrap_creation(KILLBILLY))
    second = daemon.submit("flood", wrap_creation(KILLBILLY + b"\x00\x00"))
    daemon.submit("small", wrap_creation(OVERFLOW_ADD))
    resilience.note_stage_failure("serve.admission", hard=True)
    assert resilience.fuse_blown("serve.admission")
    with daemon._cv:
        batch = daemon._next_batch()
    assert batch == [first, second]


def test_same_origin_requests_never_share_a_batch():
    daemon = ServeDaemon(batch_max=4)
    one = daemon.submit("a", wrap_creation(KILLBILLY))
    two = daemon.submit("a", wrap_creation(KILLBILLY))
    assert one.origin == two.origin
    with daemon._cv:
        first_batch = daemon._next_batch()
        second_batch = daemon._next_batch()
    assert first_batch == [one]
    assert second_batch == [two]


# -- isolation ------------------------------------------------------------------


def test_origins_are_tenant_qualified_and_tiers_disjoint():
    code = wrap_creation(KILLBILLY)
    one = ServeRequest("alice", code).origin
    two = ServeRequest("bob", code).origin
    assert one != two
    assert one.split(":", 1)[0] == "alice"
    tier_a, quick_a = model_mod.caches_for_origin(one)
    tier_b, quick_b = model_mod.caches_for_origin(two)
    assert tier_a is not tier_b
    assert quick_a is not quick_b
    assert tenancy.origin_in_session(one, "alice")
    assert not tenancy.origin_in_session(one, "bob")


def test_tenant_ids_with_colons_cannot_cross_evict():
    code = wrap_creation(KILLBILLY)
    plain = ServeRequest("alice", code).origin
    scoped = ServeRequest("alice:prod", code).origin
    assert plain != scoped
    assert not tenancy.origin_in_session(scoped,
                                         tenancy.encode_session("alice"))
    assert tenancy.origin_in_session(
        scoped, tenancy.encode_session("alice:prod"))
    assert tenancy.encode_session("a:b") != tenancy.encode_session("a%3Ab")


def test_cancelled_coordinator_raises_at_yield_points():
    from mythril_tpu_torch.service import interleave

    coordinator = interleave.Coordinator(
        [(0, object())], origins=["t:x"], warm=False, module_templates=[])
    with pytest.raises(interleave.BatchCancelled):
        coordinator.maybe_switch()  # this thread holds no slot
    coordinator.cancel()
    with pytest.raises(interleave.BatchCancelled):
        coordinator._check_cancelled()


def test_an_abandoned_body_starts_no_slot(monkeypatch):
    """A batch body abandoned before it started its slots (the daemon set
    the cancel flag under the body's lock) installs no coordinator and
    runs no analysis: nothing of it can run beside the next batch."""
    import threading

    from mythril_tpu_torch.service import interleave

    ran = []
    monkeypatch.setattr(ServeDaemon, "_analyze_request",
                        lambda self, request: ran.append(request))
    daemon = ServeDaemon()
    request = daemon.submit("alice", wrap_creation(KILLBILLY))
    shared = {"lock": threading.Lock(), "cancelled": True,
              "coordinator": None, "entered": False,
              "exited": threading.Event(), "failure": None}
    daemon._run_batch_body([request], shared)
    assert ran == []
    assert shared["entered"] is False and shared["coordinator"] is None
    assert interleave.active() is None
    assert not any(thread.name.startswith("mythril-serve-slot")
                   for thread in threading.enumerate())


def test_evict_refuses_while_tenant_in_flight():
    daemon = ServeDaemon()  # worker not started: the request stays queued
    daemon.submit("busy", wrap_creation(KILLBILLY))
    assert daemon.evict_tenant("busy", wait_timeout=0.3) is False
    assert daemon.evict_tenant("idle", wait_timeout=0.3) is True


def test_uninstall_is_a_compare_and_swap():
    """An abandoned body's late uninstall(expected=its coordinator) leaves
    a successor's coordinator installed and the module tiers alone."""
    from mythril_tpu_torch.service import interleave

    old = interleave.Coordinator([(0, object())], origins=["a:1"],
                                 warm=True, module_templates=[])
    new = interleave.Coordinator([(0, object())], origins=["b:2"],
                                 warm=True, module_templates=[])
    interleave.install(new)
    tier, quick = model_mod.caches_for_origin("b:2")
    model_mod._result_cache, model_mod.model_cache = tier, quick
    try:
        interleave.uninstall(keep_tenancy=True, expected=old)
        assert interleave.active() is new
        assert model_mod._result_cache is tier
        assert model_mod.model_cache is quick
        interleave.uninstall(keep_tenancy=True, expected=new)
        assert interleave.active() is None
    finally:
        interleave.uninstall()


# -- parity with the JAX package ------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet=st.sampled_from("ab:%3A_"), max_size=12),
       st.text(alphabet=st.sampled_from("ab:%3A_"), max_size=12))
def test_session_helpers_equal_the_jax_package(tenant, other):
    """Exact: the encoding and the predicate equal the JAX package's, the
    encoding is colon-free and injective, and an origin belongs to its
    own tenant's session and to no other tenant's."""
    from mythril_tpu.service import tenancy as ref_tenancy

    encoded = tenancy.encode_session(tenant)
    assert encoded == ref_tenancy.encode_session(tenant)
    assert ":" not in encoded
    origin = f"{encoded}:0123456789ab"
    for session in (tenancy.encode_session(tenant),
                    tenancy.encode_session(other), origin, tenant, other):
        assert tenancy.origin_in_session(origin, session) == \
            ref_tenancy.origin_in_session(origin, session)
    assert tenancy.origin_in_session(origin, encoded)
    if other != tenant:
        assert tenancy.encode_session(other) != encoded
        assert not tenancy.origin_in_session(
            origin, tenancy.encode_session(other))


SERVE_COUNTERS = ("serve_requests_admitted", "serve_requests_rejected",
                  "serve_requests_requeued", "serve_requests_incomplete",
                  "serve_requests_completed", "serve_batches",
                  "serve_batch_requests", "serve_batch_tenants")


def _two_tenant_batch(daemon_cls, stats):
    """Both requests queued before the worker starts: one batch of two."""
    daemon = daemon_cls(tx_count=1, deadline_s=120)
    alice = daemon.submit("alice", wrap_creation(KILLBILLY))
    bob = daemon.submit("bob", wrap_creation(OVERFLOW_ADD))
    daemon.start()
    try:
        outcomes = {"alice": alice.wait(REQUEST_WAIT_S),
                    "bob": bob.wait(REQUEST_WAIT_S)}
    finally:
        assert daemon.drain(timeout=120.0)
    counters = stats.as_dict()
    return outcomes, {key: counters[key] for key in SERVE_COUNTERS}


def test_two_tenant_batch_equals_the_jax_daemon(serve_env):
    """Exact, on the host backend: findings by request at issue
    granularity and every serve_* counter equal the JAX package's daemon
    on the same two-tenant batch."""
    from mythril_tpu import preanalysis as ref_preanalysis
    from mythril_tpu.resilience import faults as ref_faults
    from mythril_tpu.serve.daemon import ServeDaemon as RefDaemon
    from mythril_tpu.smt.solver.statistics import (
        SolverStatistics as RefStatistics,
    )
    from mythril_tpu.support import model as ref_model
    from mythril_tpu.support.args import args as ref_args
    from mythril_tpu.tpu import router as ref_router

    args.solver_backend = "cpu"
    port_outcomes, port_counters = _two_tenant_batch(ServeDaemon, serve_env)

    ref_stats = RefStatistics()
    saved = dict(ref_args.__dict__)
    ref_model.clear_caches()
    ref_preanalysis.reset_caches()
    ref_router.reset_router()
    ref_faults.configure(None)
    ref_stats.reset()
    ref_stats.enabled = True
    ref_args.solver_backend = "cpu"
    try:
        ref_outcomes, ref_counters = _two_tenant_batch(RefDaemon, ref_stats)
    finally:
        ref_args.__dict__.update(saved)
        ref_model.clear_caches()
        ref_router.reset_router()
        ref_stats.reset()
        from mythril_tpu.support.time_handler import time_handler

        time_handler.start_execution(None)

    for tenant in ("alice", "bob"):
        assert port_outcomes[tenant]["status"] == "ok"
        assert ref_outcomes[tenant]["status"] == "ok"
        assert issue_set(port_outcomes[tenant]["issues"]) == \
            issue_set(ref_outcomes[tenant]["issues"]), tenant
    assert issue_set(port_outcomes["alice"]["issues"]), \
        "KILLBILLY's findings must not be empty"
    assert port_counters == ref_counters
    assert port_counters["serve_batches"] == 1
    assert port_counters["serve_batch_tenants"] == 2
