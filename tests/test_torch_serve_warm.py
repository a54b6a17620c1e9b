"""The port's serve daemon end to end on the device backend with
`--torch-device cpu` (K1's plain version): findings, warmth, isolation and
eviction (the counterparts of tests/test_serve.py's end-to-end, audit,
eviction and restart cases).

  * a two-tenant batch answers each request with the findings of the
    contract's sequential run (issue granularity), and a warm repeat
    records strictly fewer cdcl_settles, with memo hits;
  * without the disk tier no tenant sees another's memos;
  * eviction is session-scoped: one tenant's tiers, blasters and prefix
    snapshots go, the other tenant's and the shared strash session stay;
  * a restarted daemon re-warms from the disk tier;
  * a finished request leaves no execution budget behind (the daemon
    calls _analyze_one_contract, not fire_lasers)."""

import pytest

from mythril_tpu_torch.serve.daemon import ServeDaemon
from mythril_tpu_torch.service import tenancy
from mythril_tpu_torch.smt.solver import incremental
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, OVERFLOW_ADD, wrap_creation
from tests.torch_serve_helpers import (
    REQUEST_WAIT_S,
    device_args,
    drain,
    fresh_stats,
    full_reset,
    issue_set,
    solo_issues,
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


def test_multi_tenant_batch_matches_sequential_findings_and_warm_repeat(
        serve_env):
    killbilly = wrap_creation(KILLBILLY)
    overflow = wrap_creation(OVERFLOW_ADD)
    solo_k = issue_set(solo_issues(killbilly))
    solo_o = issue_set(solo_issues(overflow))
    full_reset()
    device_args()
    serve_env.reset()
    serve_env.enabled = True

    daemon = ServeDaemon(tx_count=1, deadline_s=120)
    alice = daemon.submit("alice", killbilly)
    bob = daemon.submit("bob", overflow)
    daemon.start()
    try:
        out_a = alice.wait(REQUEST_WAIT_S)
        out_b = bob.wait(REQUEST_WAIT_S)
        assert out_a["status"] == "ok" and out_b["status"] == "ok"
        assert issue_set(out_a["issues"]) == solo_k
        assert issue_set(out_b["issues"]) == solo_o
        assert solo_k, "KILLBILLY's findings must not be empty"

        single = daemon.submit("carol", killbilly).wait(REQUEST_WAIT_S)
        assert single["cdcl_settles"] > 0, "vacuous warmth proves nothing"
        warm = daemon.submit("carol", killbilly).wait(REQUEST_WAIT_S)
        assert warm["status"] == "ok"
        assert issue_set(warm["issues"]) == solo_k
        assert warm["cdcl_settles"] < single["cdcl_settles"], \
            "a warm repeat must record strictly fewer CDCL settles"
        assert warm["memo_hits"] > 0
    finally:
        drain(daemon)
    assert serve_env.serve_requests_completed == 4
    assert serve_env.serve_batches == 3
    assert serve_env.serve_batch_tenants == 4
    assert serve_env.as_dict()["serve_tenant_window_share"] == 1.0


def test_no_cross_tenant_memo_visibility_without_disk_tier():
    args.solve_cache = "memory"
    code = wrap_creation(KILLBILLY)
    daemon = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        cold_a = daemon.submit("alice", code).wait(REQUEST_WAIT_S)
        warm_a = daemon.submit("alice", code).wait(REQUEST_WAIT_S)
        first_b = daemon.submit("bob", code).wait(REQUEST_WAIT_S)
        assert cold_a["status"] == warm_a["status"] == "ok"
        assert first_b["status"] == "ok"
        assert warm_a["memo_hits"] > 0
        assert first_b["memo_hits"] == 0, \
            "tenant B's probes observed tenant A's memo entries"
        assert issue_set(first_b["issues"]) == issue_set(cold_a["issues"])
        _tier_a, quick_a = model_mod.caches_for_origin(cold_a["origin"])
        _tier_b, quick_b = model_mod.caches_for_origin(first_b["origin"])
        assert not {id(m) for m in quick_b.models} & \
            {id(m) for m in quick_a.models}
    finally:
        drain(daemon)


def test_evict_tenant_is_session_scoped():
    from mythril_tpu_torch.preanalysis import aig_opt

    code_a = wrap_creation(KILLBILLY)
    code_b = wrap_creation(OVERFLOW_ADD)
    daemon = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        out_a = daemon.submit("alice", code_a).wait(REQUEST_WAIT_S)
        out_b = daemon.submit("bob", code_b).wait(REQUEST_WAIT_S)
        assert out_a["status"] == "ok" and out_b["status"] == "ok"
        origin_a, origin_b = out_a["origin"], out_b["origin"]
        assert origin_a in model_mod._origin_caches
        assert origin_b in model_mod._origin_caches
        assert tenancy._blasters.get(origin_a, (None,))[0] is not None
        snapshots_before = incremental.snapshot_count()
        alice_snapshots = incremental.snapshot_count("alice")
        assert alice_snapshots > 0, "vacuous eviction proves nothing"
        strash_before = aig_opt._session

        assert daemon.evict_tenant("alice")

        assert origin_a not in model_mod._origin_caches
        assert origin_a not in tenancy._blasters
        assert incremental.snapshot_count("alice") == 0
        assert origin_b in model_mod._origin_caches
        assert tenancy._blasters.get(origin_b) is not None
        assert incremental.snapshot_count() == \
            snapshots_before - alice_snapshots
        assert aig_opt._session is strash_before, \
            "the shared strash session must not flush on one eviction"
        cold_again = daemon.submit("alice", code_a).wait(REQUEST_WAIT_S)
        assert cold_again["status"] == "ok"
        assert cold_again["memo_hits"] == 0
        assert issue_set(cold_again["issues"]) == issue_set(out_a["issues"])
    finally:
        drain(daemon)


def test_crash_only_restart_rewarms_from_persistent_tier(serve_env):
    args.solve_cache = "disk"
    code = wrap_creation(KILLBILLY)
    first = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        cold = first.submit("alice", code).wait(REQUEST_WAIT_S)
        assert cold["status"] == "ok"
        assert serve_env.persistent_stores > 0
    finally:
        drain(first)

    # the crash: every in-memory state dies; the disk tier survives
    full_reset()
    device_args(solve_cache="disk")
    serve_env.reset()
    serve_env.enabled = True
    second = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        rewarmed = second.submit("alice", code).wait(REQUEST_WAIT_S)
        assert rewarmed["status"] == "ok"
        assert issue_set(rewarmed["issues"]) == issue_set(cold["issues"])
        assert serve_env.persistent_hits > 0
        assert rewarmed["cdcl_settles"] < cold["cdcl_settles"]
    finally:
        drain(second)


def test_a_finished_request_leaves_no_execution_budget():
    """The daemon calls _analyze_one_contract directly, so fire_lasers'
    finally does not end the budget: the request and its batch end it,
    and a window solved after the request is not cut to the spent
    budget."""
    from mythril_tpu_torch.support.time_handler import time_handler

    args.execution_timeout = 5
    daemon = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        out = daemon.submit("alice", wrap_creation(OVERFLOW_ADD)).wait(
            REQUEST_WAIT_S)
        assert out["status"] == "ok"
    finally:
        drain(daemon)
    assert not time_handler._timeout
    assert time_handler.time_remaining() >= 1e8
