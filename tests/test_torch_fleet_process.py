"""The port's sharded fleet across processes (the counterparts of
tests/test_fleet.py's network-tier and subprocess cases), on
`--torch-device cpu`:

  * the network tier in process: one daemon stores into the shared
    directory, a second daemon with none of the first's memory serves
    from it (net_tier_hits) with the same findings;
  * a two-shard fleet of real worker processes: identical bytecode from
    two tenants sticks to one shard with the sequential run's findings,
    the survivor of a killed shard serves the digest from the tier the
    dead shard wrote, and /metrics lists both shards;
  * the supervisor builds the kernels once before it spawns a shard, and
    a shard's argv carries the solver backend and the torch device;
  * `serve --shards 2` without a card and without --torch-device exits 2
    before spawning anything."""

import json
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch.serve.daemon import ServeDaemon
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from tests.test_analysis import KILLBILLY, wrap_creation
from tests.torch_serve_helpers import (
    REQUEST_WAIT_S,
    device_args,
    fresh_stats,
    full_reset,
    http_get,
    http_post,
    issue_set,
    solo_issues,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_network_tier_entry_stored_by_one_shard_served_by_another(
        tmp_path, monkeypatch, fleet_env):
    from mythril_tpu_torch.service.store import get_result_store

    monkeypatch.setenv("MYTHRIL_GPU_NET_TIER_DIR", str(tmp_path / "net"))
    args.solve_cache = "disk"
    model_mod.clear_caches()  # re-resolve the store handle under the env
    assert get_result_store().is_network
    code = wrap_creation(KILLBILLY)

    first = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        cold = first.submit("alice", code).wait(REQUEST_WAIT_S)
        assert cold["status"] == "ok"
        assert fleet_env.net_tier_stores > 0
    finally:
        assert first.drain(timeout=120.0)

    model_mod.clear_caches()
    fleet_env.reset()
    fleet_env.enabled = True
    second = ServeDaemon(tx_count=1, deadline_s=120).start()
    try:
        warm = second.submit("bob", code).wait(REQUEST_WAIT_S)
        assert warm["status"] == "ok"
        assert issue_set(warm["issues"]) == issue_set(cold["issues"])
        assert fleet_env.net_tier_hits > 0
        assert warm["cdcl_settles"] < cold["cdcl_settles"]
    finally:
        assert second.drain(timeout=120.0)


def test_supervisor_builds_before_spawning_and_passes_the_device(
        monkeypatch, tmp_path):
    """On a card the supervisor builds every kernel before the first
    shard spawns (the shards load that build); a shard's argv names the
    solver backend and the torch device."""
    import torch

    from mythril_tpu_torch import core
    from mythril_tpu_torch.fleet import supervisor as supervisor_mod
    from mythril_tpu_torch.gpu import device as device_mod

    order = []
    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(core, "build_device_kernels",
                        lambda: order.append("build"))

    class _Dead:
        def poll(self):
            return 2

    def spawn(shard_id, announce):
        order.append(f"spawn {shard_id}")
        return _Dead()

    args.torch_device = "cuda:0"
    fleet = supervisor_mod.FleetSupervisor(2, spawn=spawn)
    monkeypatch.setattr(supervisor_mod, "start_timeout_s", lambda: 1.0)
    fleet.start()
    try:
        assert order[0] == "build" and order.count("build") == 1
        assert order[1:] == ["spawn 0", "spawn 1"]
    finally:
        fleet.drain(timeout=5.0)

    captured = {}

    def fake_popen(argv, **kwargs):
        captured["argv"] = argv
        return _Dead()

    monkeypatch.setattr(supervisor_mod.subprocess, "Popen", fake_popen)
    fleet._run_dir = str(tmp_path)
    fleet._spawn_worker(1, str(tmp_path / "announce.json"))
    argv = captured["argv"]
    assert argv[1:3] == ["-m", "mythril_tpu_torch.fleet.worker"]
    assert argv[argv.index("--solver-backend") + 1] == "gpu"
    assert argv[argv.index("--torch-device") + 1] == "cuda:0"


def test_fleet_subprocess_end_to_end_cross_process_tier(
        tmp_path, monkeypatch):
    from mythril_tpu_torch.fleet.supervisor import FleetSupervisor

    monkeypatch.setenv("MYTHRIL_GPU_NET_TIER_DIR", str(tmp_path / "net"))
    monkeypatch.setenv("MYTHRIL_GPU_FLEET_PROBE_INTERVAL", "120")
    monkeypatch.setenv("PYTHONPATH", REPO_ROOT)
    code = wrap_creation(KILLBILLY)
    args.solve_cache = "memory"  # the oracle must not seed the tier
    solo = issue_set(solo_issues(code))
    full_reset()
    device_args()

    fleet = FleetSupervisor(2, tx_count=1, http_port=0).start()
    try:
        status, cold = http_post(fleet.port, "/analyze",
                                 {"tenant": "alice", "code": code},
                                 timeout=REQUEST_WAIT_S)
        assert status == 200 and cold["status"] == "ok"
        assert issue_set(cold["issues"]) == solo
        hot = cold["shard"]

        status, warm = http_post(fleet.port, "/analyze",
                                 {"tenant": "bob", "code": code},
                                 timeout=REQUEST_WAIT_S)
        assert status == 200 and warm["status"] == "ok"
        assert warm["shard"] == hot, "identical digests must stick"
        assert issue_set(warm["issues"]) == solo

        _code, text = http_get(fleet.port, "/fleetz")
        heat = json.loads(text)["shards"]
        assert heat[str(hot)]["requests_completed"] == 2
        assert heat[str(hot)]["net_tier_stores"] > 0

        fleet._shards[hot].proc.kill()
        fleet._shards[hot].proc.wait(timeout=30.0)
        status, failover = http_post(fleet.port, "/analyze",
                                     {"tenant": "carol", "code": code},
                                     timeout=REQUEST_WAIT_S)
        assert status == 200 and failover["status"] == "ok"
        survivor = failover["shard"]
        assert survivor != hot
        assert issue_set(failover["issues"]) == solo
        _code, text = http_get(fleet.port, "/fleetz")
        heat = json.loads(text)["shards"]
        assert heat[str(survivor)]["net_tier_hits"] > 0

        _code, metrics_text = http_get(fleet.port, "/metrics")
        assert ('mythril_tpu_torch_fleet_shard_requests{shard="%d"}'
                % survivor) in metrics_text
    finally:
        fleet.drain(timeout=60.0)


def test_fleet_without_a_card_exits_two():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO_ROOT)
    result = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port", "0",
         "--shards", "2"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode == 2, result.stderr[-2000:]
    assert "no CUDA device" in result.stderr
    assert "listening" not in result.stdout
