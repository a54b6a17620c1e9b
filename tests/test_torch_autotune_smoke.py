"""The port's autotune end to end, held to the JAX package's
tests/test_autotune_smoke.py under MYTHRIL_GPU_* names: run_search
with a deterministic injected runner, the real `python -m
mythril_tpu_torch autotune` CLI on a tiny probe (--torch-device cpu), its
refusal to fall back to the CPU without a card, and the cold-start apply
(knob sources `tuned`). Then the parity cases: run_search with the same
injected runner gives the JAX package's summary, and KILLBILLY on the host
backend under the same profile gives its report byte for byte; and every
process start the JAX package covers applies the profile: a --jobs worker,
`serve` and a fleet shard."""

import json
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch import tune
from mythril_tpu_torch.service import calibration
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import env as env_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.tune import search, space

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# two-branch ERC20-like dispatcher: enough constraints that the probe
# reaches the solver seam, small enough that one run takes seconds
TINY_RUNTIME_HEX = (
    "60003560e01c8063a9059cbb14601e5760043560243501600055005b"
    "60443560205500"
)


@pytest.fixture
def clean_tiers(tmp_path, monkeypatch):
    from mythril_tpu_torch.support.model import clear_caches

    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_GPU_AUTOTUNE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    for name in space.knob_names():
        monkeypatch.delenv(name, raising=False)
    env_mod.clear_overrides()
    tune.reset_applied()
    args.reset()
    yield tmp_path
    env_mod.clear_overrides()
    tune.reset_applied()
    tune._drop_resolved_consumers()
    args.reset()
    clear_caches()


@pytest.fixture
def stats():
    s = SolverStatistics()
    was_enabled = s.enabled
    s.reset()
    s.enabled = True
    yield s
    s.reset()
    s.enabled = was_enabled


def _fake_runner_factory(calls, prefix="MYTHRIL_GPU_",
                         fast_knob="CIRCUIT_STEPS", fast_value=32,
                         stages=("kernel",)):
    """A deterministic probe: one candidate measures faster than the
    baseline, one knob family breaks findings parity (as witness drift),
    every other is slower; the roofline ranks `stages` in order."""
    baseline_findings = ("issue-a", "issue-b")
    rows = {stage: {"sol_gap_s": 3.0 - 0.5 * rank, "attained": 1.0,
                    "attainable": 2.0, "units": "cells/s"}
            for rank, stage in enumerate(stages)}

    def runner(inputs, tx_count, extra_args, knobs, budget_s):
        calls.append(dict(knobs))
        stats_payload = {"platform": "cpu", "roofline": {"stages": rows}}
        if prefix + "COALESCE_MS" in knobs:
            return search.Measurement(True, 1.0, 0.5, ("issue-a",),
                                      ("canon-a", "canon-b"),
                                      stats_payload, "")
        wall = 10.0
        if knobs.get(prefix + fast_knob) == fast_value:
            wall = 6.0
        elif knobs:
            wall = 11.0
        return search.Measurement(True, wall, 5.0, baseline_findings,
                                  ("canon-a", "canon-b"), stats_payload, "")

    return runner


def test_two_candidate_search_persists_and_reloads(clean_tiers, stats):
    calls = []
    runner = _fake_runner_factory(calls)
    summary = search.run_search(
        ["probe.hex"], 1, candidates=2, budget_s=30.0, rounds=1,
        runner=runner, platform="cpu")
    # candidates=2 proposes ROUND_BUDGET=2.0 and 8.0 (kernel first);
    # neither beats the baseline: an honest no_improvement, counted
    assert summary["autotune"] == "no_improvement"
    assert summary["candidates_tried"] == 2
    assert stats.autotune_candidates_tried == 2
    assert stats.autotune_rejected_regression == 2
    assert calibration.load_tuned("cpu") == (None, None)

    # wide enough to reach the winner (CIRCUIT_STEPS=32): a profile is
    # written with its provenance
    stats.reset()
    stats.enabled = True
    summary = search.run_search(
        ["probe.hex"], 1, candidates=6, budget_s=30.0, rounds=2,
        runner=runner, platform="cpu")
    assert summary["autotune"] == "tuned"
    assert summary["winner"] == "MYTHRIL_GPU_CIRCUIT_STEPS=32"
    assert summary["persisted"] is True
    entry, reject = calibration.load_tuned("cpu")
    assert reject is None
    assert entry["knobs"] == {"MYTHRIL_GPU_CIRCUIT_STEPS": 32}
    assert entry["probe_digest"] == summary["probe_digest"]
    assert entry["delta_frac"] > 0
    assert entry["knob_deltas"]["MYTHRIL_GPU_CIRCUIT_STEPS"][
        "after"] == 32
    assert entry["search"]["candidates_tried"] == 6

    # and reloaded: a second call answers from the profile, no probe run
    calls.clear()
    again = search.run_search(
        ["probe.hex"], 1, candidates=6, budget_s=30.0, rounds=2,
        runner=runner, platform="cpu")
    assert again["autotune"] == "already_tuned"
    assert again["knobs"] == {"MYTHRIL_GPU_CIRCUIT_STEPS": 32}
    assert calls == []

    # --force searches again
    search.run_search(["probe.hex"], 1, candidates=2, budget_s=30.0,
                      rounds=1, force=True, runner=runner, platform="cpu")
    assert calls != []


def test_parity_breaking_candidate_rejected_and_counted(clean_tiers,
                                                        stats):
    calls = []
    runner = _fake_runner_factory(calls)
    # the whole space, so the COALESCE_MS parity breaker (ragged stage,
    # after the kernel knobs) enters the pool
    summary = search.run_search(
        ["probe.hex"], 1, candidates=99, budget_s=30.0, rounds=1,
        runner=runner, platform="cpu")
    assert summary["rejected_parity"] >= 1
    assert stats.autotune_rejected_parity == summary["rejected_parity"]
    rejected = [c for c in summary["candidates"] if not c["parity_ok"]]
    assert rejected and all(
        "MYTHRIL_GPU_COALESCE_MS" in c["label"] for c in rejected)
    # the witness-masked rows matched: benign witness drift, reported
    assert all(c.get("witness_drift") for c in rejected)
    assert summary["rejected_witness_drift"] == len(rejected)
    # the parity breaker's (fast) wall never ranked
    assert summary["autotune"] == "tuned"
    assert summary["winner"] == "MYTHRIL_GPU_CIRCUIT_STEPS=32"
    assert summary["candidates_tried"] == (
        summary["rejected_parity"] + summary["rejected_regression"] + 1)


def test_probe_digest_changes_invalidate_skip(clean_tiers, stats,
                                              tmp_path):
    calls = []
    runner = _fake_runner_factory(calls)
    probe = tmp_path / "p.hex"
    probe.write_text("60016002")
    search.run_search([str(probe)], 1, candidates=6, budget_s=30.0,
                      rounds=1, runner=runner, platform="cpu")
    assert calibration.load_tuned("cpu")[0] is not None
    calls.clear()
    probe.write_text("60016003")  # the probe corpus changed
    summary = search.run_search([str(probe)], 1, candidates=6,
                                budget_s=30.0, rounds=1, runner=runner,
                                platform="cpu")
    # a changed digest searches again instead of trusting the old claim
    assert summary["autotune"] in ("tuned", "no_improvement")
    assert calls != []


def _cli_env(cache_dir, **extra):
    env = {**os.environ, "MYTHRIL_GPU_CACHE_DIR": str(cache_dir),
           "MYTHRIL_GPU_AUTOTUNE": "1", "MYTHRIL_GPU_CALIBRATE": "0",
           **extra}
    for name in space.knob_names():
        env.pop(name, None)
    return env


def test_autotune_cli_end_to_end(tmp_path):
    """The real CLI: a one-candidate search on a tiny probe on the plain
    versions (--torch-device cpu, forwarded to every child). Whether a
    winner persists depends on measured walls, so both outcomes are legal
    here; the persistence is pinned above."""
    probe = tmp_path / "tiny.hex"
    probe.write_text(TINY_RUNTIME_HEX)
    stats_path = tmp_path / "autotune_stats.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "autotune",
         "-f", str(probe), "--bin-runtime", "-t", "1",
         "--candidates", "1", "--rounds", "1", "--budget", "120",
         "--torch-device", "cpu"],
        capture_output=True, text=True, timeout=360,
        env=_cli_env(tmp_path, MYTHRIL_GPU_STATS_JSON=str(stats_path)),
        cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["autotune"] in ("tuned", "no_improvement")
    assert summary["platform"] == "cpu"
    assert summary["candidates_tried"] == 1
    assert summary["rejected_parity"] == 0
    assert not any(c.get("fail") for c in summary["candidates"])
    with open(stats_path) as fd:
        counters = json.load(fd)
    assert counters["autotune_candidates_tried"] == 1
    assert counters["autotune_rejected_regression"] + (
        1 if summary["autotune"] == "tuned" else 0) == 1
    entry, _reject = _load_tuned_from(str(tmp_path), "cpu")
    if summary["autotune"] == "tuned":
        assert entry["knobs"] == summary["knobs"]
        # a second call answers from the profile
        again = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "autotune",
             "-f", str(probe), "--bin-runtime", "-t", "1",
             "--candidates", "1", "--rounds", "1",
             "--torch-device", "cpu"],
            capture_output=True, text=True, timeout=120,
            env=_cli_env(tmp_path), cwd=REPO_ROOT)
        assert again.returncode == 0, again.stderr[-2000:]
        assert json.loads(again.stdout.strip().splitlines()[-1])[
            "autotune"] == "already_tuned"
    else:
        assert entry is None


def test_autotune_without_a_card_exits_two(tmp_path):
    """No card and no device named: the baseline child exits 2
    (NoDeviceError), the search answers baseline_failed and exits 2, and
    nothing runs on the CPU in its place."""
    probe = tmp_path / "tiny.hex"
    probe.write_text(TINY_RUNTIME_HEX)
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "autotune",
         "-f", str(probe), "--bin-runtime", "-t", "1",
         "--candidates", "1", "--rounds", "1"],
        capture_output=True, text=True, timeout=240,
        env=_cli_env(tmp_path), cwd=REPO_ROOT)
    assert proc.returncode == 2, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary == {"autotune": "baseline_failed", "fail": "rc=2"}
    assert not os.path.exists(tmp_path / "calibration.json")


def _load_tuned_from(cache_dir, platform):
    path = os.path.join(cache_dir, "calibration.json")
    if not os.path.exists(path):
        return None, "absent"
    with open(path) as fd:
        payload = json.load(fd)
    entry = payload.get("tuned", {}).get(platform)
    if entry is None:
        return None, "absent"
    return entry, None


def test_cold_analyze_reports_tuned_sources(tmp_path, monkeypatch):
    """A persisted profile and a cold analyze child: the stats JSON
    reports the knob sources as `tuned` and counts tuned_knobs_applied,
    with no search in sight."""
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(cache_dir))
    assert calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0,
                  "MYTHRIL_GPU_COALESCE_MAX": 32},
        "probe_digest": "smoke"})
    probe = tmp_path / "tiny.hex"
    probe.write_text(TINY_RUNTIME_HEX)
    stats_path = tmp_path / "stats.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze",
         "-f", str(probe), "--bin-runtime", "-t", "1", "-o", "json",
         "--solver-timeout", "5000", "--torch-device", "cpu"],
        capture_output=True, text=True, timeout=240,
        env=_cli_env(cache_dir, MYTHRIL_GPU_STATS_JSON=str(stats_path)),
        cwd=REPO_ROOT)
    assert proc.returncode in (0, 1), proc.stderr[-2000:]
    with open(stats_path) as fd:
        stats_payload = json.load(fd)
    assert stats_payload["platform"] == "cpu"
    assert stats_payload["tuned_knobs_applied"] == 2
    assert stats_payload["tuned_profile_rejects"] == 0
    knobs = stats_payload["knobs"]
    assert knobs["MYTHRIL_GPU_ROUND_BUDGET"] == {
        "value": 2.0, "source": "tuned"}
    assert knobs["MYTHRIL_GPU_COALESCE_MAX"] == {
        "value": 32, "source": "tuned"}
    # untuned knobs still report their built-in default
    assert knobs["MYTHRIL_GPU_SERVE_BATCH"]["source"] == "default"


def test_subprocess_runner_forwards_the_device_and_pins_the_candidate(
        monkeypatch, tmp_path):
    """A child is `analyze ... -f P -t N -o json` with the search's solver
    backend and, only when it named one, its torch device; the candidate's
    knobs ride as env vars with MYTHRIL_GPU_AUTOTUNE=0 under them."""
    seen = {}

    def fake_run(argv, capture_output, text, timeout, env):
        seen["argv"], seen["env"] = argv, env
        with open(env["MYTHRIL_GPU_STATS_JSON"], "w") as fd:
            json.dump({"platform": "cpu", "solver_time": 1.5}, fd)
        return subprocess.CompletedProcess(
            argv, 1, stdout=json.dumps({"issues": [{"swc-id": "106"}]}),
            stderr="")

    monkeypatch.setattr(search.subprocess, "run", fake_run)
    extra = ["--solver-backend", "gpu", "--torch-device", "cpu"]
    got = search.subprocess_runner(["p.hex"], 2, extra,
                                   {"MYTHRIL_GPU_KERNEL": "xla"}, 30.0)
    assert got.ok and got.solver_wall_s == 1.5
    assert got.findings == (json.dumps({"swc-id": "106"}),)
    argv = seen["argv"]
    assert argv[1:4] == ["-m", "mythril_tpu_torch", "analyze"]
    assert argv[-4:] == extra
    assert seen["env"]["MYTHRIL_GPU_AUTOTUNE"] == "0"
    assert seen["env"]["MYTHRIL_GPU_KERNEL"] == "xla"


def test_the_parent_builds_the_childrens_kernels(monkeypatch):
    """On a card the search builds K1, K2 and K6 before the baseline, so
    no child pays nvcc; on the host backend, a named CPU device, or with
    no card and no device named (the baseline child reports that), it
    builds nothing."""
    import torch

    from mythril_tpu_torch.gpu import (
        circuit_kernel,
        device,
        frontier_kernel,
        ragged_kernel,
        xla_kernel,
    )

    built = []
    for name, module in (("K1", ragged_kernel), ("K2", xla_kernel),
                         ("K3", circuit_kernel), ("K6", frontier_kernel)):
        monkeypatch.setattr(module, "build_kernel",
                            lambda name=name: built.append(name))
    search.build_probe_kernels("cpu", None)
    search.build_probe_kernels("gpu", "cpu")
    search.build_probe_kernels("gpu", None)  # no card here: nothing
    assert built == []
    monkeypatch.setattr(device, "resolve_device",
                        lambda name=None: torch.device("cuda"))
    search.build_probe_kernels("gpu", None)
    assert sorted(built) == ["K1", "K2", "K6"]


# -- parity with the JAX package ----------------------------------------------


@pytest.mark.parametrize("stages", [("kernel",), ("ragged", "kernel"),
                                    ("settle", "frontier.fork"),
                                    ("pack", "ship")])
@pytest.mark.parametrize("candidates", [3, 99])
def test_run_search_equals_the_reference(clean_tiers, stats, monkeypatch,
                                         tmp_path, stages, candidates):
    """The same deterministic runner (knob names mapped) and the same gap
    stages: the same outcome, winner, counters, candidate order and
    rejects in both packages."""
    from mythril_tpu.smt.solver.statistics import (
        SolverStatistics as RefStatistics,
    )
    from mythril_tpu.tune import search as ref_search

    monkeypatch.setenv("MYTHRIL_TPU_CACHE_DIR", str(tmp_path / "ref"))
    for name in space.knob_names():
        monkeypatch.delenv(name.replace("GPU", "TPU", 1), raising=False)
    summaries = []
    for module, prefix in ((ref_search, "MYTHRIL_TPU_"),
                           (search, "MYTHRIL_GPU_")):
        summaries.append(module.run_search(
            ["probe.hex"], 1, candidates=candidates, budget_s=30.0,
            rounds=2, runner=_fake_runner_factory([], prefix=prefix,
                                                  stages=stages),
            platform="cpu"))
    RefStatistics().reset()

    def mapped(summary):
        text = json.dumps(summary, sort_keys=True)
        return json.loads(text.replace("MYTHRIL_TPU_", "MYTHRIL_GPU_"))

    ref, port = mapped(summaries[0]), mapped(summaries[1])
    assert port["gap_stages"] == list(stages)
    for key in ("autotune", "winner", "candidates_tried", "rejected_parity",
                "rejected_witness_drift", "rejected_regression",
                "gap_stages", "candidates", "knobs", "delta_frac",
                "baseline_wall_s", "probe_digest"):
        assert port.get(key) == ref.get(key), key


@pytest.mark.parametrize("candidate_wall,port_outcome", [
    (11.0, "no_improvement"), (7.0, "tuned")])
def test_the_bar_takes_the_baseline_spread(clean_tiers, stats, monkeypatch,
                                           tmp_path, candidate_wall,
                                           port_outcome):
    """A deliberate difference (ROADMAP §3): the baseline measured at 10 s
    and 14 s (mean 12, spread 4), the one candidate at 11 s gains 8%, past
    the 2% bar, but less than the spread: the JAX package persists it, the
    port declines. A candidate past the spread (7 s) wins in both."""
    from mythril_tpu.smt.solver.statistics import (
        SolverStatistics as RefStatistics,
    )
    from mythril_tpu.tune import search as ref_search

    monkeypatch.setenv("MYTHRIL_TPU_CACHE_DIR", str(tmp_path / "ref"))
    for name in space.knob_names():
        monkeypatch.delenv(name.replace("GPU", "TPU", 1), raising=False)

    def noisy_runner():
        baseline_walls = iter((10.0, 14.0))

        def runner(inputs, tx_count, extra_args, knobs, budget_s):
            stats_payload = {"platform": "cpu", "roofline": {"stages": {
                "kernel": {"sol_gap_s": 3.0, "attained": 1.0,
                           "attainable": 2.0, "units": "cells/s"}}}}
            wall = next(baseline_walls) if not knobs else candidate_wall
            return search.Measurement(True, wall, 5.0, ("issue-a",),
                                      ("canon-a",), stats_payload, "")
        return runner

    outcomes = []
    for module in (ref_search, search):
        summary = module.run_search(
            ["probe.hex"], 1, candidates=1, budget_s=30.0, rounds=2,
            runner=noisy_runner(), platform="cpu")
        outcomes.append(summary["autotune"])
        assert summary["baseline_wall_s"] == 12.0
        assert summary["candidates_tried"] == summary[
            "rejected_regression"] + (1 if summary["autotune"] == "tuned"
                                      else 0)
    RefStatistics().reset()
    assert summary["baseline_spread_s"] == 4.0
    assert outcomes == ["tuned", port_outcome]
    assert (calibration.load_tuned("cpu")[0] is not None) == (
        port_outcome == "tuned")


def test_host_reports_under_a_profile_equal_the_reference(monkeypatch,
                                                          tmp_path):
    """KILLBILLY at -t 2 on the host backend in both packages, each under
    the same tuned profile (names mapped) applied by fire_lasers from its
    own cache dir: byte-identical reports, the same stamped values, every
    profile knob with source `tuned`."""
    from mythril_tpu import tune as ref_tune
    from mythril_tpu.service import calibration as ref_calibration
    from mythril_tpu.smt.solver.statistics import (
        SolverStatistics as RefStatistics,
    )
    from mythril_tpu.support import env as ref_env
    from tests.test_analysis import KILLBILLY, wrap_creation
    from tests.torch_helpers import run_analyze

    profile = {"PREFIX_MEMO_MAX": 16, "SNAPSHOT_NODE_CAP": 100_000,
               "FRONTIER_MULTIPC": 4, "COALESCE_MAX": 32,
               "ROUND_BUDGET": 2.0}
    reports, stamps = [], []
    try:
        for package, tune_mod, calibration_mod, stats_cls, env_module in (
                ("mythril_tpu", ref_tune, ref_calibration, RefStatistics,
                 ref_env),
                ("mythril_tpu_torch", tune, calibration, SolverStatistics,
                 env_mod)):
            prefix = ("MYTHRIL_TPU_" if package == "mythril_tpu"
                      else "MYTHRIL_GPU_")
            monkeypatch.setenv(prefix + "CACHE_DIR",
                               str(tmp_path / package))
            monkeypatch.setenv(prefix + "AUTOTUNE", "1")
            monkeypatch.setenv(prefix + "CALIBRATE", "0")
            for name in space.knob_names():
                monkeypatch.delenv(name.replace("MYTHRIL_GPU_", prefix, 1),
                                   raising=False)
            env_module.clear_overrides()
            tune_mod.reset_applied()
            assert calibration_mod.save_tuned("cpu", {"knobs": {
                prefix + stem: value for stem, value in profile.items()}})
            stats = stats_cls()
            stats.reset()
            report = run_analyze(package, wrap_creation(KILLBILLY), 2,
                                 "cpu", 60)
            reports.append(report.as_json())
            payload = stats.as_dict()
            stamps.append((payload["tuned_knobs_applied"], {
                name.split("_", 2)[2]: value
                for name, value in payload["knobs"].items()}))
            stats.reset()
    finally:
        for tune_mod, env_module in ((ref_tune, ref_env), (tune, env_mod)):
            env_module.clear_overrides()
            tune_mod.reset_applied()
        tune._drop_resolved_consumers()
    assert json.loads(reports[1])["issues"], "KILLBILLY's findings are there"
    assert reports[1] == reports[0]
    assert stamps[1] == stamps[0]
    applied, knobs = stamps[1]
    assert applied == len(profile)
    for stem, value in profile.items():
        assert knobs[stem] == {"value": value, "source": "tuned"}, stem


# -- every process start applies the profile ----------------------------------


def test_a_jobs_worker_applies_the_profile(clean_tiers):
    """A --jobs worker is a new interpreter: it applies the profile itself
    (before its kernels are loaded), and its stats carry the stamp and the
    count back to the parent."""
    from mythril_tpu_torch import core
    from mythril_tpu_torch.core import MythrilDisassembler
    from tests.test_analysis import KILLBILLY, wrap_creation

    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_FRONTIER_MULTIPC": 4,
                  "MYTHRIL_GPU_PREFIX_MEMO_MAX": 16}})
    disassembler = MythrilDisassembler()
    contract = disassembler.load_from_bytecode(wrap_creation(KILLBILLY))
    state = {**args.__dict__, "solver_backend": "cpu",
             "execution_timeout": 60, "transaction_count": 1}
    try:
        _idx, issues, exceptions, snapshot, _events, record = \
            core._corpus_worker((0, contract, core.ANALYSIS_ADDRESS, "bfs",
                                 None, 1, state))
    finally:
        from mythril_tpu_torch.support.time_handler import time_handler

        time_handler.start_execution(None)
    assert not exceptions and issues
    assert snapshot["tuned_knobs_applied"] == 2
    assert snapshot["knobs"]["MYTHRIL_GPU_FRONTIER_MULTIPC"] == {
        "value": 4, "source": "tuned"}
    assert record["metrics"]["knobs"]["MYTHRIL_GPU_PREFIX_MEMO_MAX"][
        "source"] == "tuned"


def test_serve_applies_the_profile_before_the_daemon(clean_tiers,
                                                     monkeypatch):
    """`serve` installs the profile before the daemon is built, so a tuned
    MYTHRIL_GPU_SERVE_BATCH reaches it, and the daemon's start counts the
    knobs once its statistics are on."""
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.serve import daemon as daemon_mod

    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_SERVE_BATCH": 8}})
    seen = {}

    def fake_serve_forever(daemon):
        seen["batch_max"] = daemon.batch_max
        return 0

    monkeypatch.setattr(daemon_mod, "serve_forever", fake_serve_forever)
    parsed = cli.build_parser().parse_args(
        ["serve", "--port", "0", "-t", "1", "--torch-device", "cpu"])
    stats = SolverStatistics()
    was_enabled = stats.enabled
    stats.reset()
    stats.enabled = False
    try:
        assert cli.serve_command(parsed) == 0
        assert seen["batch_max"] == 8
        assert stats.tuned_knobs_applied == 0  # statistics still off
        stats.enabled = True
        assert tune.apply_tuned_profile() == 0  # as the daemon's start
        assert stats.tuned_knobs_applied == 1
    finally:
        stats.reset()
        stats.enabled = was_enabled


def test_a_fleet_shard_applies_the_profile(clean_tiers, monkeypatch,
                                           tmp_path):
    """A fleet shard (fleet/worker.py) applies the profile, keyed by the
    device its argv names, before its daemon is built."""
    from mythril_tpu_torch.fleet import worker
    from mythril_tpu_torch.gpu.device import NoDeviceError
    from mythril_tpu_torch.serve import daemon as daemon_mod

    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_SERVE_BATCH": 2}})
    seen = {}

    class Recorded(daemon_mod.ServeDaemon):
        def start(self):
            seen["batch_max"] = self.batch_max
            raise NoDeviceError("stood in: stop before serving")

    monkeypatch.setattr(daemon_mod, "ServeDaemon", Recorded)
    rc = worker.main(["--shard-id", "0", "--announce",
                      str(tmp_path / "announce.json"),
                      "--torch-device", "cpu"])
    assert rc == 2
    assert seen["batch_max"] == 2
    assert space.resolved_config()["MYTHRIL_GPU_SERVE_BATCH"] == {
        "value": 2, "source": "tuned"}
