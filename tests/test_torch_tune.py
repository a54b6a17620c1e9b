"""The port's autotune subsystem (mythril_tpu_torch/tune/) held to the JAX
package's tests/test_tune.py under MYTHRIL_GPU_* names: resolution
precedence, the knob space, the tuned profile's persistence, apply and
rejects, the knob stamp, and the chunk-cone auto value (a constant in the
port: K2 compiles nothing per shape). Then the parity cases: the knob
table and tiered resolution equal to the JAX package's, every registered
knob reaching its consumer, and the apply ordered before the kernel
build."""

import json
import os

import pytest

from mythril_tpu.support import env as ref_env
from mythril_tpu.tune import space as ref_space
from mythril_tpu_torch import tune
from mythril_tpu_torch.service import calibration
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import env as env_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.tune import space


def _port_name(name: str) -> str:
    return name.replace("MYTHRIL_TPU_", "MYTHRIL_GPU_", 1)


@pytest.fixture(autouse=True)
def no_knob_env(monkeypatch):
    """No registered knob set in the environment, and the tiers empty."""
    for name in space.knob_names():
        monkeypatch.delenv(name, raising=False)
        monkeypatch.delenv(name.replace("GPU", "TPU", 1), raising=False)
    env_mod.clear_overrides()
    ref_env.clear_overrides()
    yield
    env_mod.clear_overrides()
    ref_env.clear_overrides()


@pytest.fixture
def stats():
    s = SolverStatistics()
    was_enabled = s.enabled
    s.reset()
    s.enabled = True
    yield s
    s.reset()
    s.enabled = was_enabled


@pytest.fixture
def clean_tiers(tmp_path, monkeypatch):
    """An isolated cache dir, empty tiers, a re-appliable profile, and the
    per-process consumers dropped before and after."""
    from mythril_tpu_torch.support.model import clear_caches

    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_GPU_AUTOTUNE", "1")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    args.reset()
    tune.reset_applied()
    clear_caches()
    yield tmp_path
    env_mod.clear_overrides()
    tune.reset_applied()
    tune._drop_resolved_consumers()
    args.reset()
    clear_caches()


# -- resolution precedence ----------------------------------------------------


def test_env_beats_cli_beats_tuned_beats_default(monkeypatch):
    name = "MYTHRIL_GPU_ROUND_BUDGET"
    assert env_mod.env_float(name, 4.0) == 4.0
    assert env_mod.resolve_source(name, 4.0) == (4.0, "default")
    env_mod.set_tuned({name: 2.0})
    assert env_mod.env_float(name, 4.0) == 2.0
    assert env_mod.resolve_source(name, 4.0) == (2.0, "tuned")
    env_mod.set_cli(name, 3.0)
    assert env_mod.env_float(name, 4.0) == 3.0
    assert env_mod.resolve_source(name, 4.0) == (3.0, "cli")
    monkeypatch.setenv(name, "9.5")
    assert env_mod.env_float(name, 4.0) == 9.5
    assert env_mod.resolve_source(name, 4.0) == (9.5, "env")


def test_malformed_values_degrade_safely(monkeypatch):
    name = "MYTHRIL_GPU_COALESCE_MAX"
    # a present but malformed env var pins the built-in default: an
    # explicit env var is absolute, never replaced by a tuned value
    monkeypatch.setenv(name, "not-a-number")
    env_mod.set_tuned({name: 32})
    assert env_mod.env_int(name, 16) == 16
    monkeypatch.setenv(name, "")
    assert env_mod.env_int(name, 16) == 16
    # a malformed tuned entry falls through to the default
    monkeypatch.delenv(name)
    env_mod.set_tuned({name: "also-bad"})
    assert env_mod.env_int(name, 16) == 16
    env_mod.set_tuned({name: 32})
    assert env_mod.env_int(name, 16) == 32


def test_env_int_accepts_json_roundtripped_floats():
    env_mod.set_tuned({"MYTHRIL_GPU_SERVE_BATCH": 8.0})
    value = env_mod.env_int("MYTHRIL_GPU_SERVE_BATCH", 4)
    assert value == 8 and isinstance(value, int)


# -- knob space ---------------------------------------------------------------


def test_every_knob_is_well_formed():
    from mythril_tpu_torch.observe import roofline

    assert len(space.KNOBS) == 18
    for knob in space.KNOBS:
        assert knob.env.startswith("MYTHRIL_GPU_")
        assert knob.kind in ("int", "float", "str")
        assert knob.candidates, knob.env
        assert knob.stage in roofline.STAGES + ("serve",), knob.env
        if knob.kind == "str":
            assert all(isinstance(c, str) for c in knob.candidates), \
                knob.env
    assert len(set(space.knob_names())) == len(space.KNOBS)


def test_gap_ordered_puts_ranked_stages_first():
    ordered = space.gap_ordered(["ragged", "kernel"])
    stages = [knob.stage for knob in ordered]
    first_ragged = stages.index("ragged")
    first_kernel = stages.index("kernel")
    first_other = min(i for i, s in enumerate(stages)
                      if s not in ("ragged", "kernel"))
    assert first_ragged < first_kernel < first_other


def test_resolved_config_reports_sources(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_COALESCE_MS", "3")
    env_mod.set_tuned({"MYTHRIL_GPU_ROUND_BUDGET": 2.0})
    cfg = space.resolved_config()
    assert set(cfg) == set(space.knob_names())
    assert cfg["MYTHRIL_GPU_COALESCE_MS"] == {"value": 3.0, "source": "env"}
    assert cfg["MYTHRIL_GPU_ROUND_BUDGET"] == {"value": 2.0,
                                               "source": "tuned"}
    assert cfg["MYTHRIL_GPU_SERVE_BATCH"]["source"] == "default"


def test_validate_knobs_rejects_garbage():
    assert space.validate_knobs({"MYTHRIL_GPU_ROUND_BUDGET": 2.0})
    assert space.validate_knobs({"MYTHRIL_GPU_KERNEL": "xla"})
    assert not space.validate_knobs({"MYTHRIL_GPU_KERNEL": "auto"})
    assert not space.validate_knobs({})
    assert not space.validate_knobs({"NOT_A_KNOB": 1})
    assert not space.validate_knobs({"MYTHRIL_TPU_ROUND_BUDGET": 2.0})
    assert not space.validate_knobs({"MYTHRIL_GPU_ROUND_BUDGET": "2"})
    assert not space.validate_knobs({"MYTHRIL_GPU_ROUND_BUDGET": True})
    assert not space.validate_knobs("nope")


# -- persistence and apply ----------------------------------------------------


def test_tuned_profile_roundtrip_with_provenance(clean_tiers):
    entry = {"knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0},
             "probe_digest": "abcd", "git_rev": "deadbeef",
             "delta_frac": 0.25}
    assert calibration.save_tuned("cpu", entry)
    loaded, reject = calibration.load_tuned("cpu")
    assert reject is None
    assert loaded["knobs"] == {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}
    assert loaded["probe_digest"] == "abcd"
    assert loaded["schema"] == calibration.TUNED_SCHEMA_VERSION
    assert loaded["tuned_at"] > 0
    # other platforms stay untuned
    assert calibration.load_tuned("NVIDIA H100 80GB HBM3") == (None, None)
    assert calibration.load_tuned(None) == (None, None)


def test_apply_installs_tuned_tier_and_counts(clean_tiers, stats):
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0,
                  "MYTHRIL_GPU_SERVE_BATCH": 8}})
    applied = tune.apply_tuned_profile(platform="cpu")
    assert applied == 2
    assert stats.tuned_knobs_applied == 2
    assert env_mod.env_float("MYTHRIL_GPU_ROUND_BUDGET", 4.0) == 2.0
    cfg = space.resolved_config()
    assert cfg["MYTHRIL_GPU_ROUND_BUDGET"]["source"] == "tuned"
    assert cfg["MYTHRIL_GPU_SERVE_BATCH"] == {"value": 8, "source": "tuned"}
    # once a process: a second apply is a no-op
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert stats.tuned_knobs_applied == 2


def test_explicit_env_shadows_tuned_knob(clean_tiers, stats, monkeypatch):
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0,
                  "MYTHRIL_GPU_SERVE_BATCH": 8}})
    monkeypatch.setenv("MYTHRIL_GPU_ROUND_BUDGET", "7.5")
    applied = tune.apply_tuned_profile(platform="cpu")
    # only the unshadowed knob counts as live
    assert applied == 1
    assert env_mod.env_float("MYTHRIL_GPU_ROUND_BUDGET", 4.0) == 7.5
    assert space.resolved_config()["MYTHRIL_GPU_ROUND_BUDGET"][
        "source"] == "env"


def test_autotune_env_zero_disables_application(clean_tiers, stats,
                                                monkeypatch):
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    monkeypatch.setenv("MYTHRIL_GPU_AUTOTUNE", "0")
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert env_mod.env_float("MYTHRIL_GPU_ROUND_BUDGET", 4.0) == 4.0


def test_corrupt_profile_ignored_with_counted_event(clean_tiers, stats):
    path = os.path.join(str(clean_tiers), "calibration.json")
    with open(path, "w") as fd:
        fd.write("{ torn json")
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert stats.tuned_profile_rejects == 1
    assert env_mod.tuned_values() == {}


def test_stale_schema_profile_ignored_with_counted_event(clean_tiers,
                                                         stats):
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    path = os.path.join(str(clean_tiers), "calibration.json")
    with open(path) as fd:
        payload = json.load(fd)
    payload["tuned"]["cpu"]["schema"] = calibration.TUNED_SCHEMA_VERSION + 1
    with open(path, "w") as fd:
        json.dump(payload, fd)
    assert calibration.load_tuned("cpu") == (None, "stale-schema")
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert stats.tuned_profile_rejects == 1


def test_unregistered_knob_profile_rejected(clean_tiers, stats):
    calibration.save_tuned("cpu", {"knobs": {"MYTHRIL_GPU_NOT_REAL": 3}})
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert stats.tuned_profile_rejects == 1
    assert env_mod.tuned_values() == {}


def test_the_other_packages_knob_names_are_rejected(clean_tiers, stats):
    """A profile that names the JAX package's MYTHRIL_TPU_* knobs is
    unregistered here: one package's profile never steers the other."""
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_TPU_ROUND_BUDGET": 2.0}})
    assert tune.apply_tuned_profile(platform="cpu") == 0
    assert stats.tuned_profile_rejects == 1


def test_clear_caches_keeps_tuned_profile(clean_tiers, stats):
    from mythril_tpu_torch.support.model import clear_caches

    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    assert tune.apply_tuned_profile(platform="cpu") == 1
    clear_caches()
    # the applied tier survives in-process cache clears...
    assert space.resolved_config()["MYTHRIL_GPU_ROUND_BUDGET"][
        "source"] == "tuned"
    # ...and the persisted section survives on disk for the next process
    loaded, reject = calibration.load_tuned("cpu")
    assert reject is None
    assert loaded["knobs"] == {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}


def test_save_profile_preserves_tuned_section(clean_tiers, monkeypatch):
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    monkeypatch.setattr(args, "solve_cache", "disk")
    calibration.save_profile("cpu", 8, 32, {"kernel_cells_s": 1e9,
                                            "pack_bytes_s": 2e8})
    profile = calibration.load_profile("cpu", 8, 32)
    assert profile == {"kernel_cells_s": 1e9, "pack_bytes_s": 2e8}
    loaded, reject = calibration.load_tuned("cpu")
    assert reject is None and loaded["knobs"]


def test_calibration_schema_bump_keeps_the_tuned_section(clean_tiers,
                                                         monkeypatch):
    """The tuned section is versioned apart: a measurement saved over a
    file of another calibration schema drops the old entries, never a
    platform's profile."""
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    path = os.path.join(str(clean_tiers), "calibration.json")
    with open(path) as fd:
        payload = json.load(fd)
    payload["schema"] = calibration.CALIBRATION_SCHEMA_VERSION + 1
    payload["entries"] = {"cpu|r8|s32": {"kernel_cells_s": 5.0}}
    with open(path, "w") as fd:
        json.dump(payload, fd)
    monkeypatch.setattr(args, "solve_cache", "disk")
    calibration.save_profile("cpu", 8, 16, {"kernel_cells_s": 1e9})
    with open(path) as fd:
        saved = json.load(fd)
    assert set(saved["entries"]) == {"cpu|r8|s16"}
    loaded, reject = calibration.load_tuned("cpu")
    assert reject is None and loaded["knobs"] == {
        "MYTHRIL_GPU_ROUND_BUDGET": 2.0}


def test_late_stats_enable_backfills_applied_count(clean_tiers):
    """serve applies the profile before the daemon enables the statistics:
    the count back-fills on the next (no-op) apply instead of reading 0
    while the knob stamp says tuned."""
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    s = SolverStatistics()
    was_enabled = s.enabled
    s.reset()
    s.enabled = False
    try:
        assert tune.apply_tuned_profile(platform="cpu") == 1
        assert s.tuned_knobs_applied == 0  # dropped: statistics off
        s.enabled = True
        assert tune.apply_tuned_profile(platform="cpu") == 0  # once
        assert s.tuned_knobs_applied == 1  # back-filled exactly once
        tune.apply_tuned_profile(platform="cpu")
        assert s.tuned_knobs_applied == 1
    finally:
        s.reset()
        s.enabled = was_enabled


def test_default_platform_falls_back_to_single_tuned_entry(
        clean_tiers, monkeypatch):
    """No CUDA initialized, no device named and no card: the one platform
    ever tuned is the guess; two are ambiguous, and no profile applies."""
    card = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr("mythril_tpu_torch.observe.metrics.torch_platform",
                        lambda: "uninitialized")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    args.torch_device = None
    assert tune.default_platform() is None  # nothing tuned: unknown
    calibration.save_tuned(card, {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    assert tune.default_platform() == card
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 3.0}})
    assert tune.default_platform() is None
    assert tune.apply_tuned_profile() == 0
    assert env_mod.tuned_values() == {}


def test_single_entry_fallback_needs_measurement_agreement(
        clean_tiers, monkeypatch):
    """A CPU-only tuned section on a machine whose own calibration
    measurements were taken on the card is another platform's profile: the
    ungrounded guess applies nothing. The router keys a card's entries
    "cuda:<name>", read here under the platform stamp's name."""
    card = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr("mythril_tpu_torch.observe.metrics.torch_platform",
                        lambda: "uninitialized")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    args.torch_device = None
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    monkeypatch.setattr(args, "solve_cache", "disk")
    calibration.save_profile("cuda:" + card, 64, 64,
                             {"kernel_cells_s": 1e12})
    assert calibration.measured_platforms() == [card]
    assert tune.default_platform() is None
    assert tune.apply_tuned_profile() == 0
    calibration.save_profile("cpu", 8, 32, {"kernel_cells_s": 1e9})
    assert tune.default_platform() is None


def test_a_named_device_or_the_card_keys_the_profile(clean_tiers,
                                                     monkeypatch):
    """--torch-device cpu keys "cpu" even where the card exists; a device
    backend run with no device named keys the card's name, so a profile
    measured on the CPU never applies on the card, nor the reverse."""
    import torch

    card = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr("mythril_tpu_torch.observe.metrics.torch_platform",
                        lambda: "uninitialized")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: card)
    calibration.save_tuned("cpu", {
        "knobs": {"MYTHRIL_GPU_ROUND_BUDGET": 2.0}})
    args.torch_device = "cpu"
    assert tune.default_platform() == "cpu"
    args.torch_device = None
    args.solver_backend = "gpu"
    assert tune.default_platform() == card
    assert tune.apply_tuned_profile() == 0, \
        "the CPU's profile applied on the card"
    calibration.save_tuned(card, {
        "knobs": {"MYTHRIL_GPU_CIRCUIT_STEPS": 32}})
    tune.reset_applied()
    assert tune.apply_tuned_profile() == 1
    assert env_mod.tuned_values() == {"MYTHRIL_GPU_CIRCUIT_STEPS": 32}


# -- configuration stamp ------------------------------------------------------


def test_stats_json_and_heartbeat_carry_knob_stamp(stats):
    env_mod.set_tuned({"MYTHRIL_GPU_COALESCE_MAX": 32})
    payload = stats.as_dict()
    assert payload["knobs"]["MYTHRIL_GPU_COALESCE_MAX"] == {
        "value": 32, "source": "tuned"}
    from mythril_tpu_torch.observe import metrics

    snap = metrics.snapshot()
    assert snap["knobs"]["MYTHRIL_GPU_COALESCE_MAX"]["source"] == "tuned"
    assert set(snap["knobs"]) == set(space.knob_names())


# -- the mixed-origin chunk cap's auto value ----------------------------------


def _router(monkeypatch, device="cpu"):
    from mythril_tpu_torch.gpu.router import QueryRouter

    class _Backend:
        num_restarts = 8
        CIRCUIT_STEPS = 32

    backend = _Backend()
    backend.device = __import__("torch").device(device)
    return QueryRouter(backend)


class _Cone:
    v1 = 9
    num_levels = 30
    num_gates = 40


def _chunk_sizes(monkeypatch, device):
    """The sizes of the xla-mode chunks of a nine-cone window of two
    origins, behind a fresh router on `device` (the budgets unbounded)."""
    import numpy as np

    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu.router import _Unit

    _Cone.level_rows = np.ones(30, dtype=np.int64)
    monkeypatch.setenv("MYTHRIL_GPU_KERNEL", "xla")
    monkeypatch.setattr(ragged_kernel, "_MODE", None)
    window = [_Unit(qi, None, _Cone(), None, origin=f"{qi % 2}:c")
              for qi in range(9)]
    router = _router(monkeypatch, device)
    monkeypatch.setattr(router, "ragged_chunk_budget_s", lambda: 1e9)
    monkeypatch.setattr(router, "ragged_prep_overhead_seconds", lambda: 0.0)
    return router, [len(c) for c in router._chunk_ragged(window, None)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_chunk_cones_caps_the_cpu_only(monkeypatch, device):
    """The JAX package derives its evidence-mode cap from its measured XLA
    compile time; K2 compiles nothing per shape, so the port's auto value
    (MYTHRIL_GPU_RAGGED_CHUNK_CONES 0, the default) is the constant
    MIXED_CHUNK_CONES_CPU on the CPU and no cap on a card (ROADMAP §3)."""
    router, sizes = _chunk_sizes(monkeypatch, device)
    assert router.ragged_chunk_cones == 0
    assert sizes == ([2, 2, 2, 2, 1] if device == "cpu" else [9])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_env_override_stays_absolute_over_auto(monkeypatch, device):
    """A nonzero MYTHRIL_GPU_RAGGED_CHUNK_CONES caps an xla-mode chunk of
    a mixed-origin window on the CPU and on a card alike."""
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_CHUNK_CONES", "3")
    router, sizes = _chunk_sizes(monkeypatch, device)
    assert router.ragged_chunk_cones == 3
    assert sizes == [3, 3, 3]


# -- parity with the JAX package ----------------------------------------------


def test_knob_table_equals_the_reference():
    """Knob for knob, in order: the JAX package's space with the prefix
    swapped, kind, default, stage and candidates equal."""
    assert len(space.KNOBS) == len(ref_space.KNOBS)
    for port, ref in zip(space.KNOBS, ref_space.KNOBS):
        assert port.env == _port_name(ref.env)
        assert (port.kind, port.default, port.stage, port.candidates) == (
            ref.kind, ref.default, ref.stage, ref.candidates), port.env


RESOLVE_CASES = [
    # (env, cli, tuned, name, default, kind)
    (None, None, None, "ROUND_BUDGET", 4.0, "float"),
    (None, None, 2.0, "ROUND_BUDGET", 4.0, "float"),
    (None, 3.0, 2.0, "ROUND_BUDGET", 4.0, "float"),
    ("9.5", 3.0, 2.0, "ROUND_BUDGET", 4.0, "float"),
    ("junk", None, 2.0, "ROUND_BUDGET", 4.0, "float"),
    ("", None, 32, "COALESCE_MAX", None, "int"),
    (None, None, "bad", "COALESCE_MAX", None, "int"),
    (None, None, 8.0, "SERVE_BATCH", 4, "int"),
    (None, None, "xla", "KERNEL", None, "str"),
    ("pallas", None, "xla", "KERNEL", None, "str"),
    (None, "7", None, "RESTARTS", 64, "int"),
]


@pytest.mark.parametrize("case", RESOLVE_CASES,
                         ids=[f"{c[3]}-{i}" for i, c in
                              enumerate(RESOLVE_CASES)])
def test_resolve_source_equals_the_reference(monkeypatch, case):
    env, cli, tuned_value, stem, default, kind = case
    seen = []
    for module, prefix in ((ref_env, "MYTHRIL_TPU_"),
                           (env_mod, "MYTHRIL_GPU_")):
        name = prefix + stem
        module.clear_overrides()
        if env is not None:
            monkeypatch.setenv(name, env)
        if cli is not None:
            module.set_cli(name, cli)
        if tuned_value is not None:
            module.set_tuned({name: tuned_value})
        seen.append(module.resolve_source(name, default, kind))
        module.clear_overrides()
    assert seen[1] == seen[0]


def test_every_knob_default_is_its_consumers_unset_value(clean_tiers,
                                                         monkeypatch):
    """With nothing set, each consumer uses its Knob.default; a derived
    default (None) is what the consumer works out on device "cpu" with the
    default flags (the gpu backend's ragged path)."""
    readers = _consumer_readers()
    assert set(readers) == set(space.knob_names())
    derived = {"MYTHRIL_GPU_CUBE_VARS": 3, "MYTHRIL_GPU_KERNEL": "pallas",
               "MYTHRIL_GPU_COALESCE_MAX": 64,
               "MYTHRIL_GPU_DEVICE_DEADLINE": 2.5}
    for knob in space.KNOBS:
        want = knob.default if knob.default is not None \
            else derived[knob.env]
        assert readers[knob.env]() == want, knob.env


def test_every_tuned_knob_reaches_its_consumer(clean_tiers, stats):
    """A profile holding a non-default value for every registered knob,
    applied as a process start applies it: each consumer's live value is
    the tuned one (the kernel mode, the router, the scheduler, the backend
    and the serve daemon read theirs after the apply)."""
    from mythril_tpu_torch.gpu import router

    readers = _consumer_readers()
    tuned_values = {knob.env: next(value for value in knob.candidates
                                   if value != knob.default)
                    for knob in space.KNOBS}
    # warm every consumer on the defaults first: the apply must reach the
    # ones already resolved
    for read in readers.values():
        read()
    assert router._router is not None
    calibration.save_tuned("cpu", {"knobs": tuned_values})
    assert tune.apply_tuned_profile(platform="cpu") == len(space.KNOBS)
    for name, value in tuned_values.items():
        got = readers[name]()
        if name == "MYTHRIL_GPU_FRONTIER_SYMLANE":
            got = int(got)
        assert got == value, name
    assert all(entry["source"] == "tuned"
               for entry in space.resolved_config().values())


def _consumer_readers():
    """{knob: a callable returning its consumer's live value on device
    "cpu"}: read through the process's own singletons, as the device path
    reads them."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu.backend import get_device_backend
    from mythril_tpu_torch.gpu.router import get_router
    from mythril_tpu_torch.laser import frontier
    from mythril_tpu_torch.serve.daemon import ServeDaemon
    from mythril_tpu_torch.service.scheduler import get_scheduler
    from mythril_tpu_torch.smt.solver import incremental

    def backend():
        return get_device_backend("cpu")

    def routed():
        return get_router("cpu")

    return {
        "MYTHRIL_GPU_ROUND_BUDGET": lambda: routed().round_budget_s,
        "MYTHRIL_GPU_RESTARTS": lambda: backend().num_restarts,
        "MYTHRIL_GPU_CIRCUIT_STEPS": lambda: backend().CIRCUIT_STEPS,
        "MYTHRIL_GPU_CUBE_VARS": lambda: routed().cube_vars(),
        "MYTHRIL_GPU_CUBE_MIN_LEVELS": lambda: routed().cube_min_levels,
        "MYTHRIL_GPU_CPU_DISPATCH_CAP": lambda: routed().cpu_dispatch_cap,
        "MYTHRIL_GPU_KERNEL": ragged_kernel.kernel_mode,
        "MYTHRIL_GPU_RAGGED_STREAM_BYTES":
            lambda: routed().ragged_stream_budget,
        "MYTHRIL_GPU_RAGGED_CHUNK_CONES":
            lambda: routed().ragged_chunk_cones,
        "MYTHRIL_GPU_RAGGED_WINDOW_CAP": lambda: routed().ragged_window_cap,
        "MYTHRIL_GPU_COALESCE_MS": lambda: get_scheduler().window_ms,
        "MYTHRIL_GPU_COALESCE_MAX": lambda: get_scheduler().max_batch,
        "MYTHRIL_GPU_DEVICE_DEADLINE": lambda: routed().dispatch_deadline(),
        "MYTHRIL_GPU_PREFIX_MEMO_MAX": incremental._prefix_memo_max,
        "MYTHRIL_GPU_SNAPSHOT_NODE_CAP": incremental._snapshot_node_cap,
        "MYTHRIL_GPU_FRONTIER_SYMLANE": frontier.symlane_enabled,
        "MYTHRIL_GPU_FRONTIER_MULTIPC": frontier.multipc_width,
        "MYTHRIL_GPU_SERVE_BATCH": lambda: ServeDaemon().batch_max,
    }


def test_coalesce_ms_zero_solves_each_bundle_directly(monkeypatch):
    """MYTHRIL_GPU_COALESCE_MS=0 disables coalescing, as in the JAX
    package: solve_batch, solve_fork_batch and submit call
    get_models_batch directly and buffer nothing."""
    from mythril_tpu_torch.service import scheduler as scheduler_mod
    from mythril_tpu_torch.support import model as model_mod

    calls = []

    def fake_batch(constraint_sets, crosscheck=None, origins=None,
                   fork_pairs=None):
        calls.append((len(constraint_sets), fork_pairs))
        return [("unknown", None)] * len(constraint_sets)

    monkeypatch.setattr(model_mod, "get_models_batch", fake_batch)
    monkeypatch.setenv("MYTHRIL_GPU_COALESCE_MS", "0")
    scheduler = scheduler_mod.CoalescingScheduler()
    assert not scheduler.enabled
    assert scheduler.solve_batch([["a"], ["b"]]) == [("unknown", None)] * 2
    scheduler.solve_fork_batch([["c"], ["d"]], [(0, 1)])
    handle = scheduler.submit(["e"])
    assert handle.done and scheduler.pending() == 0
    assert calls == [(2, None), (2, [(0, 1)]), (1, None)]
    monkeypatch.setenv("MYTHRIL_GPU_COALESCE_MS", "6")
    assert scheduler_mod.CoalescingScheduler().enabled


# -- the apply before the kernel build ----------------------------------------


@pytest.mark.parametrize("env_kernel", [None, "pallas"])
def test_tuned_kernel_mode_decides_the_build_and_the_launches(
        clean_tiers, monkeypatch, env_kernel):
    """A tuned MYTHRIL_GPU_KERNEL=xla makes analyze build K2 and not K1
    before the first window, and every solve round runs on K2; an explicit
    MYTHRIL_GPU_KERNEL=pallas shadows it (K1 built and launched). The card
    is stood in for as in test_torch_analyze_bucketed: core sees a CUDA
    device, the builds are recorded, and the windows run on the CPU."""
    import torch

    from mythril_tpu_torch import core
    from mythril_tpu_torch.gpu import (
        circuit_kernel,
        frontier_kernel,
        ragged_kernel,
        xla_kernel,
    )
    from tests.test_analysis import KILLBILLY, wrap_creation
    from tests.torch_helpers import run_analyze

    if env_kernel is not None:
        monkeypatch.setenv("MYTHRIL_GPU_KERNEL", env_kernel)
    calibration.save_tuned("cpu", {"knobs": {"MYTHRIL_GPU_KERNEL": "xla"}})
    events = []
    monkeypatch.setattr(core, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    for name, module in (("K1", ragged_kernel), ("K2", xla_kernel),
                         ("K3", circuit_kernel), ("K6", frontier_kernel)):
        monkeypatch.setattr(module, "build_kernel",
                            lambda name=name: events.append("build " + name))
    for name, module, attr in (
            ("K1", ragged_kernel, "run_round_ragged_kernel"),
            ("K2", xla_kernel, "run_round_xla_kernel")):
        real = getattr(module, attr)

        def counted(*a, real=real, name=name, **k):
            events.append("launch " + name)
            return real(*a, **k)

        monkeypatch.setattr(module, attr, counted)
    stats = SolverStatistics()
    stats.reset()
    run_analyze("mythril_tpu_torch", wrap_creation(KILLBILLY), 2, "gpu",
                60, device="cpu", pruning_factor=1)
    payload = stats.as_dict()
    stats.reset()
    if env_kernel is None:
        own, other = "K2", "K1"
        assert payload["knobs"]["MYTHRIL_GPU_KERNEL"] == {
            "value": "xla", "source": "tuned"}
        assert payload["tuned_knobs_applied"] == 1
    else:
        own, other = "K1", None
        assert payload["knobs"]["MYTHRIL_GPU_KERNEL"] == {
            "value": "pallas", "source": "env"}
        assert payload["tuned_knobs_applied"] == 0
    assert payload["kernel_backend"] == ("xla" if own == "K2" else "pallas")
    assert "launch " + own in events
    first = events.index("launch " + own)
    assert "build " + own in events[:first]
    assert "build K6" in events[:first]
    if other is not None:
        assert "build " + other not in events
        assert "launch " + other not in events
