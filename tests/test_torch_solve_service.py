"""The port's persistent result tier (service/{store,fingerprint} and the
disk half of support/model.py): the persistent-tier cases of
tests/test_solve_service.py on the port, and the tier held to the JAX
package's: the same prepared queries get the same instance and component
fingerprints, byte for byte, and the two stores write the same entries."""

import json
import os
import time

import pytest

from mythril_tpu_torch.service.scheduler import get_scheduler
from mythril_tpu_torch.service.store import (
    PersistentResultStore,
    get_result_store,
)
from mythril_tpu_torch.smt import symbol_factory
from mythril_tpu_torch.smt.solver import frontend, sat_backend
from mythril_tpu_torch.smt.solver.frontend import UnsatError
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import (
    _cache_key,
    clear_caches,
    get_model,
    get_models_batch,
)


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Fresh stats, an isolated cache dir and clean service state around
    every test, on the host backend (get_models_batch's device path has
    its own cases below); args restored afterwards."""
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    args.reset()
    args.solver_backend = "cpu"
    clear_caches()
    yield
    args.reset()
    clear_caches()
    stats.reset()
    stats.enabled = False


def _sat_constraints(tag: str, factory=symbol_factory):
    # survives word-level preprocessing (interval + square): a real blast
    x = factory.BitVecSym(f"svc_{tag}", 64)
    return [x * x > 100, x < 50, x > 40]


def _unsat_constraints(tag: str, factory=symbol_factory):
    x = factory.BitVecSym(f"svcu_{tag}", 64)
    return [x * x > 100, x < 2, x > 0]


def _store_dir(tmp_path):
    return os.path.join(str(tmp_path), "solve-cache")


def _entries(folder):
    return sorted(name for name in os.listdir(folder)
                  if name.endswith(".json"))


def test_persistent_sat_roundtrip_across_clear():
    args.solve_cache = "disk"
    constraints = _sat_constraints("roundtrip")
    cold = get_model(constraints)
    stats = SolverStatistics()
    # >= 1: a partitioned instance stores per-component entries besides
    # the whole-instance one
    assert stats.persistent_stores >= 1
    clear_caches()  # drops the memory tiers and the store handle
    stats.enabled = True
    settles_before = stats.cdcl_settles
    warm = get_model(constraints)
    assert warm.assignment == cold.assignment
    assert stats.persistent_hits == 1
    assert stats.cdcl_settles == settles_before, "served from disk"


def test_persistent_corrupted_entry_is_a_safe_miss(tmp_path):
    """Planted wrong bits fail the replay check: a safe miss counted in
    persistent_verify_rejects, and the real solve answers."""
    from mythril_tpu_torch.service.store import _pack_bits

    args.solve_cache = "disk"
    constraints = _sat_constraints("corrupt")
    cold = get_model(constraints)
    store_dir = _store_dir(tmp_path)
    entries = _entries(store_dir)
    assert len(entries) >= 1
    for name in entries:
        path = os.path.join(store_dir, name)
        with open(path) as fd:
            payload = json.load(fd)
        # an all-zero assignment of the right length: decodes, fails the
        # replay (x = 0 violates x > 40)
        payload["bits"] = _pack_bits([False] * (payload["num_vars"] + 1))
        with open(path, "w") as fd:
            json.dump(payload, fd)
    clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    model = get_model(constraints)
    assert model.assignment == cold.assignment
    assert stats.persistent_verify_rejects == 1
    assert stats.persistent_hits == 0


def test_persistent_unsat_provenance_gates_detection_trust(monkeypatch):
    args.solve_cache = "disk"
    calls = {"n": 0}
    original = sat_backend._crosscheck_unsat

    def counting(*c_args, **c_kwargs):
        calls["n"] += 1
        return original(*c_args, **c_kwargs)

    monkeypatch.setattr(sat_backend, "_crosscheck_unsat", counting)
    constraints = _unsat_constraints("prov")
    with pytest.raises(UnsatError):
        get_model(constraints)  # engine path: stored without provenance
    assert calls["n"] == 0
    clear_caches()
    with model_mod.detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # unprovenanced entry: re-solved
    assert calls["n"] == 1
    clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    with model_mod.detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # provenance-carrying entry: trusted
    assert calls["n"] == 1
    assert stats.persistent_hits == 1


def test_cap_skipped_crosscheck_is_not_stored_as_provenance(monkeypatch):
    args.solve_cache = "disk"
    monkeypatch.setattr(sat_backend, "CROSSCHECK_CLAUSE_CAP", 1)
    constraints = _unsat_constraints("capskip")
    with model_mod.detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # requested but cap-skipped
    assert not sat_backend.last_crosscheck_confirmed()
    clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    with model_mod.detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)
    assert stats.persistent_hits == 0  # unprovenanced entry: not trusted


def test_unprovenanced_disk_hit_does_not_seed_memory_tier(monkeypatch):
    args.solve_cache = "disk"
    calls = {"n": 0}
    original = sat_backend._crosscheck_unsat

    def counting(*c_args, **c_kwargs):
        calls["n"] += 1
        return original(*c_args, **c_kwargs)

    monkeypatch.setattr(sat_backend, "_crosscheck_unsat", counting)
    constraints = _unsat_constraints("seed")
    with pytest.raises(UnsatError):
        get_model(constraints)  # engine solve: stored unprovenanced
    clear_caches()
    with pytest.raises(UnsatError):
        get_model(constraints)  # engine path trusts the disk entry...
    key = _cache_key([c.raw for c in constraints])
    assert key not in model_mod._result_cache  # ...but must not memoize it
    with model_mod.detection_context():
        with pytest.raises(UnsatError):
            get_model(constraints)  # same process: provenance gate intact
    assert calls["n"] == 1


def test_persistent_unsat_trusted_on_engine_path_without_provenance():
    args.solve_cache = "disk"
    constraints = _unsat_constraints("engine")
    with pytest.raises(UnsatError):
        get_model(constraints)
    clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    settles_before = stats.cdcl_settles
    with pytest.raises(UnsatError):
        get_model(constraints)
    assert stats.persistent_hits == 1
    assert stats.cdcl_settles == settles_before


@pytest.mark.parametrize("mode", ["off", "memory"])
def test_no_disk_tier_below_disk_mode(mode, tmp_path):
    args.solve_cache = mode
    get_model(_sat_constraints(f"mode_{mode}"))
    assert SolverStatistics().persistent_stores == 0
    assert not os.path.isdir(_store_dir(tmp_path))
    if mode == "off":
        assert not model_mod._result_cache


def test_get_models_batch_hits_persistent_tier():
    args.solve_cache = "disk"
    sat_set = _sat_constraints("batch")
    unsat_set = _unsat_constraints("batch")
    cold = get_models_batch([sat_set, unsat_set])
    assert [status for status, _ in cold] == ["sat", "unsat"]
    clear_caches()
    stats = SolverStatistics()
    stats.enabled = True
    settles_before = stats.cdcl_settles
    warm = get_models_batch([sat_set, unsat_set])
    assert [status for status, _ in warm] == ["sat", "unsat"]
    assert stats.persistent_hits == 2
    assert stats.cdcl_settles == settles_before


def _device_window(tag, count=4):
    """Production-shape 256-bit sibling queries (the JAX package's chaos
    seam mix): they reach the router, and K1 finds their models."""
    from mythril_tpu_torch.smt import Extract, ULT

    queries = []
    for qi in range(count):
        data = symbol_factory.BitVecSym(f"svc_data_{tag}_{qi}", 256)
        value = symbol_factory.BitVecSym(f"svc_value_{tag}_{qi}", 256)
        sender = symbol_factory.BitVecSym(f"svc_sender_{tag}_{qi}", 256)
        queries.append([
            Extract(255, 224, data)
            == symbol_factory.BitVecVal(0xAB125858 ^ qi, 32),
            ULT(value, symbol_factory.BitVecVal(1 << 40, 256)),
            sender != symbol_factory.BitVecVal(0, 256),
            value + data != sender,
        ])
    return queries


def test_device_models_reach_the_disk_and_serve_a_later_process():
    """K1's models (the plain round on the CPU) are stored whole and per
    component, and a cleared process serves the window from disk without
    a launch or a settle; every served model passes its constraints."""
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    args.solve_cache = "disk"
    queries = _device_window("k1")
    stats = SolverStatistics()
    cold = get_models_batch(queries)
    assert [status for status, _ in cold] == ["sat"] * 4
    assert stats.device_batch_hits > 0, "K1 found no model"
    assert stats.persistent_stores >= stats.device_batch_hits
    clear_caches()
    stats.reset()
    stats.enabled = True
    warm = get_models_batch(queries)
    assert [status for status, _ in warm] == ["sat"] * 4
    assert stats.persistent_hits == 4
    assert stats.kernel_launches == 0 and stats.cdcl_settles == 0
    for constraints, (_status, model) in zip(queries, warm):
        assert model.satisfies([c.raw for c in constraints])


def test_bad_disk_entry_of_a_device_model_is_a_safe_miss(tmp_path):
    """An entry on disk that fails _reconstruct is a host artefact: a safe
    miss counted in persistent_verify_rejects, never a DeviceFault."""
    from mythril_tpu_torch.service.store import _pack_bits

    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    args.solve_cache = "disk"
    queries = _device_window("bad", count=2)
    get_models_batch(queries)
    store_dir = _store_dir(tmp_path)
    for name in _entries(store_dir):
        path = os.path.join(store_dir, name)
        with open(path) as fd:
            payload = json.load(fd)
        if payload["verdict"] == "sat":
            payload["bits"] = _pack_bits(
                [True] * (payload["num_vars"] + 1))
            with open(path, "w") as fd:
                json.dump(payload, fd)
    clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    outcomes = get_models_batch(queries)
    assert [status for status, _ in outcomes] == ["sat", "sat"]
    assert stats.persistent_verify_rejects >= 1
    assert stats.persistent_hits == 0


def test_store_schema_bump_invalidates_entries(tmp_path, monkeypatch):
    from mythril_tpu_torch.service import store as store_mod

    args.solve_cache = "disk"
    get_model(_sat_constraints("schema"))
    store_dir = _store_dir(tmp_path)
    assert _entries(store_dir)
    clear_caches()
    monkeypatch.setattr(store_mod, "STORE_SCHEMA_VERSION", 999)
    assert PersistentResultStore(root=store_dir).entry_count() == 0


def test_store_lru_eviction_caps_entries(tmp_path):
    store = PersistentResultStore(root=str(tmp_path / "lru"), max_entries=4)
    for i in range(8):
        assert store.store_unsat(f"{i:064x}", crosschecked=False)
    assert store.entry_count() <= 4
    assert store.lookup(f"{7:064x}") is not None
    assert store.lookup(f"{0:064x}") is None


def test_store_byte_size_eviction_oldest_first(tmp_path):
    store = PersistentResultStore(root=str(tmp_path / "bytes"),
                                  max_entries=1000, max_bytes=1)
    for i in range(4):
        assert store.store_sat(f"{i:064x}", num_vars=64, bits=[True] * 65)
        time.sleep(0.02)  # distinct mtimes for the LRU order
    assert store.lookup(f"{3:064x}") is not None  # newest survives
    for i in range(3):
        assert store.lookup(f"{i:064x}") is None


def test_store_caps_read_the_port_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_MAX_BYTES", "100000")
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_MAX_ENTRIES", "7")
    monkeypatch.setenv("MYTHRIL_TPU_CACHE_MAX_ENTRIES", "3")
    store = PersistentResultStore(root=str(tmp_path / "env"))
    assert store.max_bytes == 100000
    assert store.max_entries == 7
    assert store.store_unsat("a" * 64, crosschecked=False)
    assert store.total_bytes() > 0
    assert store.entry_count() == 1


def test_store_root_is_under_the_port_cache_dir(tmp_path):
    args.solve_cache = "disk"
    assert get_result_store().root == _store_dir(tmp_path)


def test_clear_caches_resets_service_handles():
    args.solve_cache = "disk"
    first = get_result_store()
    handle = get_scheduler().submit(_sat_constraints("clear"))
    clear_caches()
    assert get_result_store() is not first  # re-opened from disk
    assert handle.done and handle.result()[0] == "unknown"


# -- parity with the JAX package ------------------------------------------------


def _prepared(package_name, make):
    import importlib

    smt = importlib.import_module(f"{package_name}.smt")
    frontend_mod = importlib.import_module(
        f"{package_name}.smt.solver.frontend")
    frontend_mod._global_blaster = None
    solver = frontend_mod.Solver()
    solver.add(*make(smt.symbol_factory))
    return solver._prepare([])


QUERIES = {
    "interval_square": lambda f: _sat_constraints("par", factory=f),
    "unsat_square": lambda f: _unsat_constraints("par", factory=f),
    "two_components": lambda f: [
        f.BitVecSym("pa", 64) * f.BitVecSym("pa", 64) > 100,
        f.BitVecSym("pa", 64) < 50,
        f.BitVecSym("pb", 32) + f.BitVecVal(7, 32) == f.BitVecVal(99, 32),
        f.BitVecSym("pc", 16) & f.BitVecVal(0xFF, 16) == f.BitVecVal(3, 16)],
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fingerprints_equal_the_reference(name):
    from mythril_tpu.preanalysis import aig_partition as ref_partition
    from mythril_tpu.service import fingerprint as ref_fingerprint
    from mythril_tpu_torch.preanalysis import aig_partition
    from mythril_tpu_torch.service import fingerprint

    ref_prep = _prepared("mythril_tpu", QUERIES[name])
    prep = _prepared("mythril_tpu_torch", QUERIES[name])
    digest = fingerprint.instance_fingerprint(prep)
    assert digest is not None
    assert digest == ref_fingerprint.instance_fingerprint(ref_prep)
    ref_parts = ref_partition.partition_for_aig_roots(ref_prep.aig_roots)
    parts = aig_partition.partition_for_aig_roots(prep.aig_roots)
    assert (parts is None) == (ref_parts is None)
    if parts is None:
        return
    digests = []
    for ours, theirs in zip(parts.components, ref_parts.components):
        nv, cnf, dense = ours.instance(prep.aig_roots[0])
        ref_nv, ref_cnf, ref_dense = theirs.instance(ref_prep.aig_roots[0])
        digests.append(fingerprint.component_fingerprint(
            nv, cnf, ours.roots, dense))
        assert digests[-1] == ref_fingerprint.component_fingerprint(
            ref_nv, ref_cnf, theirs.roots, ref_dense)
    assert len(digests) == len(ref_parts.components)


def test_two_stores_write_the_same_entries(tmp_path, monkeypatch):
    """get_model on the same queries with both packages' disk tiers on:
    the same entry files (names are fingerprints) with the same payloads,
    equal as JSON."""
    from mythril_tpu.smt import symbol_factory as ref_factory
    from mythril_tpu.smt.solver import frontend as ref_frontend
    from mythril_tpu.smt.solver.frontend import UnsatError as RefUnsat
    from mythril_tpu.support import model as ref_model
    from mythril_tpu.support.args import args as ref_args

    monkeypatch.setenv("MYTHRIL_TPU_CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("MYTHRIL_GPU_CACHE_DIR", str(tmp_path / "port"))
    saved = ref_args.solve_cache
    ref_args.solve_cache = "disk"
    args.solve_cache = "disk"
    packages = (("mythril_tpu", ref_factory, ref_model.get_model, RefUnsat,
                 ref_frontend),
                ("mythril_tpu_torch", symbol_factory, get_model, UnsatError,
                 frontend))
    try:
        ref_model.clear_caches()
        clear_caches()
        for _name, factory, get_fn, unsat, front in packages:
            front._global_blaster = None
            get_fn(_sat_constraints("same", factory=factory))
            with pytest.raises(unsat):
                get_fn(_unsat_constraints("same", factory=factory))
    finally:
        ref_args.solve_cache = saved
        ref_model.clear_caches()
    ref_dir = os.path.join(str(tmp_path / "ref"), "solve-cache")
    port_dir = _store_dir(tmp_path / "port")
    names = _entries(port_dir)
    assert len(names) >= 2
    assert names == _entries(ref_dir)
    for name in names:
        with open(os.path.join(port_dir, name)) as fd:
            ours = json.load(fd)
        with open(os.path.join(ref_dir, name)) as fd:
            theirs = json.load(fd)
        assert ours == theirs, name
