"""The AIG rewrite's native cone passes (preanalysis/aig_native.py over
csrc/aig_passes.cpp, built into the port's host library) held against the
JAX package's optimize_roots and partition_roots.

Each call of the port's optimize_roots is replayed on the JAX package over
a reference copy of its source AIG, extended to the call's watermark (the
source AIG's last var at the call), so the reference's session sees one
source uid throughout as the port's does. Per call the two must agree on
the None decision, nodes_before, nodes_after, strash_merges, const_folds,
xquery_merges, trivially_unsat, the roots, the input map, the session
AIG's gate arrays and the partition of the rewritten roots (the
components' order, roots and trivial assignments). Inputs: seeded random
cones with the root sweep on and deferred, the trivially-UNSAT, cap and
constant-root cases, one session reused across 20 sibling queries,
private sessions with the incremental layer off, and the calls the
prepares of fork pairs and of an analyze of each pinned upstream
contract make. Last, a host library that cannot be built stops a prepare.
"""

import random
import subprocess

import numpy as np
import pytest

import mythril_tpu_torch.smt as port_smt
from mythril_tpu.preanalysis import aig_opt as ref_aig_opt
from mythril_tpu.preanalysis import aig_partition as ref_aig_partition
from mythril_tpu.smt.bitblast import AIG as RefAIG
from mythril_tpu_torch import resilience
from mythril_tpu_torch.preanalysis import aig_opt, aig_partition
from mythril_tpu_torch.smt.bitblast import AIG, FALSE_LIT, TRUE_LIT
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.smt.solver import sat_backend
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import fork_window, sibling_window

FIELDS = ("nodes_before", "nodes_after", "strash_merges", "const_folds",
          "xquery_merges", "trivially_unsat")


def _reset_caches():
    for module in (aig_opt, aig_partition, ref_aig_opt, ref_aig_partition):
        module.reset_cache()


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' rewrite and partition state fresh, and their knobs
    at their defaults."""
    for name in ("PREANALYSIS", "AIG_OPT", "INCR_PREP"):
        monkeypatch.delenv("MYTHRIL_GPU_" + name, raising=False)
        monkeypatch.delenv("MYTHRIL_TPU_" + name, raising=False)
    _reset_caches()
    yield
    _reset_caches()


def _reference_copy(aig, watermark, ref_aig=None):
    """The JAX package's AIG with `aig`'s gate table up to var `watermark`
    (var ids and strash table unchanged), appended to `ref_aig` if given."""
    ref_aig = RefAIG() if ref_aig is None else ref_aig
    for var in range(ref_aig.num_vars + 1, watermark + 1):
        lhs, rhs = int(aig.gate_lhs[var]), int(aig.gate_rhs[var])
        ref_aig.gate_lhs.append(lhs)
        ref_aig.gate_rhs.append(rhs)
        if lhs >= 0:
            ref_aig._strash[(lhs, rhs)] = 2 * var
    ref_aig.num_vars = max(ref_aig.num_vars, watermark)
    return ref_aig


def _partition(partition):
    if partition is None:
        return None
    return [(list(c.roots), c.trivial_assignment)
            for c in partition.components]


def _replay(calls):
    """optimize_roots over `calls` [(aig, roots, force_roots, watermark)]
    in order, from a fresh session in each package, the reference's over
    one reference copy per source AIG; asserts the two agree call by call
    and returns the port's results."""
    _reset_caches()
    copies = {}
    results = []
    for i, (aig, roots, force_roots, watermark) in enumerate(calls):
        ref_aig = copies[id(aig)] = _reference_copy(
            aig, watermark, copies.get(id(aig)))
        got = aig_opt.optimize_roots(aig, list(roots), force_roots)
        want = ref_aig_opt.optimize_roots(ref_aig, list(roots), force_roots)
        results.append(got)
        assert (got is None) == (want is None), i
        if got is None:
            continue
        assert ({key: getattr(got, key) for key in FIELDS}
                == {key: getattr(want, key) for key in FIELDS}), i
        assert list(got.roots) == list(want.roots), i
        assert got.input_map == want.input_map, i
        for a, b in zip(got.aig.gate_arrays(), want.aig.gate_arrays()):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        expected = _partition(ref_aig_partition.partition_roots(
            want.aig, list(want.roots)))
        # with the labels the rewrite's pass gave, and labelled anew
        for labels in (got.root_labels, None):
            assert _partition(aig_partition.partition_roots(
                got.aig, list(got.roots), labels)) == expected, i
    _reset_caches()
    return results


def _random_cone(rng):
    """A random cone built gate for gate."""
    aig = AIG()
    inputs = [aig.new_var() for _ in range(rng.randint(2, 6))]
    literals = [2 * v for v in inputs] + [2 * v + 1 for v in inputs]
    for _ in range(rng.randint(2, 24)):
        kind = rng.randrange(4)
        picks = [rng.choice(literals) for _ in range(3)]
        if kind == 0:
            lit = aig.and_gate(picks[0], picks[1])
        elif kind == 1:
            lit = aig.or_gate(picks[0], picks[1])
        elif kind == 2:
            lit = aig.xor_gate(picks[0], picks[1])
        else:
            lit = aig.mux(picks[2], picks[0], picks[1])
        literals += [lit, lit ^ 1]
    roots = [rng.choice(literals) for _ in range(rng.randint(1, 5))]
    return aig, roots


@pytest.mark.parametrize("force_roots", [True, False])
def test_random_cones_match_the_reference(fresh, force_roots):
    """200 random cones, each from a fresh session: the port's result is
    the JAX package's, field for field, and so is its partition."""
    rng = random.Random(0x3A7E + force_roots)
    rewritten = split = 0
    for trial in range(200):
        aig, roots = _random_cone(rng)
        result, = _replay([(aig, roots, force_roots, aig.num_vars)])
        if result is None:
            continue
        rewritten += 1
        if not result.trivially_unsat and aig_partition.partition_roots(
                result.aig, list(result.roots)) is not None:
            split += 1
    assert rewritten >= 50 and split >= 5, (rewritten, split)


def _chain(aig, inputs):
    lit = 2 * inputs[0]
    for var in inputs[1:]:
        lit = aig.and_gate(lit, 2 * var)
    return lit


def test_unsat_cap_and_constant_roots(fresh, monkeypatch):
    """The results decided before or inside the rebuild: a FALSE root,
    contradictions found by the root sweep (directly and through a
    decomposed gate), a gate the sweep folds to TRUE asserted false, the
    node cap on either side of the cone's size, and roots that are all
    constant."""
    aig = AIG()
    a, b, c, d = (aig.new_var() for _ in range(4))
    g = aig.and_gate(2 * a, 2 * b)
    h = aig.and_gate(g, 2 * c)
    chain = _chain(aig, [a, b, c, d])
    cases = {
        "false root": [2 * a, FALSE_LIT],
        "both polarities": [2 * a, 2 * a + 1],
        "decomposed": [h, 2 * b + 1],
        "folds to true": [2 * a, 2 * b, g ^ 1],
        "true roots": [TRUE_LIT, TRUE_LIT],
        "chain": [chain ^ 1, 2 * d],
    }
    calls = [(aig, roots, True, aig.num_vars) for roots in cases.values()]
    results = dict(zip(cases, _replay(calls)))
    assert results["true roots"] is None
    for name in ("false root", "both polarities", "decomposed",
                 "folds to true"):
        assert results[name].trivially_unsat, name
    assert results["both polarities"].const_folds == 2
    assert not results["chain"].trivially_unsat
    # the cone of `chain` holds 7 vars: a cap of 7 rewrites it, 6 does not
    for cap, rewrites in ((7, True), (6, False)):
        monkeypatch.setattr(aig_opt, "AIG_OPT_NODE_CAP", cap)
        monkeypatch.setattr(ref_aig_opt, "AIG_OPT_NODE_CAP", cap)
        for force_roots in (True, False):
            result, = _replay(
                [(aig, [chain ^ 1, 2 * d], force_roots, aig.num_vars)])
            assert (result is not None) == rewrites, (cap, force_roots)


def _harvest(run):
    """The (aig, roots, force_roots, watermark) calls `run()` makes to the
    port's optimize_roots."""
    calls = []
    optimize = aig_opt.optimize_roots

    def harvest(aig, roots, force_roots=True):
        calls.append((aig, list(roots), force_roots, aig.num_vars))
        return optimize(aig, roots, force_roots)

    aig_opt.optimize_roots = harvest
    try:
        run()
    finally:
        aig_opt.optimize_roots = optimize
    return calls


def _sibling_calls(count, seed):
    """The calls the port's prepare makes for a sibling window of `count`
    queries, harvested from Solver._prepare."""
    def prepare_window():
        port_frontend._global_blaster = None
        port_model.clear_caches()
        try:
            for constraints in sibling_window(port_smt, count, seed=seed):
                solver = port_frontend.Solver(timeout=20)
                solver.add(constraints)
                solver._prepare([])
        finally:
            port_model.clear_caches()

    return _harvest(prepare_window)


def _cone_size(aig, roots):
    """Vars in the cone of `roots`."""
    seen, stack = set(), [lit >> 1 for lit in roots]
    while stack:
        var = stack.pop()
        if var and var not in seen:
            seen.add(var)
            if aig.gate_lhs[var] >= 0:
                stack += [aig.gate_lhs[var] >> 1, aig.gate_rhs[var] >> 1]
    return len(seen)


def test_a_session_reused_across_20_sibling_queries(fresh):
    """Twenty sibling queries through one session: later queries reuse the
    earlier ones' gates (xquery_merges), the port's rebuild steps through
    fewer vars than the cones hold, and the JAX package's rewrite of the
    same AIG agrees query by query."""
    calls = _sibling_calls(20, seed=11)
    assert len(calls) == 20
    results = _replay(calls)
    assert sum(result.xquery_merges for result in results[1:]) > 0
    cone_vars = sum(_cone_size(aig, roots)
                    for aig, roots, _force, _watermark in calls)
    assert 0 < sum(result.visited for result in results) < cone_vars


def test_private_sessions_with_the_incremental_layer_off(fresh,
                                                        monkeypatch):
    """With the incremental layer off every rewrite gets a throwaway
    session: both packages rewrite eight sibling queries alike, and a
    deferred-forcing rewrite keeps the original AIG (None) in both."""
    calls = _sibling_calls(8, seed=13)
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "0")
    monkeypatch.setenv("MYTHRIL_TPU_INCR_PREP", "0")
    results = _replay(calls)
    assert all(result is not None for result in results)
    assert not any(result.xquery_merges for result in results)
    deferred = [(aig, roots, False, watermark)
                for aig, roots, _force, watermark in calls]
    assert _replay(deferred) == [None] * len(calls)


def _fork_calls():
    """The calls of fork-pair prepares on the device backend: every side
    under the deferred-forcing sweep (force_roots False)."""
    sets, pairs = fork_window(port_smt, 3, seed=5)

    def solve_pairs():
        port_args.reset()
        port_model.clear_caches()
        port_args.solver_backend = "gpu"
        port_args.torch_device = "cpu"
        try:
            port_model.get_models_batch(sets, fork_pairs=pairs)
        finally:
            port_args.reset()
            port_model.clear_caches()

    return _harvest(solve_pairs)


def test_fork_pair_prepares_match_the_reference(fresh, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "16")
    calls = _fork_calls()
    assert calls and not any(force for _a, _r, force, _w in calls)
    assert any(result is not None for result in _replay(calls))


UPSTREAM = ("suicide", "origin", "exceptions_0.8.0", "killbilly")


@pytest.mark.parametrize("contract", UPSTREAM)
def test_upstream_contract_prepares_match_the_reference(
        fresh, monkeypatch, contract):
    """Every optimize_roots call of an analyze of one pinned upstream
    contract (port_bench's inputs, at its transaction count and creation
    timeout) on the device backend with fork pruning on, replayed on both
    packages."""
    import json
    import os

    from tests.torch_helpers import run_analyze

    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "16")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "port_bench", "configs",
                           "mythril-upstream-inputs.json")) as handle:
        config = json.load(handle)
    entry, = [c for c in config["contracts"] if c["name"] == contract]
    with open(os.path.join(root, entry["file"])) as handle:
        code = handle.read().strip()
    calls = _harvest(lambda: run_analyze(
        "mythril_tpu_torch", code, entry["tx_count"], "gpu", 60,
        device="cpu", pruning_factor=1,
        flags={"create_timeout": config["envelope"]["create_timeout"]}))
    assert calls
    assert any(result is not None for result in _replay(calls))


def test_a_host_library_that_cannot_be_built_stops_the_port(
        fresh, monkeypatch, tmp_path):
    """With the AIG passes' source missing, the port's host library cannot
    be built: get_native_lib() raises, and a prepare raises with it (at
    the rewrite, and again at the blaster's CNF it falls back to) rather
    than returning a CNF the rewrite did not make."""
    source = sat_backend._SOURCES[0]
    monkeypatch.setattr(sat_backend, "_SOURCES",
                        (source, str(tmp_path / "aig_passes.cpp")))
    monkeypatch.setattr(sat_backend, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(sat_backend, "_lib", None)
    with pytest.raises((OSError, subprocess.SubprocessError)):
        sat_backend.get_native_lib()
    failures = []
    monkeypatch.setattr(resilience, "note_stage_failure",
                        lambda site, hard=False: failures.append(site))
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    port_model.clear_caches()
    solver = port_frontend.Solver(timeout=20)
    solver.add(sibling_window(port_smt, 1, seed=3)[0])
    try:
        with pytest.raises((OSError, subprocess.SubprocessError)):
            solver._prepare([])
    finally:
        port_model.clear_caches()
    assert failures == ["aig.session"]
