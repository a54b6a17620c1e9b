"""The AIG rewrite's native cone passes (preanalysis/aig_native.py over
csrc/aig_passes.cpp) held against its Python passes, and both against the
JAX package's optimize_roots.

For every input the native path's result must equal the Python path's:
the session AIG's gate arrays, the roots, the input map, nodes_before,
nodes_after, strash_merges, const_folds, xquery_merges, trivially_unsat,
the None decisions, and the partition of the rewritten roots (the
components' order, roots and trivial assignments, the order scipy's
connectivity labels give). Inputs: seeded random cones with the root sweep
on and deferred, the trivially-UNSAT, cap and constant-root cases, one
session reused across 20 sibling queries, and the calls the prepares of
the sibling window, of fork pairs and of an analyze of each pinned
upstream contract make. The native leg skips only where g++ is missing.
"""

import random
import shutil

import numpy as np
import pytest

import mythril_tpu_torch.smt as port_smt
from mythril_tpu.preanalysis import aig_opt as ref_aig_opt
from mythril_tpu.smt.bitblast import AIG as RefAIG
from mythril_tpu_torch.preanalysis import aig_native, aig_opt, aig_partition
from mythril_tpu_torch.preanalysis.components import connected_labels
from mythril_tpu_torch.smt.bitblast import AIG, FALSE_LIT, TRUE_LIT
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import fork_window, sibling_window

FIELDS = ("nodes_before", "nodes_after", "strash_merges", "const_folds",
          "xquery_merges", "trivially_unsat")


@pytest.fixture
def native(monkeypatch):
    """The native library (the test skips without g++) and fresh aig_opt
    and partition state."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native passes cannot be built")
    lib = aig_native.library()
    assert lib is not None, "g++ is present but the library did not build"
    for name in ("MYTHRIL_GPU_PREANALYSIS", "MYTHRIL_GPU_AIG_OPT",
                 "MYTHRIL_GPU_INCR_PREP"):
        monkeypatch.delenv(name, raising=False)
    aig_opt.reset_cache()
    aig_partition.reset_cache()
    yield lib
    aig_opt.reset_cache()
    aig_partition.reset_cache()


def _run(calls, use_native, monkeypatch):
    """optimize_roots over `calls` [(aig, roots, force_roots)] in order,
    from a fresh session, on one path; per call the result's record, and
    the session AIGs the results live in."""
    with monkeypatch.context() as patch:
        if not use_native:
            patch.setattr(aig_native, "library", lambda: None)
        aig_opt.reset_cache()
        records, aigs = [], []
        for aig, roots, force_roots in calls:
            result = aig_opt.optimize_roots(aig, list(roots), force_roots)
            records.append(_record(result))
            aigs.append(None if result is None else result.aig)
        aig_opt.reset_cache()
    return records, aigs


def _record(result):
    if result is None:
        return None
    assert result.native == (aig_native.library() is not None)
    if result.trivially_unsat:
        partition = None
    else:
        partition = _partition(aig_partition.partition_roots(
            result.aig, list(result.roots), result.root_labels))
    return ({key: getattr(result, key) for key in FIELDS},
            list(result.roots), dict(result.input_map),
            result.aig.num_vars, partition)


def _partition(partition):
    if partition is None:
        return None
    return [(list(c.roots), c.trivial_assignment)
            for c in partition.components]


def _assert_same_runs(calls, monkeypatch):
    """Both paths over `calls`: equal records and equal session AIGs.
    Returns the native records."""
    got, got_aigs = _run(calls, True, monkeypatch)
    want, want_aigs = _run(calls, False, monkeypatch)
    assert len(got) == len(want)
    for i, (record, expected) in enumerate(zip(got, want)):
        assert record == expected, i
    # the session AIGs are append-only: equal at the end and at each
    # call's watermark (num_vars, in the record) means equal at each call
    for i, (aig, ref) in enumerate(zip(got_aigs, want_aigs)):
        if aig is None:
            continue
        for a, b in zip(aig.gate_arrays(), ref.gate_arrays()):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
    return got


def _scipy_order(result):
    """The components of the rewritten roots as scipy's labels order them
    over the sorted cone: the roots of each label, by label."""
    lhs, rhs = result.aig.gate_arrays()
    cone = np.sort(aig_partition._cone_vars(
        lhs, rhs, [lit >> 1 for lit in result.roots]))
    gates = cone[lhs[cone] >= 0]
    edges_v = np.concatenate([lhs[gates] >> 1, rhs[gates] >> 1])
    edges_u = np.concatenate([gates, gates])
    keep = edges_v != 0
    labels = connected_labels(len(cone),
                              np.searchsorted(cone, edges_u[keep]),
                              np.searchsorted(cone, edges_v[keep]))
    groups = {}
    for lit in result.roots:
        label = int(labels[np.searchsorted(cone, lit >> 1)])
        groups.setdefault(label, []).append(lit)
    return [groups[label] for label in sorted(groups)]


def _random_cone(rng, ref_aig=None):
    """A random cone built gate for gate (in `ref_aig` too, if given)."""
    aig = AIG()
    graphs = [aig] if ref_aig is None else [aig, ref_aig]
    inputs = [aig.new_var() for _ in range(rng.randint(2, 6))]
    for graph in graphs[1:]:
        assert [graph.new_var() for _ in inputs] == inputs
    literals = [2 * v for v in inputs] + [2 * v + 1 for v in inputs]
    for _ in range(rng.randint(2, 24)):
        kind = rng.randrange(4)
        picks = [rng.choice(literals) for _ in range(3)]
        lits = set()
        for graph in graphs:
            if kind == 0:
                lits.add(graph.and_gate(picks[0], picks[1]))
            elif kind == 1:
                lits.add(graph.or_gate(picks[0], picks[1]))
            elif kind == 2:
                lits.add(graph.xor_gate(picks[0], picks[1]))
            else:
                lits.add(graph.mux(picks[2], picks[0], picks[1]))
        lit, = lits
        literals += [lit, lit ^ 1]
    roots = [rng.choice(literals) for _ in range(rng.randint(1, 5))]
    return aig, roots


@pytest.mark.parametrize("force_roots", [True, False])
def test_random_cones_match_the_python_path_and_the_reference(
        native, monkeypatch, force_roots):
    """200 random cones, each from a fresh session: the native result is
    the Python path's and the JAX package's, field for field, and its
    partition's components come in scipy's order."""
    rng = random.Random(0x3A7E + force_roots)
    rewritten = split = 0
    for trial in range(200):
        ref_aig = RefAIG()
        aig, roots = _random_cone(rng, ref_aig)
        got, = _assert_same_runs([(aig, roots, force_roots)], monkeypatch)
        ref_aig_opt.reset_cache()
        want = ref_aig_opt.optimize_roots(ref_aig, list(roots),
                                          force_roots=force_roots)
        assert (got is None) == (want is None), trial
        if want is None:
            continue
        rewritten += 1
        fields, new_roots, input_map, _num_vars, partition = got
        assert fields == {key: getattr(want, key) for key in FIELDS}, trial
        assert new_roots == list(want.roots), trial
        assert input_map == want.input_map, trial
        aig_opt.reset_cache()
        result = aig_opt.optimize_roots(aig, list(roots), force_roots)
        for a, b in zip(result.aig.gate_arrays(), want.aig.gate_arrays()):
            np.testing.assert_array_equal(a, b, err_msg=str(trial))
        if partition is not None:
            split += 1
            assert [roots for roots, _ in partition] == _scipy_order(result)
    aig_opt.reset_cache()
    assert rewritten >= 50 and split >= 5, (rewritten, split)


def _chain(aig, inputs):
    lit = 2 * inputs[0]
    for var in inputs[1:]:
        lit = aig.and_gate(lit, 2 * var)
    return lit


def test_unsat_cap_and_constant_roots(native, monkeypatch):
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
    calls = [(aig, roots, True) for roots in cases.values()]
    records = dict(zip(cases, _assert_same_runs(calls, monkeypatch)))
    assert records["true roots"] is None
    for name in ("false root", "both polarities", "decomposed",
                 "folds to true"):
        assert records[name][0]["trivially_unsat"], name
    assert records["both polarities"][0]["const_folds"] == 2
    assert not records["chain"][0]["trivially_unsat"]
    # the cone of `chain` holds 7 vars: a cap of 7 rewrites it, 6 does not
    for cap, rewrites in ((7, True), (6, False)):
        monkeypatch.setattr(aig_opt, "AIG_OPT_NODE_CAP", cap)
        for force_roots in (True, False):
            got, = _assert_same_runs(
                [(aig, [chain ^ 1, 2 * d], force_roots)], monkeypatch)
            assert (got is not None) == rewrites, (cap, force_roots)


def _sibling_calls(count, seed):
    """The (aig, roots, force_roots) calls the port's prepare makes for a
    sibling window of `count` queries, harvested from Solver._prepare."""
    calls = []
    optimize = aig_opt.optimize_roots

    def harvest(aig, roots, force_roots=True):
        calls.append((aig, list(roots), force_roots))
        return optimize(aig, roots, force_roots)

    aig_opt.optimize_roots = harvest
    try:
        port_frontend._global_blaster = None
        port_model.clear_caches()
        for constraints in sibling_window(port_smt, count, seed=seed):
            solver = port_frontend.Solver(timeout=20)
            solver.add(constraints)
            solver._prepare([])
    finally:
        aig_opt.optimize_roots = optimize
        port_model.clear_caches()
    return calls


def _reference_copy(aig):
    """The JAX package's AIG with `aig`'s gate table (var ids and strash
    table unchanged)."""
    ref_aig = RefAIG()
    ref_aig.gate_lhs = list(aig.gate_lhs)
    ref_aig.gate_rhs = list(aig.gate_rhs)
    ref_aig.num_vars = aig.num_vars
    ref_aig._strash = dict(aig._strash)
    return ref_aig


def test_a_session_reused_across_20_sibling_queries(native, monkeypatch):
    """Twenty sibling queries through one session: later queries reuse the
    earlier ones' gates (xquery_merges), the native path steps through
    fewer vars than the cone holds, and both paths agree with the JAX
    package's rewrite of the same AIG, query by query."""
    calls = _sibling_calls(20, seed=11)
    assert len(calls) == 20
    records = _assert_same_runs(calls, monkeypatch)
    assert sum(fields["xquery_merges"] for fields, *_ in records[1:]) > 0
    ref_aig = _reference_copy(calls[0][0])
    ref_aig_opt.reset_cache()
    try:
        for i, ((_aig, roots, force_roots), record) in enumerate(
                zip(calls, records)):
            want = ref_aig_opt.optimize_roots(ref_aig, roots, force_roots)
            assert (record is None) == (want is None), i
            if want is not None:
                assert record[0] == {key: getattr(want, key)
                                     for key in FIELDS}, i
                assert record[1] == list(want.roots), i
                assert record[2] == want.input_map, i
    finally:
        ref_aig_opt.reset_cache()
    visited = {}
    for use_native in (True, False):
        with monkeypatch.context() as patch:
            if not use_native:
                patch.setattr(aig_native, "library", lambda: None)
            aig_opt.reset_cache()
            visited[use_native] = sum(
                aig_opt.optimize_roots(aig, roots, force_roots).visited
                for aig, roots, force_roots in calls)
    aig_opt.reset_cache()
    # the Python path steps through every cone var
    assert visited[False] == sum(
        len(aig_partition._cone_vars(*aig.gate_arrays(),
                                     [lit >> 1 for lit in roots]))
        for aig, roots, _force in calls)
    assert 0 < visited[True] < visited[False]


def test_private_sessions_with_the_incremental_layer_off(native,
                                                        monkeypatch):
    """With the incremental layer off every rewrite gets a throwaway
    session: both paths rewrite eight sibling queries alike, and a
    deferred-forcing rewrite keeps the original AIG (None) on both."""
    calls = _sibling_calls(8, seed=13)
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "0")
    records = _assert_same_runs(calls, monkeypatch)
    assert all(record is not None for record in records)
    assert not any(fields["xquery_merges"] for fields, *_ in records)
    deferred = [(aig, roots, False) for aig, roots, _force in calls]
    assert _assert_same_runs(deferred, monkeypatch) == [None] * len(calls)


def _fork_calls():
    """The calls of fork-pair prepares on the device backend: every side
    under the deferred-forcing sweep (force_roots False)."""
    calls = []
    optimize = aig_opt.optimize_roots

    def harvest(aig, roots, force_roots=True):
        calls.append((aig, list(roots), force_roots))
        return optimize(aig, roots, force_roots)

    sets, pairs = fork_window(port_smt, 3, seed=5)
    port_args.reset()
    port_model.clear_caches()
    port_args.solver_backend = "gpu"
    port_args.torch_device = "cpu"
    aig_opt.optimize_roots = harvest
    try:
        port_model.get_models_batch(sets, fork_pairs=pairs)
    finally:
        aig_opt.optimize_roots = optimize
        port_args.reset()
        port_model.clear_caches()
    return calls


def test_fork_pair_prepares_match_the_python_path(native, monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "16")
    calls = _fork_calls()
    assert calls and not any(force for _a, _r, force in calls)
    records = _assert_same_runs(calls, monkeypatch)
    assert any(record is not None for record in records)


UPSTREAM = ("suicide", "origin", "exceptions_0.8.0", "killbilly")


@pytest.mark.parametrize("contract", UPSTREAM)
def test_upstream_contract_prepares_match_the_python_path(
        native, monkeypatch, contract):
    """Every optimize_roots call of an analyze of one pinned upstream
    contract (port_bench's inputs, at its transaction count and creation
    timeout) on the device backend with fork pruning on, replayed on both
    paths."""
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
    calls = []
    optimize = aig_opt.optimize_roots

    def harvest(aig, roots, force_roots=True):
        calls.append((aig, list(roots), force_roots))
        return optimize(aig, roots, force_roots)

    aig_opt.optimize_roots = harvest
    try:
        run_analyze("mythril_tpu_torch", code, entry["tx_count"], "gpu", 60,
                    device="cpu", pruning_factor=1,
                    flags={"create_timeout": config["envelope"][
                        "create_timeout"]})
    finally:
        aig_opt.optimize_roots = optimize
    assert calls
    records = _assert_same_runs(calls, monkeypatch)
    assert any(record is not None for record in records)
