"""The port's pre-analysis (mythril_tpu_torch/preanalysis/ and the prefix
resume in smt/solver/incremental.py) held against the JAX package's, both
with pre-analysis on.

The same constraint sets go through both Solver._prepare's, one after the
other into freshly reset global blasters and caches. Expected EXACTLY
equal: the rewritten AIG's gate arrays and roots, the CNF's lits and
offsets after cnf_prep, the dense maps and the AIG partition's components.
Then the module-level passes on seeded random inputs (preprocess_cnf,
split_components, optimize_roots), the incremental resume on and off, and
the host-side component split's verdicts.
"""

import random

import numpy as np
import pytest

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.preanalysis import aig_opt as ref_aig_opt
from mythril_tpu.preanalysis import aig_partition as ref_partition
from mythril_tpu.preanalysis import cnf_prep as ref_cnf_prep
from mythril_tpu.smt.bitblast import AIG as RefAIG
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu.support import model as ref_model
from mythril_tpu.support.args import args as ref_args
from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.preanalysis import aig_opt, aig_partition, cnf_prep
from mythril_tpu_torch.smt.bitblast import AIG
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.smt.solver import incremental
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import sibling_window
from tests.test_torch_smt import _constraint_sets


@pytest.fixture
def fresh(monkeypatch):
    """Both packages at their defaults (pre-analysis on) on the host
    backend (the port's default is the device), with fresh blasters,
    memos, sessions and partition caches."""
    for name in ("MYTHRIL_TPU_PREANALYSIS", "MYTHRIL_GPU_PREANALYSIS",
                 "MYTHRIL_TPU_AIG_OPT", "MYTHRIL_GPU_AIG_OPT",
                 "MYTHRIL_TPU_INCR_PREP", "MYTHRIL_GPU_INCR_PREP"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    port_args.solver_backend = "cpu"
    ref_model.clear_caches()
    port_model.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    ref_model.clear_caches()
    port_model.clear_caches()
    ref_args.reset()
    port_args.reset()


def _workload(smt, name):
    if name == "constraint_sets":
        return list(_constraint_sets(smt).values())
    if name == "path_prefixes":
        return _path_prefixes(smt)
    return sibling_window(smt, 12, seed=3)


def _path_prefixes(smt):
    """Each sibling query's growing prefixes, as a path's feasibility
    checks arrive: the prefix resume's food."""
    return [constraints[:length]
            for constraints in sibling_window(smt, 4, seed=6)
            for length in range(2, len(constraints) + 1)]


def _prepare_all(frontend, sets):
    preps = []
    for constraints in sets:
        solver = frontend.Solver(timeout=20)
        solver.add(constraints)
        preps.append((solver, solver._prepare([])))
    return preps


def _assert_prepared_equal(ref_prep, prep, where):
    assert prep.trivial == ref_prep.trivial, where
    if prep.trivial is not None:
        return
    assert prep.num_vars == ref_prep.num_vars, where
    np.testing.assert_array_equal(prep.clauses.lits, ref_prep.clauses.lits,
                                  err_msg=str(where))
    np.testing.assert_array_equal(prep.clauses.offsets,
                                  ref_prep.clauses.offsets,
                                  err_msg=str(where))
    ref_aig, ref_roots, ref_dense = ref_prep.aig_roots[:3]
    aig, roots, dense = prep.aig_roots[:3]
    assert list(roots) == list(ref_roots), where
    for got, want in zip(aig.gate_arrays(), ref_aig.gate_arrays()):
        np.testing.assert_array_equal(got, want, err_msg=str(where))
    np.testing.assert_array_equal(dense.arr, ref_dense.arr,
                                  err_msg=str(where))
    assert (type(prep.var_dense).__name__
            == type(ref_prep.var_dense).__name__), where
    if hasattr(ref_prep.var_dense, "input_map"):
        assert prep.var_dense.input_map == ref_prep.var_dense.input_map
        np.testing.assert_array_equal(prep.var_dense.dense.arr,
                                      ref_prep.var_dense.dense.arr)
    else:
        np.testing.assert_array_equal(prep.var_dense.arr,
                                      ref_prep.var_dense.arr)
    ref_part = ref_partition.partition_for_aig_roots(ref_prep.aig_roots)
    part = aig_partition.partition_for_aig_roots(prep.aig_roots)
    assert (part is None) == (ref_part is None), where
    if part is None:
        return
    assert len(part.components) == len(ref_part.components), where
    for component, ref_component in zip(part.components,
                                        ref_part.components):
        assert list(component.roots) == list(ref_component.roots), where
        assert (component.trivial_assignment
                == ref_component.trivial_assignment), where
        num_vars, cnf, comp_dense = component.instance(aig)
        ref_num_vars, ref_cnf, ref_comp_dense = ref_component.instance(
            ref_aig)
        assert num_vars == ref_num_vars, where
        np.testing.assert_array_equal(cnf.lits, ref_cnf.lits)
        np.testing.assert_array_equal(cnf.offsets, ref_cnf.offsets)
        np.testing.assert_array_equal(comp_dense.arr, ref_comp_dense.arr)


@pytest.mark.parametrize("workload", ["constraint_sets", "sibling_window",
                                      "path_prefixes"])
def test_prepared_instances_are_byte_identical(fresh, workload):
    ref = _prepare_all(ref_frontend, _workload(ref_smt, workload))
    port = _prepare_all(port_frontend, _workload(port_smt, workload))
    partitioned = 0
    for i, ((_rs, ref_prep), (_s, prep)) in enumerate(zip(ref, port)):
        _assert_prepared_equal(ref_prep, prep, (workload, i))
        if (prep.trivial is None and aig_partition.partition_for_aig_roots(
                prep.aig_roots) is not None):
            partitioned += 1
    assert partitioned > 0, "no query split into components"
    counters = fresh.as_dict()
    assert counters["aig_nodes_before"] > counters["aig_nodes_after"] > 0
    assert counters["cnf_units_propagated"] > 0
    if workload != "constraint_sets":
        assert counters["strash_xquery_merges"] > 0
    if workload == "path_prefixes":
        assert counters["prepare_prefix_resumes"] > 0


def _random_cnf(rng, num_vars, num_clauses):
    return [tuple(rng.choice([-1, 1]) * rng.randint(1, num_vars)
                  for _ in range(rng.randint(1, 3)))
            for _ in range(num_clauses)]


def _cnf_arrays(cnf):
    return (np.asarray(cnf.lits), np.asarray(cnf.offsets))


@pytest.mark.parametrize("allow_pure", [False, True])
def test_preprocess_cnf_matches_reference(allow_pure):
    rng = random.Random(0xC0FFEE)
    changed = 0
    for trial in range(200):
        num_vars = rng.randint(3, 16)
        clauses = _random_cnf(rng, num_vars, rng.randint(2, 48))
        want = ref_cnf_prep.preprocess_cnf(num_vars, clauses, allow_pure)
        got = cnf_prep.preprocess_cnf(num_vars, clauses, allow_pure)
        assert (got is None) == (want is None), trial
        if got is None:
            continue
        changed += got.changed
        for key in ("conflict", "units", "pures", "removed_clauses",
                    "changed"):
            assert getattr(got, key) == getattr(want, key), (trial, key)
        assert (got.cnf is None) == (want.cnf is None), trial
        if got.cnf is not None:
            for a, b in zip(_cnf_arrays(got.cnf), _cnf_arrays(want.cnf)):
                np.testing.assert_array_equal(a, b)
    assert changed > 50


def test_split_components_match_reference():
    """Random instances over disjoint variable blocks split into the same
    components (numbering, CNF, original variables, trivial bits)."""
    rng = random.Random(0x5917)
    split = 0
    for trial in range(40):
        clauses, base = [], 0
        for _block in range(rng.randint(1, 4)):
            width = rng.randint(2, 12)
            clauses += [tuple(lit + (base if lit > 0 else -base)
                              for lit in clause)
                        for clause in _random_cnf(rng, width,
                                                  rng.randint(20, 60))]
            base += width
        want = ref_cnf_prep.split_components(base, clauses)
        got = cnf_prep.split_components(base, clauses)
        assert (got is None) == (want is None), trial
        if got is None:
            continue
        split += 1
        assert len(got) == len(want), trial
        for component, ref_component in zip(got, want):
            assert component.num_vars == ref_component.num_vars
            assert list(component.orig_vars) == list(ref_component.orig_vars)
            assert component.trivial_bits == ref_component.trivial_bits
            if ref_component.cnf is not None:
                for a, b in zip(_cnf_arrays(component.cnf),
                                _cnf_arrays(ref_component.cnf)):
                    np.testing.assert_array_equal(a, b)
    assert split > 5


def _random_cone_pair(rng):
    """The same random cone built gate for gate in both AIGs."""
    ref_aig, aig = RefAIG(), AIG()
    inputs = [ref_aig.new_var() for _ in range(rng.randint(2, 6))]
    assert [aig.new_var() for _ in inputs] == inputs
    literals = [2 * v for v in inputs] + [2 * v + 1 for v in inputs]
    for _ in range(rng.randint(2, 24)):
        kind = rng.randrange(4)
        picks = [rng.choice(literals) for _ in range(3)]
        lits = []
        for graph in (ref_aig, aig):
            if kind == 0:
                lits.append(graph.and_gate(picks[0], picks[1]))
            elif kind == 1:
                lits.append(graph.or_gate(picks[0], picks[1]))
            elif kind == 2:
                lits.append(graph.xor_gate(picks[0], picks[1]))
            else:
                lits.append(graph.mux(picks[2], picks[0], picks[1]))
        assert lits[0] == lits[1]
        literals += [lits[0], lits[0] ^ 1]
    roots = [rng.choice(literals) for _ in range(rng.randint(1, 5))]
    return ref_aig, aig, inputs, roots


def test_aig_rewrite_matches_reference_on_random_cones():
    """optimize_roots rewrites the same cone into the same gates, roots and
    input map; the rewritten roots agree with the original pointwise."""
    rng = random.Random(0x51A5)
    rewritten = 0
    for trial in range(200):
        ref_aig, aig, inputs, roots = _random_cone_pair(rng)
        want = ref_aig_opt.optimize_roots(ref_aig, roots)
        got = aig_opt.optimize_roots(aig, roots)
        assert (got is None) == (want is None), trial
        if got is None:
            continue
        rewritten += 1
        assert got.trivially_unsat == want.trivially_unsat, trial
        assert list(got.roots) == list(want.roots), trial
        assert got.input_map == want.input_map, trial
        for a, b in zip(got.aig.gate_arrays(), want.aig.gate_arrays()):
            np.testing.assert_array_equal(a, b)
        for key in ("nodes_before", "nodes_after"):
            assert getattr(got, key) == getattr(want, key), (trial, key)
        if got.trivially_unsat:
            continue
        for _ in range(8):
            values = {v: rng.random() < 0.5 for v in inputs}
            mapped = {new: values[old] for old, new in got.input_map.items()
                      if old in values}
            assert (aig_opt.evaluate_roots(got.aig, got.roots, mapped)
                    == aig_opt.evaluate_roots(aig, roots, values)), trial
    assert rewritten >= 50


def _instance(prep):
    """The CNF instance the solver sees. The rewritten AIG itself differs:
    with the resume off, aig_opt's session strash is per query."""
    if prep.trivial is not None:
        return (prep.trivial,)
    return (prep.num_vars, prep.clauses.lits.tobytes(),
            prep.clauses.offsets.tobytes())


def test_incremental_resume_emits_the_full_pipelines_instances(fresh,
                                                               monkeypatch):
    """The prefix resume (MYTHRIL_GPU_INCR_PREP=1) prepares each path
    prefix into the CNF instance the full pipeline (=0) prepares."""
    instances = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", mode)
        monkeypatch.setattr(port_frontend, "_global_blaster", None)
        port_model.clear_caches()
        fresh.reset()
        fresh.enabled = True
        preps = _prepare_all(port_frontend, _path_prefixes(port_smt))
        instances[mode] = [_instance(prep) for _s, prep in preps]
        resumes = fresh.as_dict().get("prepare_prefix_resumes", 0)
        assert (resumes > 0) == (mode == "1")
    assert instances["1"] == instances["0"]


def _split_instances(smt, frontend):
    sf = smt.symbol_factory
    a, b = sf.BitVecSym("split_a", 32), sf.BitVecSym("split_b", 32)
    c, d = sf.BitVecSym("split_c", 32), sf.BitVecSym("split_d", 32)
    e, g = sf.BitVecSym("split_e", 8), sf.BitVecSym("split_g", 8)
    sets = [
        [a + b != 3, (a & 0xF0F0) != 0, b != a, c * 3 != d, (d | 1) != c],
        # 2e == 9 has no solution: the (e, g) component is UNSAT
        [a + b != 3, (a & 0xF0F0) != 0, e + g == 7, e - g == 2],
    ] + list(_constraint_sets(smt).values())
    out = []
    for constraints in sets:
        solver = frontend.Solver(timeout=20)
        solver.add(constraints)
        out.append((solver, solver._prepare([])))
    return out


def test_try_solve_split_verdicts_equal_reference(fresh):
    ref = _split_instances(ref_smt, ref_frontend)
    port = _split_instances(port_smt, port_frontend)
    verdicts = []
    for i, ((ref_solver, ref_prep), (solver, prep)) in enumerate(zip(ref,
                                                                     port)):
        if prep.trivial is not None:
            assert prep.trivial == ref_prep.trivial, i
            continue
        got = solver._try_solve_split(prep)
        assert got == ref_solver._try_solve_split(ref_prep), i
        verdicts.append(got)
        if got == "sat":
            assert solver.model() is not None
    assert "sat" in verdicts and "unsat" in verdicts
    assert fresh.as_dict()["cnf_components_split"] >= 2


def test_gates_read_the_port_knobs_only(fresh, monkeypatch):
    """MYTHRIL_GPU_* beats the port's flags both ways; the JAX package's
    knobs and flags never steer the port."""
    assert preanalysis.enabled() and aig_opt.enabled()
    assert incremental.enabled()
    monkeypatch.setenv("MYTHRIL_TPU_PREANALYSIS", "0")
    ref_args.no_preanalysis = True
    assert preanalysis.enabled()
    port_args.no_preanalysis = True
    assert not preanalysis.enabled()
    assert not aig_opt.enabled() and not incremental.enabled()
    monkeypatch.setenv("MYTHRIL_GPU_PREANALYSIS", "1")
    assert preanalysis.enabled()
    monkeypatch.setenv("MYTHRIL_GPU_PREANALYSIS", "0")
    port_args.no_preanalysis = False
    assert not preanalysis.enabled()
    monkeypatch.delenv("MYTHRIL_GPU_PREANALYSIS")
    monkeypatch.setenv("MYTHRIL_GPU_AIG_OPT", "0")
    assert preanalysis.enabled() and not aig_opt.enabled()
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "0")
    assert not incremental.enabled()
    port_args.no_incremental_prep = True
    monkeypatch.setenv("MYTHRIL_GPU_INCR_PREP", "1")
    assert incremental.enabled()


def test_clear_caches_resets_every_piece_of_solve_state(fresh, monkeypatch):
    from mythril_tpu_torch.gpu import router
    from mythril_tpu_torch.service import scheduler, tenancy

    _prepare_all(port_frontend, sibling_window(port_smt, 3, seed=3))
    assert incremental._state().prefix_memo
    assert aig_opt._cache and aig_opt._session is not None
    assert aig_partition._cache
    router_before = router.get_router("cpu")
    scheduler_before = scheduler.get_scheduler()
    tenancy._blasters["origin"] = (None, 0)
    port_model._store_result(("key",), "unsat")
    port_model.clear_caches()
    assert not incremental._state().prefix_memo
    assert not aig_opt._cache and aig_opt._session is None
    assert not aig_partition._cache
    assert router.get_router("cpu") is not router_before
    assert scheduler.get_scheduler() is not scheduler_before
    assert not tenancy._blasters and not port_model._result_cache


def test_rewritten_cones_never_alias_source_cones_in_the_pack_cache(fresh):
    """The pack cache keys on (aig.uid, roots): aig_opt's session AIG is a
    graph of its own, so a rewritten cone and a source cone with the same
    root literals pack apart."""
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend

    (_solver, prep), = _prepare_all(port_frontend,
                                    sibling_window(port_smt, 1, seed=3))
    rewritten = prep.aig_roots[0]
    assert rewritten._aig_opt_cone
    source = port_frontend.get_global_blaster().aig
    assert rewritten is not source and rewritten.uid != source.uid
    roots = list(prep.aig_roots[1])
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    assert (backend.pack_cone(rewritten, roots)
            is not backend.pack_cone(source, roots))
    assert backend.pack_cone(rewritten, roots) is backend.pack_cone(
        rewritten, roots)
