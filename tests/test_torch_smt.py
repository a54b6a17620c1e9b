"""The port's word-level frontend and bit-blaster (mythril_tpu_torch.smt)
held against the JAX package's, both run with pre-analysis off
(MYTHRIL_TPU_PREANALYSIS=0, MYTHRIL_GPU_PREANALYSIS=0); with pre-analysis
on they are held equal in test_torch_preanalysis.py.

The same constraint sets go through both Solver._prepare's, one after the
other into freshly reset global blasters (so sibling queries share gates
through the strash table in both). Expected EXACTLY equal: num_vars, the
CNF's lits and offsets, the AIG root literals and the AIG gate arrays.
Then the host-CDCL verdicts must agree and every port model must pass its
own validation against the original constraints.
"""

import numpy as np
import pytest

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support.args import args as port_args
from mythril_tpu_torch.support.workloads import sibling_window

W = 256


def _constraint_sets(smt):
    sf = smt.symbol_factory
    calldata = sf.BitVecSym("calldata_0", W)
    callvalue = sf.BitVecSym("callvalue", W)
    caller = sf.BitVecSym("caller", W)
    a, b = sf.BitVecSym("storage_a", W), sf.BitVecSym("calldata_1", W)
    x = sf.BitVecSym("balance", W)
    bound = sf.BitVecVal(0x1000, W)
    return {
        "dispatch": [smt.Extract(W - 1, W - 32, calldata)
                     == sf.BitVecVal(0xA9059CBB, 32)],
        "callvalue": [smt.ULT(callvalue, sf.BitVecVal(2 ** 40, W))],
        "caller": [caller != sf.BitVecVal(0, W)],
        "overflow": [smt.ULT(a + b, a)],
        "compare": [smt.UGT(x, bound)],
        "unsat": [smt.UGT(x, bound), smt.ULT(x, sf.BitVecVal(0x800, W))],
        "sibling": sibling_window(smt, 3, seed=5)[2],
    }


@pytest.fixture
def fresh_blasters(monkeypatch):
    # the host CDCL on both sides (the port's default is the device)
    monkeypatch.setattr(port_args, "solver_backend", "cpu")
    monkeypatch.setenv("MYTHRIL_TPU_PREANALYSIS", "0")
    monkeypatch.setenv("MYTHRIL_GPU_PREANALYSIS", "0")
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)


def _prepare_all(frontend, smt):
    preps = {}
    for name, constraints in _constraint_sets(smt).items():
        solver = frontend.Solver(timeout=20)
        solver.add(constraints)
        preps[name] = (solver, solver._prepare([]), constraints)
    return preps


def test_blasting_is_byte_identical(fresh_blasters):
    ref = _prepare_all(ref_frontend, ref_smt)
    port = _prepare_all(port_frontend, port_smt)
    assert list(ref) == list(port)
    for name in ref:
        ref_prep, prep = ref[name][1], port[name][1]
        assert prep.trivial == ref_prep.trivial, name
        if prep.trivial is not None:
            continue
        assert prep.num_vars == ref_prep.num_vars, name
        assert len(prep.clauses) == len(ref_prep.clauses), name
        np.testing.assert_array_equal(prep.clauses.lits,
                                      ref_prep.clauses.lits, err_msg=name)
        np.testing.assert_array_equal(prep.clauses.offsets,
                                      ref_prep.clauses.offsets, err_msg=name)
        assert list(prep.aig_roots[1]) == list(ref_prep.aig_roots[1]), name
        np.testing.assert_array_equal(prep.var_dense.arr,
                                      ref_prep.var_dense.arr, err_msg=name)
    # the shared AIGs grew identically, gate by gate
    ref_lhs, ref_rhs = ref_frontend.get_global_blaster().aig.gate_arrays()
    lhs, rhs = port_frontend.get_global_blaster().aig.gate_arrays()
    np.testing.assert_array_equal(lhs, ref_lhs)
    np.testing.assert_array_equal(rhs, ref_rhs)


def test_host_cdcl_verdicts_agree_and_port_models_validate(fresh_blasters):
    ref = _prepare_all(ref_frontend, ref_smt)
    port = _prepare_all(port_frontend, port_smt)
    verdicts = {}
    for name in ref:
        ref_solver, ref_prep, _ = ref[name]
        solver, prep, constraints = port[name]
        ref_status = ref_prep.trivial or ref_solver._solve_prepared(ref_prep)
        status = prep.trivial or solver._solve_prepared(prep)
        assert status == ref_status, name
        verdicts[name] = status
        if status == "sat" and prep.trivial is None:
            model = solver.model()
            # _solve_prepared already validated it in _reconstruct; check
            # again from the outside, against the wrapper constraints
            assert model.satisfies(constraints), name
    assert verdicts["unsat"] == "unsat"
    assert verdicts["overflow"] == "sat"


def test_from_gate_arrays_rebuilds_the_reference_aig(fresh_blasters):
    ref = _prepare_all(ref_frontend, ref_smt)
    ref_aig = ref_frontend.get_global_blaster().aig
    lhs, rhs = ref_aig.gate_arrays()
    from mythril_tpu_torch.smt.bitblast import AIG

    aig = AIG.from_gate_arrays(lhs, rhs)
    assert aig.num_vars == ref_aig.num_vars
    # strash table restored: re-adding an existing gate returns its literal
    var = next(v for v in range(1, aig.num_vars + 1) if lhs[v] >= 0)
    assert aig.and_gate(int(lhs[var]), int(rhs[var])) == 2 * var
    assert aig.num_vars == ref_aig.num_vars
    # the same cone exports the same CNF
    ref_prep = ref["overflow"][1]
    num_vars, cnf, dense = aig.to_cnf(list(ref_prep.aig_roots[1]))
    assert num_vars == ref_prep.num_vars
    np.testing.assert_array_equal(cnf.lits, ref_prep.clauses.lits)
    np.testing.assert_array_equal(cnf.offsets, ref_prep.clauses.offsets)
    # the dense map is sized to the AIG at export time: the later gates of
    # the shared AIG are outside this cone
    ref_dense = ref_prep.var_dense.arr
    np.testing.assert_array_equal(dense.arr[:len(ref_dense)], ref_dense)
    assert not dense.arr[len(ref_dense):].any()
