"""The port's single-query solve seam (support/model.get_model, with
Optimize for witness minimisation, and detection_context) held against
the JAX package's on the host CDCL: the same verdicts and the same models,
byte for byte, with pre-analysis at both packages' defaults."""

import pytest

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu.support import model as ref_model
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as port_model
from mythril_tpu_torch.support.args import args as port_args
from tests.test_torch_smt import W, _constraint_sets

SIDES = ((ref_smt, ref_frontend, ref_model), (port_smt, port_frontend,
                                              port_model))


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for name in ("MYTHRIL_TPU_PREANALYSIS", "MYTHRIL_GPU_PREANALYSIS",
                 "MYTHRIL_TPU_UNSAT_CROSSCHECK",
                 "MYTHRIL_GPU_UNSAT_CROSSCHECK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_args, "solver_backend", "cpu")
    for _smt, frontend, model in SIDES:
        monkeypatch.setattr(frontend, "_global_blaster", None)
        model.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    for _smt, _frontend, model in SIDES:
        model.clear_caches()


def _outcome(model_mod, frontend, call):
    try:
        model = call()
    except frontend.UnsatError:
        return "unsat"
    except frontend.SolverTimeOutException:
        return "unknown"
    return sorted((str(name), repr(value))
                  for name, value in model.assignment.items())


def _objectives(smt):
    sf = smt.symbol_factory
    callvalue = sf.BitVecSym("callvalue", W)
    calldata = sf.BitVecSym("calldata_0", W)
    return {
        "minimize": ([smt.UGT(callvalue, sf.BitVecVal(0x1234, W))],
                     [callvalue], []),
        "maximize": ([smt.ULT(callvalue, sf.BitVecVal(0x77, W))],
                     [], [callvalue]),
        "lexicographic": ([smt.ULT(calldata + callvalue, calldata)],
                          [calldata, callvalue], []),
        "unsat": ([smt.UGT(callvalue, sf.BitVecVal(9, W)),
                   smt.ULT(callvalue, sf.BitVecVal(3, W))], [callvalue], []),
    }


def test_get_model_equal_reference(fresh):
    outcomes = []
    for smt, frontend, model in SIDES:
        sets = _constraint_sets(smt)
        outcomes.append({
            name: _outcome(model, frontend,
                           lambda c=constraints: model.get_model(
                               c, enforce_execution_time=False))
            for name, constraints in sets.items()})
    assert outcomes[1] == outcomes[0]
    assert outcomes[1]["unsat"] == "unsat"
    assert isinstance(outcomes[1]["overflow"], list)
    # the memory tier answers a repeated query
    before = fresh.memory_hits
    constraints = _constraint_sets(port_smt)["overflow"]
    port_model.get_model(constraints, enforce_execution_time=False)
    assert fresh.memory_hits == before + 1


def test_optimize_equal_reference():
    outcomes = []
    for smt, frontend, model in SIDES:
        outcomes.append({
            name: _outcome(model, frontend,
                           lambda c=c, lo=lo, hi=hi: model.get_model(
                               c, minimize=lo, maximize=hi,
                               enforce_execution_time=False))
            for name, (c, lo, hi) in _objectives(smt).items()})
    assert outcomes[1] == outcomes[0]
    assert outcomes[1]["unsat"] == "unsat"
    values = dict(outcomes[1]["minimize"])
    assert values["callvalue"] == repr(0x1235)
    values = dict(outcomes[1]["maximize"])
    assert values["callvalue"] == repr(0x76)


def test_optimize_solver_equal_reference():
    """Optimize used directly, as analysis/solver.py does for witnesses."""
    models = []
    for smt, frontend, _model in SIDES:
        sf = smt.symbol_factory
        value = sf.BitVecSym("callvalue", W)
        size = sf.BitVecSym("calldatasize", W)
        solver = frontend.Optimize(timeout=20)
        solver.add([smt.UGT(value + size, sf.BitVecVal(1000, W)),
                    smt.ULT(size, sf.BitVecVal(600, W))])
        solver.minimize(size)
        solver.minimize(value)
        assert solver.check() == "sat"
        models.append(sorted((str(k), repr(v)) for k, v in
                             solver.model().assignment.items()))
    assert models[1] == models[0]


@pytest.mark.parametrize("env", ["", "0", "1"])
def test_detection_context_requests_the_crosscheck(env, monkeypatch, fresh):
    wanted = []
    for name, (_smt, _frontend, model) in zip(("TPU", "GPU"), SIDES):
        if env:
            monkeypatch.setenv(f"MYTHRIL_{name}_UNSAT_CROSSCHECK", env)
        outside = model._crosscheck_wanted()
        with model.detection_context():
            inside = model._crosscheck_wanted()
            with model.detection_context():
                nested = model._crosscheck_wanted()
            after_nested = model._crosscheck_wanted()
        wanted.append((outside, inside, nested, after_nested,
                       model._crosscheck_wanted()))
    assert wanted[1] == wanted[0]
    if not env:
        assert wanted[1] == (False, True, True, True, False)
    # an UNSAT inside the context gets its second opinion on the port
    before = fresh.crosscheck_runs + fresh.crosscheck_cap_skips
    unsat = _constraint_sets(port_smt)["unsat"]
    with port_model.detection_context():
        with pytest.raises(port_frontend.UnsatError):
            port_model.get_model(unsat, enforce_execution_time=False)
    checked = fresh.crosscheck_runs + fresh.crosscheck_cap_skips - before
    assert checked == (0 if env == "0" else 1)
