"""The port's bucketed batch path (backend.try_solve_batch_circuit with K3,
and the router's bucketed dispatch) on device "cpu", where K3's wrapper
runs its plain PyTorch version: the counterparts of tests/test_tpu_solver.py
and of the bucketed half of tests/test_batch_solver.py, with
MYTHRIL_GPU_RAGGED=0.

K3's randomness differs from the JAX package's (its counter hash against
threefry bits), so on the bench 64-bit queries, the 256-bit selector
dispatch and __graft_entry__'s example problems the port must solve every
query the JAX package solves at the same profile (restart lanes, steps,
caps); an UNSAT query is never solved, and every model passes the host
clause check.
"""

import pytest

import __graft_entry__ as ref_graft
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.tpu.backend import DeviceSolverBackend as RefBackend
from mythril_tpu_torch import graft
from mythril_tpu_torch.gpu import backend as backend_mod
from mythril_tpu_torch.gpu import circuit_kernel
from mythril_tpu_torch.gpu import router as router_mod
from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
from mythril_tpu_torch.smt.solver import sat_backend
from mythril_tpu_torch.smt.solver.frontend import Solver
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_mod
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import get_models_batch
from tests.test_tpu_solver import _bench_like_query as _ref_bench_query

FULL_CAPS = (4096, 1 << 22, 1 << 18)  # the reference tests' CPU overrides
sf = port_smt.symbol_factory


@pytest.fixture
def rounds(monkeypatch):
    """K3's rounds run (the wrapper counts only launches on a card)."""
    count = []
    real = circuit_kernel.run_round_circuit_kernel

    def counted(*a, **k):
        count.append(1)
        return real(*a, **k)

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel", counted)
    return count


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setattr(backend_mod, "_backends", {})
    model_mod.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield stats
    stats.reset()
    model_mod.clear_caches()
    args.reset()


def _bench_like_query(qi, bits=64):
    """tests/test_tpu_solver.py's query in the port: selector + guards +
    adder; every fifth one UNSAT."""
    data = sf.BitVecSym(f"cq_data_{qi}_{bits}", bits)
    value = sf.BitVecSym(f"cq_value_{qi}_{bits}", bits)
    sender = sf.BitVecSym(f"cq_sender_{qi}_{bits}", bits)
    solver = Solver()
    selector = 0x41C0E1B5 ^ (qi * 0x01010101)
    solver.add((data >> (bits - 32)) == (selector % (1 << 32)))
    solver.add(value < (1 << 40), sender != 0)
    if qi % 5 == 4:  # UNSAT lane
        solver.add(value + 1 > (1 << 41), value < (1 << 39))
    else:
        solver.add(value + data != sender)
    return solver._prepare([])


def _selector_dispatch_256(smt):
    data = smt.symbol_factory.BitVecSym("cq256_data", 256)
    value = smt.symbol_factory.BitVecSym("cq256_value", 256)
    sender = smt.symbol_factory.BitVecSym("cq256_sender", 256)
    balance = smt.symbol_factory.BitVecSym("cq256_balance", 256)
    return [smt.Extract(255, 224, data)
            == smt.symbol_factory.BitVecVal(0xAB125858, 32),
            smt.ULT(value, smt.symbol_factory.BitVecVal(1 << 40, 256)),
            sender != 0, balance + value != sender]


def _problems(preps):
    return [(p.num_vars, p.clauses, p.aig_roots) for p in preps]


def _solved(results):
    return [bits is not None for bits in results]


def test_try_solve_requires_circuit_and_rejects_assumptions(rounds):
    backend = DeviceSolverBackend(num_restarts=16, device="cpu")
    clauses = [(1, 2), (-1, 3)]
    assert backend.try_solve(3, clauses, budget_seconds=5.0) is None
    assert backend.try_solve(
        3, clauses, assumptions=[-2], budget_seconds=5.0) is None
    assert backend.batch_calls == 0 and not rounds


def test_try_solve_circuit_agrees_with_cdcl(rounds):
    backend = DeviceSolverBackend(num_restarts=16, device="cpu")
    solved = 0
    for qi in range(3):
        prep = _bench_like_query(qi)
        assert prep.trivial is None
        status, _ = sat_backend.solve_cnf(
            prep.num_vars, prep.clauses, allow_device=False)
        bits = backend.try_solve(prep.num_vars, prep.clauses,
                                 budget_seconds=30.0,
                                 aig_roots=prep.aig_roots)
        if bits is not None:
            assert status == sat_backend.SAT
            assert backend._honors(bits, prep.clauses)
            solved += 1
    assert solved >= 2
    assert rounds


@pytest.mark.parametrize("workload", ["bench64", "dispatch256", "graft"])
def test_port_solves_every_query_the_reference_solves(workload, rounds):
    """The same queries through both packages' try_solve_batch_circuit at
    the reference tests' profile: 16 restart lanes, 64 steps, full caps."""
    if workload == "bench64":
        ref_preps = [_ref_bench_query(qi) for qi in range(8)]
        preps = [_bench_like_query(qi) for qi in range(8)]
        unsat = {4}
    elif workload == "dispatch256":
        import mythril_tpu.smt as ref_smt
        from mythril_tpu.smt.solver.frontend import Solver as RefSolver

        ref_solver, solver = RefSolver(), Solver()
        ref_solver.add(*_selector_dispatch_256(ref_smt))
        solver.add(*_selector_dispatch_256(port_smt))
        ref_preps, preps = [ref_solver._prepare([])], [solver._prepare([])]
        unsat = set()
    else:
        ref_preps = ref_graft._example_problems()[0]
        preps = graft.example_problems()[0]
        unsat = set()
    want = _solved(RefBackend(num_restarts=16).try_solve_batch_circuit(
        _problems(ref_preps), budget_seconds=60.0, size_caps=FULL_CAPS,
        prefer_single_device=True))
    backend = DeviceSolverBackend(num_restarts=16, device="cpu")
    results = backend.try_solve_batch_circuit(
        _problems(preps), budget_seconds=60.0, size_caps=FULL_CAPS)
    for qi, (prep, bits) in enumerate(zip(preps, results)):
        if qi in unsat:
            assert bits is None, f"query {qi} is UNSAT, K3 claimed SAT"
            continue
        if want[qi]:
            assert bits is not None, f"query {qi}: the reference solved it"
        if bits is not None:
            assert DeviceSolverBackend._honors(bits, prep.clauses)
    assert rounds


def test_pack_and_ship_caches_hit_across_calls():
    backend = DeviceSolverBackend(num_restarts=16, device="cpu")
    problems = _problems([_bench_like_query(qi) for qi in range(2)])
    first = backend.try_solve_batch_circuit(
        problems, budget_seconds=60.0, size_caps=FULL_CAPS)
    assert backend.pack_misses == 2 and backend.pack_hits == 0
    ship_bytes = backend.ship_bytes
    assert ship_bytes > 0
    second = backend.try_solve_batch_circuit(
        problems, budget_seconds=60.0, size_caps=FULL_CAPS)
    assert backend.pack_hits == 2, "second call must reuse packed circuits"
    assert backend.ship_bytes == ship_bytes, "padded tables stay resident"
    for bits_a, bits_b in zip(first, second):
        assert (bits_a is None) == (bits_b is None)
    assert backend.solve_seconds > 0.0


def test_query_axis_pads_to_a_power_of_two(monkeypatch):
    """Three queries ride one launch of four slots; the zero slot reports
    found at step 0 and lands nowhere."""
    seen = []
    real = circuit_kernel.run_round_circuit_kernel

    def spy(tensors, x, *a, **k):
        seen.append(tuple(x.shape))
        return real(tensors, x, *a, **k)

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel", spy)
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    preps = [_bench_like_query(qi) for qi in range(3)]
    results = backend.try_solve_batch_circuit(
        _problems(preps), budget_seconds=60.0, size_caps=FULL_CAPS)
    assert seen and all(shape[:2] == (4, 8) for shape in seen)
    assert backend.padded_query_slots(3) == 4
    assert len(results) == 3


# -- get_models_batch through the bucketed router ---------------------------


def bv(name):
    return sf.BitVecSym(name, 64)


def val(x):
    return sf.BitVecVal(x, 64)


@pytest.fixture
def gpu_cpu(monkeypatch):
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "32")
    args.solver_backend = "gpu"
    args.torch_device = "cpu"


def test_batch_statuses_mixed(gpu_cpu):
    a = bv("ba")
    outcomes = get_models_batch([[a > val(5), a < val(100)],
                                 [a > val(5), a < val(3)], [a == a]])
    assert outcomes[0][0] == "sat"
    assert 5 < outcomes[0][1].eval_int(a) < 100
    assert outcomes[1][0] == "unsat"
    assert outcomes[2][0] == "sat"


def test_batch_rides_one_device_call(gpu_cpu, monkeypatch, fresh_state,
                                    rounds):
    """N same-shape device-worthy queries: exactly ONE bucketed dispatch
    at full production settings (evidence mode patched off), K3 launched,
    every model checked."""
    monkeypatch.setattr(router_mod.QueryRouter, "_evidence_mode",
                        lambda self: False)
    router = router_mod.get_router("cpu")
    router._rates["per_cell_s"] = 1e-12  # no cost reject on a slow host
    device = backend_mod.get_device_backend("cpu")
    calls = []
    real = device.try_solve_batch_circuit

    def spy(problems, **kwargs):
        calls.append(len(problems))
        return real(problems, **kwargs)

    monkeypatch.setattr(device, "try_solve_batch_circuit", spy)
    monkeypatch.setattr(device, "try_solve_batch_ragged", lambda *a, **k:
                        pytest.fail("the bucketed mode never goes ragged"))
    queries = []
    for i in range(6):
        a, b = bv(f"bqa{i}"), bv(f"bqb{i}")
        queries.append([a + b == val(1000 + i), a > val(400), b > val(400)])
    outcomes = get_models_batch(queries)
    assert calls == [6], "all sibling queries must ship in one batch"
    assert all(status == "sat" for status, _ in outcomes)
    for (_status, m), q in zip(outcomes, queries):
        assert m.satisfies(q)
    assert rounds and device.kernel_launches == 0
    assert fresh_state.device_slots == 8, "6 queries pad to 8 slots"


def test_tiny_cones_route_host_direct(gpu_cpu, monkeypatch, fresh_state):
    device = backend_mod.get_device_backend("cpu")
    calls = []
    monkeypatch.setattr(device, "try_solve_batch_circuit",
                        lambda problems, **k: calls.append(len(problems)))
    queries = []
    for i in range(4):
        x = bv(f"hd{i}")
        queries.append([x > val(i), x < val(i + 50)])
    outcomes = get_models_batch(queries)
    assert all(status == "sat" for status, _ in outcomes)
    assert calls == [], "tiny cones must not reach the device"
    assert fresh_state.router_host_direct == 4


def test_batch_device_unsat_falls_to_cdcl(gpu_cpu):
    x = bv("bu")
    outcomes = get_models_batch([[x > val(7), x < val(7)], [x == val(9)]])
    assert outcomes[0][0] == "unsat"
    assert outcomes[1][0] == "sat"
