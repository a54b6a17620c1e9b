"""The port's device backend (mythril_tpu_torch/gpu/backend.py) on the CPU
against the brute-force oracle of tests/test_pallas_kernel.py.

The 300 oracle-labeled entries (plain cones, cube replicas, fork carry
pins, SAT and UNSAT) are blasted by the JAX package and handed to the port
as numpy arrays through problem_from_arrays. Windows of 60 entries run
through try_solve_batch_ragged on device="cpu" (the plain round): within
MAX_ROUNDS calls the found set must equal the oracle's SAT set exactly,
and every model must honor its CNF (pins included).
"""

import numpy as np
import pytest

from mythril_tpu.tpu.backend import DeviceSolverBackend as RefBackend
from mythril_tpu_torch.gpu import ragged_kernel
from mythril_tpu_torch.gpu.backend import (
    DeviceSolverBackend,
    problem_from_arrays,
    shape_bucket,
)
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from tests.test_pallas_kernel import (
    MAX_ROUNDS,
    TOTAL_ENTRIES,
    WINDOW,
    _build_entries,
    _pin_lits,
)
from tests.torch_helpers import port_packed


@pytest.fixture(autouse=True)
def small_kernel(monkeypatch):
    # small capacities keep the plain round fast on the CPU; the windows
    # here fit them with room to spare
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "8192")
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    yield
    stats.reset()


def _problem(entry, cache):
    ref_pc, extra, aig, roots, pins, _sat = entry
    # the CNF asserts the pins too, so the host clause check covers them
    num_vars, cnf, dense = aig.to_cnf(roots + _pin_lits(ref_pc, pins))
    lhs, rhs = aig.gate_arrays()
    problem = problem_from_arrays(num_vars, cnf.lits, cnf.offsets, lhs, rhs,
                                  roots, dense.arr)
    pc = port_packed(ref_pc, aig, roots, cache)
    return problem, pc, extra


def test_found_set_equals_bruteforce_oracle():
    entries = _build_entries()
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    cache = {}
    for wi in range(0, TOTAL_ENTRIES, WINDOW):
        window = entries[wi: wi + WINDOW]
        prepared = [_problem(entry, cache) for entry in window]
        expected = np.array([entry[5] for entry in window])
        # a root set that strashing folded to TRUE has no variables: the
        # frontend settles it as trivially SAT and the backend skips it
        found = np.array([problem[0] == 0 for problem, _pc, _e in prepared])
        assert expected[found].all()
        for _round in range(MAX_ROUNDS):
            todo = [i for i in range(len(window)) if not found[i]]
            results = backend.try_solve_batch_ragged(
                [prepared[i][0] for i in todo], budget_seconds=60.0,
                packed_hint=[prepared[i][1] for i in todo],
                extra_roots=[prepared[i][2] for i in todo])
            for i, bits in zip(todo, results):
                if bits is None:
                    continue
                problem = prepared[i][0]
                assert backend._honors(bits, problem[1]), (wi, i)
                assert expected[i], ("a model for an UNSAT entry", wi, i)
                found[i] = True
            if (found == expected).all():
                break
        assert (found == expected).all(), (
            wi, np.nonzero(found != expected)[0])
    stats = backend.stats()
    assert stats["kernel_launches"] > 0
    assert stats["kernel_backend"] == "pallas"
    # the plain version never counts as a launch of the CUDA kernel
    assert ragged_kernel.launches == 0


def test_stats_keys_match_the_reference_backend():
    ref_keys = set(RefBackend().stats())
    renamed = {key.replace("pallas_", "kernel_") for key in ref_keys}
    assert set(DeviceSolverBackend(device="cpu").stats()) == renamed


def test_window_is_chunked_to_capacities_and_oversize_cones_rejected(
        monkeypatch):
    """The router (gpu/router.py) closes a stream where the next cone would
    push the combined variable space past var_cap; a cone that alone
    exceeds it is no cap reject: it rides K2 in a stream of its own, and
    its model is found there. (The name dates from before K2, when such a
    cone was rejected; it is kept so that the test's history reads on.)"""
    from mythril_tpu_torch.gpu import router as router_mod

    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    # these random cones are shallow (one has no gate at all): none may
    # take the host shortcut
    monkeypatch.setenv("MYTHRIL_GPU_HOST_DIRECT_LEVELS", "-1")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "100")
    monkeypatch.setenv("MYTHRIL_GPU_DEVICE_DEADLINE", "60")
    entries = [e for e in _build_entries() if e[5] and not e[4]][:12]
    cache = {}
    prepared = [_problem(entry, cache) for entry in entries]
    prepared = [item for item in prepared if item[0][0] > 0]
    problems = [p for p, _pc, _e in prepared]
    sizes = [pc.v1 - 1 for _p, pc, _e in prepared]
    var_cap = 1 + 3 * max(sizes)  # about three cones per stream
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", str(var_cap))
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    router = router_mod.QueryRouter(backend)
    chunks = router._chunk_ragged(
        [router_mod._Unit(i, None, pc, p)
         for i, (p, pc, _e) in enumerate(prepared)],
        ragged_kernel.kernel_caps())
    assert len(chunks) > 1
    assert [unit.qi for chunk in chunks for unit in chunk] == \
        list(range(len(prepared)))
    for chunk, following in zip(chunks, chunks[1:] + [None]):
        used = 1 + sum(unit.pc.v1 - 1 for unit in chunk)
        assert used <= var_cap
        if following is not None:  # greedy: the next cone did not fit
            assert used + following[0].pc.v1 - 1 > var_cap
    results = router.dispatch(problems, timeout_s=60.0)
    assert backend.stats()["ragged_windows"] == len(chunks)
    assert all(bits is not None for bits in results)

    # a cone past the var capacity alone is no cap reject: it rides K2 in
    # a chunk of its own
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", str(max(sizes)))
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    router = router_mod.QueryRouter(backend)
    too_big = [1 + size > max(sizes) for size in sizes]
    assert any(too_big)
    chunks = router._chunk_ragged(
        [router_mod._Unit(i, None, pc, p)
         for i, (p, pc, _e) in enumerate(prepared)],
        ragged_kernel.kernel_caps())
    assert [unit.qi for chunk in chunks for unit in chunk] == \
        list(range(len(prepared)))
    for chunk in chunks:
        big = [too_big[unit.qi] for unit in chunk]
        assert not any(big) or big == [True]
    results = router.dispatch(problems, timeout_s=60.0)
    assert backend.stats()["cap_rejects"] == 0
    assert backend.stats()["ragged_windows"] == len(chunks)
    assert all(bits is not None for bits in results)
    assert SolverStatistics().cap_rejects == 0


def test_no_device_named_and_no_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSolverBackend()


def test_window_over_a_capacity_raises_instead_of_falling_back(
        monkeypatch):
    """A window past one of K1's capacities no longer raises: it falls
    back to K2 over the stream padded to its shape bucket, as mythril_tpu
    falls back to its XLA round (tpu/backend.py:811-818), and every model
    passes the host clause check. K1 never launches. (The name dates from
    before K2, when such a window raised; it is kept so that the test's
    history reads on.)"""
    entries = [e for e in _build_entries() if e[5] and not e[4]][:4]
    cache = {}
    prepared = [_problem(entry, cache) for entry in entries]
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    monkeypatch.setenv("MYTHRIL_GPU_RAGGED_VAR_CAP", "8")
    streams = []
    backend.on_stream = lambda stream, _entries: streams.append(stream)
    problems = [p for p, _pc, _e in prepared]
    results = backend.try_solve_batch_ragged(
        problems, budget_seconds=60.0,
        packed_hint=[pc for _p, pc, _e in prepared])
    assert streams and all(stream.v1 == shape_bucket(stream.v1)
                           for stream in streams)
    assert all(bits is not None and backend._honors(bits, problem[1])
               for bits, problem in zip(results, problems))
    stats = backend.stats()
    assert stats["kernel_launches"] == 0 and stats["cells_stepped"] > 0


def test_cube_pass_settles_a_missed_cone(monkeypatch):
    """A cone the plain rounds miss gets the cube-and-conquer second pass
    inside the same call (forced here: the plain stream returns empty),
    and a cube's model settles the query."""
    entry = next(e for e in _build_entries() if e[5] and not e[4]
                 and e[0].num_levels >= 2)
    problem, pc, _extra = _problem(entry, {})
    backend = DeviceSolverBackend(num_restarts=8, device="cpu")
    real_solve = backend._solve_ragged_stream
    calls = []

    def miss_first(entries, deadline, num_restarts, steps, **kwargs):
        calls.append(len(entries))
        if len(calls) == 1:
            return {}, 0, True  # the plain pass: a forced miss
        return real_solve(entries, deadline, num_restarts, steps, **kwargs)

    monkeypatch.setattr(backend, "_solve_ragged_stream", miss_first)
    results = backend.try_solve_batch_ragged(
        [problem], budget_seconds=60.0, steps=96, packed_hint=[pc],
        cube_vars=2, cube_min_levels=0)
    assert calls[:2] == [1, 4], "2^2 cube replicas ride the second stream"
    assert backend.stats()["cubes_dispatched"] == 4
    assert SolverStatistics().cubes_dispatched == 4
    assert results[0] is not None and backend._honors(results[0], problem[1])
