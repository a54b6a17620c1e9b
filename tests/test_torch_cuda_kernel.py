"""The CUDA ragged round held against its plain PyTorch version on a card,
bit for bit (x and found are integers and bools: zero tolerance).

Marked `cuda`: these skip without a card. They import only the port (not
even the shared test helpers), so they run where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda_kernel.py -m cuda
"""

import random

import pytest
import torch

from mythril_tpu_torch.gpu import circuit, ragged_kernel
from mythril_tpu_torch.smt.bitblast import AIG
from mythril_tpu_torch.support.workloads import big_cone, random_cones

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: xdist workers must all
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README, PyTorch/CUDA port)")
    return torch.device("cuda", 0)


# lane_tile 2: a launch of 6 lanes leaves each cone's second block two
# idle warps
SMALL = ragged_kernel.KernelCaps(var_cap=4096, cone_cap=16, root_cap=16,
                                 lane_tile=2, cone_tile=4, block=32)


def _random_entries(seed, count):
    """Every third cone carries a pinned input, as cubes do."""
    return [(pc, ((1, bool(i % 2)),) if i % 3 else ())
            for i, pc in enumerate(random_cones(random.Random(seed), count))]


def _gate_free_cone():
    """A cone with no gate: its root is an input, asserted FALSE."""
    aig = AIG()
    return circuit.PackedCircuit(aig, [aig.lit_of_var(aig.new_var()) ^ 1])


def _assert_kernel_matches_plain(device, stream, caps, seed, lanes, steps):
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = circuit.init_inputs(gen, lanes, caps.var_cap, device)
    x[:, 0] = 1  # column 0 is not owned: both must return the input's
    before = ragged_kernel.launches
    got_x, got_found = ragged_kernel.run_round_ragged_kernel(
        flat, x, seed, steps, stream.num_levels + 4, caps)
    assert ragged_kernel.launches == before + 1
    want_x, want_found = ragged_kernel.run_round_ragged_plain(
        flat, x, seed, steps, stream.num_levels + 4, caps)
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_found, want_found)
    assert bool(got_x[:, 0].eq(1).all())
    return flat, got_found


@pytest.mark.parametrize("seed, cones, lanes, steps, gate_free", [
    (1, 5, 8, 24, False), (2, 16, 12, 64, False), (3, 9, 4, 0, False),
    (8, 7, 6, 40, True)])
def test_cuda_kernel_bit_identical_to_plain_round(cuda_device, seed, cones,
                                                  lanes, steps, gate_free):
    entries = _random_entries(seed, cones)
    if gate_free:
        entries.append((_gate_free_cone(), ()))
    _assert_kernel_matches_plain(cuda_device, circuit.RaggedStream(entries),
                                 SMALL, seed, lanes, steps)


@pytest.mark.parametrize("seed", [4, 5])
def test_cuda_kernel_var0_roots_match_plain_round(cuda_device, seed):
    """Two cones assert local var 0 (the constant FALSE) wanted TRUE: that
    root is violated at every step and its walk flips var 0, which the
    plain round undoes at the next simulate. No other cone may read the
    flipped value: every cone's check and walk sees var 0 as 0."""
    entries = [(pc, ((0, True),) if ci in (1, 2) else extra)
               for ci, (pc, extra) in enumerate(_random_entries(seed, 6))]
    _flat, found = _assert_kernel_matches_plain(
        cuda_device, circuit.RaggedStream(entries), SMALL, seed, 8, 48)
    assert not bool(found[:, 1:3].any()), "a var-0 root is never met"


@pytest.mark.parametrize("extra", [(), ((0, True),)])
def test_cuda_kernel_global_path_cone_matches_plain_round(cuda_device,
                                                          extra):
    """A cone too large for the kernel's shared-memory path takes its
    global-table path, in the same launch as two small cones; with
    `extra`, it also asserts local var 0 wanted TRUE."""
    caps = ragged_kernel.kernel_caps()
    stream = circuit.RaggedStream(
        [(big_cone(random.Random(6)), extra)] + _random_entries(7, 2))
    flat, _found = _assert_kernel_matches_plain(cuda_device, stream, caps,
                                                6, 8, 12)
    assert flat.cones.global_cones == (0,)


def test_router_dispatch_on_the_card_launches_the_kernel(cuda_device):
    """get_models_batch with the gpu backend on the card, pre-analysis on:
    the router calibrates K1, sends the window's components to it, and
    the models it finds satisfy their queries; verdicts equal the host
    CDCL's."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support import model
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.workloads import sibling_window

    model.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    try:
        queries = sibling_window(smt, 8, seed=3)
        host = [status for status, _m in model.get_models_batch(queries)]
        model.clear_caches()
        args.solver_backend = "gpu"
        args.torch_device = "cuda"
        before = ragged_kernel.launches
        results = model.get_models_batch(queries)
        assert ragged_kernel.launches > before
        assert stats.device_batch_hits > 0
        assert stats.aig_device_components > 0
        # K1 itself found models, not only the router's host settle
        assert stats.aig_device_component_hits > 0
        assert stats.router_device_found > 0
        assert [status for status, _m in results] == host
        for (status, found), constraints in zip(results, queries):
            if status == "sat":
                assert found.satisfies(constraints)
    finally:
        args.reset()
        model.clear_caches()
        stats.reset()


def test_cuda_kernel_mixed_origin_stream_matches_plain_round(cuda_device):
    """Cones of two contracts' AIGs (two generators, as two analyses'
    blasters) interleaved on one stream, as an interleaved corpus window
    sends them: bit for bit with the plain round."""
    first = random_cones(random.Random(21), 6)
    second = random_cones(random.Random(22), 6)
    entries = [(pc, ()) for pair in zip(first, second) for pc in pair]
    _assert_kernel_matches_plain(cuda_device, circuit.RaggedStream(entries),
                                 SMALL, 21, 8, 48)


def test_mixed_origin_window_on_the_card_matches_plain_round(cuda_device):
    """Two contracts' sibling queries in one get_models_batch call on the
    card, tagged by origin: a stream the router sends K1 mixes them
    (xcontract_windows), and K1 is bit for bit with its plain version on
    the largest stream it was sent."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.gpu.backend import get_device_backend
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support import model
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.workloads import sibling_window

    model.clear_caches()
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    kept = {}

    def keep(stream, entries):
        gates = sum(pc.num_gates for pc, _extra in entries)
        if gates > kept.get("gates", -1):
            kept.update(gates=gates, stream=stream)

    backend = get_device_backend("cuda")
    backend.on_stream = keep
    try:
        args.solver_backend = "gpu"
        args.torch_device = "cuda"
        queries = sibling_window(smt, 32, seed=5)
        model.get_models_batch(queries, origins=["0:a"] * 16 + ["1:b"] * 16)
        assert stats.xcontract_windows >= 1
        assert stats.xcontract_cones_packed >= 2
    finally:
        backend.on_stream = None
        args.reset()
        model.clear_caches()
        stats.reset()
    caps = ragged_kernel.kernel_caps()
    stream = kept["stream"]
    assert stream.v1 <= caps.var_cap and stream.cone_slots <= caps.cone_cap
    _assert_kernel_matches_plain(cuda_device, stream, caps, 9, 64, 64)
