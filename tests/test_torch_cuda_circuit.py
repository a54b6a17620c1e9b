"""K3, the bucketed path's per-query round, held against its plain
PyTorch version on a card, bit for bit (x and found are integers and
bools: zero tolerance).

Marked `cuda`: these skip without a card. They import only the port (not
even the shared test helpers), so they run where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda_circuit.py -m cuda
"""

import random

import pytest
import torch

from mythril_tpu_torch import graft
from mythril_tpu_torch.gpu import circuit_kernel
from mythril_tpu_torch.support.workloads import circuit_batch, deep_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: xdist workers must all
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README, PyTorch/CUDA port)")
    return torch.device("cuda", 0)


def _assert_kernel_matches_plain(device, batch, seed, lanes, steps):
    tensors = circuit_kernel.device_batch(batch, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q_count, _levels, _width = batch["out_idx"].shape
    v1 = batch["ga_var"].shape[1]
    x = torch.randint(0, 2, (q_count, lanes, v1), generator=gen,
                      device=device, dtype=torch.int32)
    walk = batch["out_idx"].shape[1] + 4
    before = circuit_kernel.launches
    got_x, got_found = circuit_kernel.run_round_circuit_kernel(
        tensors, x, seed, steps, walk)
    assert circuit_kernel.launches == before + 1
    want_x, want_found = circuit_kernel.run_round_circuit_plain(
        tensors, x, seed, steps, walk)
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_found, want_found)
    return got_found


@pytest.mark.parametrize("seed, lanes, steps", [
    (1, 8, 24), (2, 64, 64), (3, 5, 0), (4, 13, 40), (5, 1, 16)])
def test_cuda_circuit_round_bit_identical_to_plain(cuda_device, seed, lanes,
                                                   steps):
    batch = circuit_batch(random.Random(seed))
    found = _assert_kernel_matches_plain(cuda_device, batch, seed, lanes,
                                         steps)
    live = batch["root_mask"].sum(axis=1) > 0
    # the query axis's padding slots report found at step 0
    assert bool(found[torch.as_tensor(~live)].all())


def test_cuda_circuit_round_global_x_path(cuda_device):
    """A batch whose x passes shared memory even at 8 lanes a word keeps
    x's words in global memory (the global tier): the same results."""
    batch = circuit_batch(random.Random(7), max_queries=3, min_v1=200000)
    layout = circuit_kernel.circuit_layout(
        circuit_kernel.device_batch(batch, "cpu"))
    assert circuit_kernel.launch_shape(
        batch["ga_var"].shape[1], layout.stride).tier == "global"
    _assert_kernel_matches_plain(cuda_device, batch, 7, 4, 16)


# (deep_cone arguments, least V1, tier, lanes a word): every layout tier,
# the shared32 stream both resident and in the ring
TIERS = {
    "shared32": ({"gates": 4000, "reach": 256}, 0, "shared32", 32),
    "shared32-ring": ({"gates": 4000, "reach": 16}, 0, "shared32", 32),
    "shared16": ({"gates": 4000, "reach": 16}, 20000, "shared16", 16),
    "xshared32": ({"gates": 4000, "reach": 16}, 40000, "xshared", 32),
    "xshared16": ({"gates": 4000, "reach": 16}, 80000, "xshared", 16),
    "xshared8": ({"gates": 4000, "reach": 16}, 150000, "xshared", 8),
    "global": ({"gates": 4000, "reach": 16}, 213000, "global", 32),
}


@pytest.mark.parametrize("lanes", [1, 31, 33, 64, 96])
@pytest.mark.parametrize("case", sorted(TIERS))
def test_cuda_circuit_round_tiers_bit_identical(cuda_device, case, lanes):
    cone, min_v1, tier, width = TIERS[case]
    batch = deep_batch(random.Random(len(case)), min_v1=min_v1, **cone)
    layout = circuit_kernel.circuit_layout(
        circuit_kernel.device_batch(batch, "cpu"))
    shape = circuit_kernel.launch_shape(batch["ga_var"].shape[1],
                                        layout.stride)
    assert (shape.tier, shape.lanes_per_word) == (tier, width)
    if case.startswith("shared32"):
        assert shape.resident == (case == "shared32")
    found = _assert_kernel_matches_plain(cuda_device, batch, lanes, lanes, 6)
    assert bool(found[-1].all()), "the padding slot is found at step 0"


def test_graft_entry_runs_on_the_card(cuda_device):
    fn, args = graft.entry()
    x, found = fn(*args)
    torch.cuda.synchronize()
    want_x, want_found = circuit_kernel.run_round_circuit_plain(
        args[0], args[1], args[2], graft.STEPS_PER_ROUND,
        int(args[0]["out_idx"].shape[1]) + 4)
    assert torch.equal(x, want_x) and torch.equal(found, want_found)
    assert bool(found.any(dim=1).all()), "every example query solved"
