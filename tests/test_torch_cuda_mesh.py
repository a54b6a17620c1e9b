"""K4, the bucketed round sharded over a dp x mp mesh, on a card: a virtual
2 x 2 mesh (four shards on cuda:0) and, where four cards are visible, a
2 x 2 mesh of one shard a card. Each shard's launch of K3 is held bit for
bit against the plain round on its slice with its folded seed, and solved
against found.any over mp (integers and bools: zero tolerance).

Marked `cuda`: these skip without a card. They import only the port, so
they run where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda_mesh.py -m cuda
"""

import random

import numpy as np
import pytest
import torch

from mythril_tpu_torch.gpu import circuit, circuit_kernel
from mythril_tpu_torch.gpu.device import mesh_over
from mythril_tpu_torch.support.workloads import circuit_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: xdist workers must all
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README, PyTorch/CUDA port)")
    return torch.device("cuda", 0)


def _even(batch):
    """The batch with an all-zero query slot appended when its slot count
    is odd (one query), so that it splits over dp 2."""
    if batch["out_idx"].shape[0] % 2 == 0:
        return batch
    return {key: np.concatenate([value, np.zeros_like(value[:1])])
            for key, value in batch.items()}


def _hold(mesh, batch, seed, lanes, steps):
    lead = mesh.lead
    tensors = circuit_kernel.device_batch(batch, lead)
    gen = torch.Generator(device=lead)
    gen.manual_seed(seed)
    q_count = batch["out_idx"].shape[0]
    v1 = batch["ga_var"].shape[1]
    x = torch.randint(0, 2, (q_count, lanes, v1), generator=gen,
                      device=lead, dtype=torch.int32)
    walk = batch["out_idx"].shape[1] + 4
    before = circuit_kernel.launches
    xs, founds, solved = circuit.make_sharded_round(mesh, steps, walk)(
        circuit.shard_tables(mesh, tensors), circuit.shard_lanes(mesh, x),
        seed)
    assert circuit_kernel.launches == before + mesh.size
    qs, rs = q_count // mesh.dp, lanes // mesh.mp
    for i in range(mesh.dp):
        for j in range(mesh.mp):
            device = mesh.shard(i, j)
            block = {key: value[i * qs:(i + 1) * qs].to(device)
                     for key, value in tensors.items()}
            want_x, want_found = circuit_kernel.run_round_circuit_plain(
                block, x[i * qs:(i + 1) * qs, j * rs:(j + 1) * rs]
                .to(device).contiguous(),
                circuit.shard_seed(seed, i * 7919 + j), steps, walk)
            torch.cuda.synchronize(device)
            assert torch.equal(xs.block(i, j), want_x), (i, j)
            assert torch.equal(founds.block(i, j), want_found), (i, j)
    assert torch.equal(solved, founds.gather().any(dim=1))


@pytest.mark.parametrize("seed, lanes, steps", [
    (1, 8, 24), (2, 64, 64), (3, 2, 0), (4, 34, 40)])
def test_k4_on_a_virtual_mesh_bit_identical_per_shard(cuda_device, seed,
                                                      lanes, steps):
    mesh = mesh_over([cuda_device] * 4)
    _hold(mesh, _even(circuit_batch(random.Random(seed))), seed, lanes,
          steps)


def test_k4_one_shard_a_card(cuda_device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    mesh = mesh_over([torch.device("cuda", k) for k in range(4)])
    assert not mesh.virtual
    _hold(mesh, _even(circuit_batch(random.Random(7))), 7, 16, 32)
