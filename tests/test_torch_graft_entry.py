"""mythril_tpu_torch.graft.entry, the twin of __graft_entry__.entry: one K3
round on the 4-query, 8-restart example batch. On the CPU it runs K3's
plain version and must solve all four queries, each model passing the
host clause check; with no device named and no card it raises."""

import pytest
import torch

from mythril_tpu_torch import graft
from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
from mythril_tpu_torch.gpu.device import NoDeviceError


def test_entry_runs_on_the_cpu_and_solves_the_example_queries():
    fn, args = graft.entry(device="cpu")
    x, found = fn(*args)
    assert tuple(x.shape[:2]) == tuple(found.shape) == (
        graft.QUERIES, graft.RESTARTS)
    assert bool(found.any(dim=1).all()), "every example query solved"
    preps, packed, _batch, _levels, _v1 = graft.example_problems()
    for qi, (prep, pc) in enumerate(zip(preps, packed)):
        lane = int(torch.nonzero(found[qi])[0])
        dense = prep.aig_roots[2] if len(prep.aig_roots) > 2 else None
        bits = DeviceSolverBackend.bits_from_circuit_assignment(
            pc, dense, prep.num_vars, x[qi, lane].numpy())
        assert DeviceSolverBackend._honors(bits, prep.clauses), qi
    # the same arguments: the same round
    again_x, again_found = fn(*args)
    assert torch.equal(again_x, x) and torch.equal(again_found, found)


def test_entry_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(NoDeviceError):
        graft.entry()
