"""graft.dryrun_multichip, the twin of __graft_entry__.dryrun_multichip: the
production bucketed solver over a virtual 2 x 2 mesh on the CPU (four
shards on one device, the part the reference's forced 8-device CPU
platform plays), on the 256-bit queries of a real in-process analyze.

Leg 1 must solve the shallow analyze cones with host-checked models, every
round through K4 (each of the four shards launching the round on its own
block). Rounds are shrunk through the backend as the reference's dryrun
shrinks them (8 restart lanes, 32 steps); the cones are not. Without
`virtual` and without the cards, the dryrun raises: it never places its
shards on one device unasked."""

import pytest
import torch

from mythril_tpu_torch import graft
from mythril_tpu_torch.gpu import circuit_kernel


def test_leg_one_solves_production_cones_on_a_virtual_mesh(monkeypatch):
    shapes = []
    original = circuit_kernel.run_round_circuit_kernel

    def record(tensors, x, seed, steps, walk_depth, layout=None):
        shapes.append(tuple(x.shape))
        return original(tensors, x, seed, steps, walk_depth, layout=layout)

    monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel", record)
    summary = graft.dryrun_multichip(4, device="cpu", virtual=True,
                                     deep=False)
    assert (summary["dp"], summary["mp"]) == (2, 2)
    assert summary["placement"] == "virtual: 4 shards on cpu"
    assert summary["solved"] >= 2
    assert summary["batch_sat"] == summary["solved"]
    assert all(levels <= graft.SHALLOW_LEVELS
               for levels in summary["solved_levels"])
    # production shape: 256-bit analyze cones hundreds of levels deep
    assert min(summary["solved_levels"]) > 256
    assert summary["deep_executed"] == 0
    # every round is K4: four shard launches of 1 slot x 4 lanes
    assert shapes and len(shapes) % 4 == 0
    assert {shape[:2] for shape in shapes} == {(1, 4)}
    assert summary["flips"] == len(shapes) // 4 * 2 * 8 * 32


def test_the_dryrun_never_places_a_mesh_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 8 CUDA cards"):
        graft.dryrun_multichip(8)
    with pytest.raises(ValueError, match="virtual=True"):
        graft.dryrun_multichip(4, device="cpu")
