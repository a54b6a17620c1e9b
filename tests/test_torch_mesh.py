"""K4, the bucketed round sharded over a dp x mp mesh (gpu/device.Mesh,
gpu/circuit.make_sharded_round), and the mesh branch of the bucketed path
(gpu/backend.try_solve_batch_circuit), held against the JAX package
(mythril_tpu/tpu/circuit.py:631-669, mythril_tpu/tpu/backend.py:367-566)
on the CPU.

- The mesh rule (mesh_over) equals the reference's for 1-8 devices, and
  the reference backend's own mesh over the tier-1 platform's 8 CPU
  devices (tests/conftest.py) is the 4 x 2 the port builds over 8.
- padded_query_slots equals the reference's _pow2_slots.
- On a 2 x 2 virtual CPU mesh, every shard's (x, found) equals the plain
  round on its slice of the queries and lanes with its folded seed, and
  solved equals found.any over the mp shards: exact.
- The found mask equals the brute-force oracle of tests/test_ragged.py,
  and every model passes the host re-check.
- The backend's mesh branch: models host-checked, its counters by the
  reference's formulas, the restart lanes rounded up to a multiple of mp,
  and prefer_single_device padding from 1. The router's evidence profile
  passes prefer_single_device=True.

Every comparison is integer or boolean and exact."""

import jax
import numpy as np
import pytest
import torch

from mythril_tpu.tpu import backend as ref_backend
from mythril_tpu_torch import graft
from mythril_tpu_torch.gpu import circuit, circuit_kernel
from mythril_tpu_torch.gpu.backend import DeviceSolverBackend
from mythril_tpu_torch.gpu.device import Mesh, mesh_over
from tests.test_ragged import _eval_root
from tests.test_torch_circuit_kernel import _batch, _cones

STEPS = 32
LANES = 8
ROUNDS = 4


def _reference_shape(n):
    """The reference's rule (mythril_tpu/tpu/backend.py:384-387)."""
    mp = 2 if n % 2 == 0 else 1
    return {"dp": n // mp, "mp": mp}


@pytest.mark.parametrize("count", range(1, 9))
def test_mesh_over_follows_the_reference_rule(count):
    devices = ["cpu"] * count
    mesh = mesh_over(devices)
    assert mesh.shape == _reference_shape(count)
    assert len(mesh.devices) == mesh.dp * mesh.mp
    assert mesh.virtual == (mesh.size > 1)
    for i in range(mesh.dp):
        for j in range(mesh.mp):
            assert mesh.shard(i, j) == torch.device("cpu")
    with pytest.raises(IndexError):
        mesh.shard(mesh.dp, 0)


def test_mesh_checks_its_grid():
    with pytest.raises(ValueError):
        mesh_over([])
    with pytest.raises(ValueError):
        Mesh((torch.device("cpu"),) * 3, 2, 2)


def test_the_reference_backend_meshes_the_eight_cpu_devices_as_the_port():
    assert len(jax.devices()) == 8
    reference = ref_backend.DeviceSolverBackend(num_restarts=8)
    shape = dict(reference._get_mesh(jax).shape)
    assert shape == {"dp": 4, "mp": 2}
    port = DeviceSolverBackend(num_restarts=8, device="cpu",
                               mesh_devices=["cpu"] * 8)
    assert port._get_mesh().shape == shape


@pytest.mark.parametrize("count,dp", [(1, 1), (4, 2), (8, 4)])
def test_padded_query_slots_equal_the_reference(count, dp):
    backend = DeviceSolverBackend(device="cpu", mesh_devices=["cpu"] * count)
    assert backend._get_mesh().dp == dp
    for n in range(18):
        assert backend.padded_query_slots(n) == ref_backend._pow2_slots(dp, n)
        assert backend.padded_query_slots(n, single_device=True) == \
            ref_backend._pow2_slots(1, n)


def test_the_default_mesh_on_the_cpu_is_one_by_one():
    backend = DeviceSolverBackend(device="cpu")
    assert backend._get_mesh().shape == {"dp": 1, "mp": 1}


def test_a_named_card_confines_the_mesh_to_it(monkeypatch):
    """With no mesh_devices, a card named by its index (`--torch-device
    cuda:1`) gets a 1 x 1 mesh on it; no device named, or "cuda", spans
    every visible card (the reference's one controller over them all).
    Four cards are faked: the mesh is built, nothing launches."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", k) for k in range(4)]
    for k in (0, 1, 3):
        mesh = DeviceSolverBackend(device=f"cuda:{k}")._get_mesh()
        assert mesh.shape == {"dp": 1, "mp": 1}
        assert mesh.devices == (torch.device("cuda", k),)
        assert DeviceSolverBackend(
            device=torch.device("cuda", k))._get_mesh().size == 1
    for device in (None, "cuda"):
        mesh = DeviceSolverBackend(device=device)._get_mesh()
        assert mesh.shape == {"dp": 2, "mp": 2}
        assert list(mesh.devices) == cards
    # mesh_devices wins over a named card
    assert DeviceSolverBackend(device="cuda:1", mesh_devices=cards[:2]) \
        ._get_mesh().shape == {"dp": 1, "mp": 2}
    # the process's backend of a named card keeps the named rule
    from mythril_tpu_torch.gpu import backend as port_backend

    monkeypatch.setattr(port_backend, "_backends", {})
    assert port_backend.get_device_backend("cuda:2")._get_mesh().size == 1
    assert port_backend.get_device_backend(None)._get_mesh().size == 4


def test_shard_seed_is_pinned():
    """The fold of a shard id into a round's seed (circuit.shard_seed):
    hash32(seed ^ hash32(shard_id + C_SHARD)) cut to 31 bits. Pinned, so
    a change to it is a change to every K4 round's lanes."""
    assert circuit.SHARD_DP_STRIDE == 7919
    assert [circuit.shard_seed(5, i * 7919 + j)
            for i in range(2) for j in range(2)] == [
        575277660, 258130469, 1320552991, 1744257707]
    assert circuit.shard_seed(0, 0) == 1616512399
    assert circuit.shard_seed(0x7FFFFFFF, 7919 * 3 + 1) == 1538452333
    folds = {circuit.shard_seed(11, i * 7919 + j)
             for i in range(4) for j in range(2)}
    assert len(folds) == 8 and all(0 <= f < 1 << 31 for f in folds)


def _example_batch(seed=3):
    _preps, packed, batch, levels, v1 = graft.example_problems(4)
    tensors = circuit_kernel.device_batch(batch, "cpu")
    x = torch.as_tensor(np.random.RandomState(seed).randint(
        0, 2, (4, LANES, v1)), dtype=torch.int32)
    return tensors, x, levels


def _hold_per_shard(mesh, tensors, x, seed, steps, walk_depth):
    """One K4 round, each shard held against the plain round on its
    slice with its folded seed; solved against found.any over mp."""
    xs, founds, solved = circuit.make_sharded_round(
        mesh, steps, walk_depth)(circuit.shard_tables(mesh, tensors),
                                 circuit.shard_lanes(mesh, x), seed)
    qs, rs = x.shape[0] // mesh.dp, x.shape[1] // mesh.mp
    for i in range(mesh.dp):
        for j in range(mesh.mp):
            block = {key: value[i * qs:(i + 1) * qs]
                     for key, value in tensors.items()}
            want_x, want_found = circuit_kernel.run_round_circuit_plain(
                block, x[i * qs:(i + 1) * qs, j * rs:(j + 1) * rs]
                .contiguous(), circuit.shard_seed(seed, i * 7919 + j),
                steps, walk_depth)
            assert torch.equal(xs.block(i, j), want_x), (i, j)
            assert torch.equal(founds.block(i, j), want_found), (i, j)
    found = founds.gather()
    assert found.shape == x.shape[:2]
    assert xs.gather().shape == x.shape
    assert torch.equal(solved, found.any(dim=1))
    return xs, founds, solved


@pytest.mark.parametrize("seed", [1, 7])
def test_each_shard_equals_the_plain_round_on_its_slice(seed):
    tensors, x, levels = _example_batch(seed)
    mesh = mesh_over(["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "mp": 2}
    xs, founds, solved = _hold_per_shard(mesh, tensors, x, seed, 8,
                                         levels + 4)
    # a slot's row is its whole lane axis, joined across the mp shards
    for slot in range(x.shape[0]):
        assert torch.equal(xs.row(slot), xs.gather()[slot])
        assert torch.equal(founds.row(slot), founds.gather()[slot])
        assert bool(founds.row(slot).any()) == bool(solved[slot])
    # a shard's seed is its own: the same lanes under the unfolded seed
    # (K3 over the whole batch) give another round
    whole_x, _found = circuit_kernel.run_round_circuit_plain(
        tensors, x, seed, 8, levels + 4)
    assert not torch.equal(whole_x, xs.gather())


def test_a_one_by_one_mesh_is_k3_with_the_shard_zero_seed():
    tensors, x, levels = _example_batch(5)
    mesh = mesh_over(["cpu"])
    xs, founds, solved = _hold_per_shard(mesh, tensors, x, 9, 8, levels + 4)
    want_x, want_found = circuit_kernel.run_round_circuit_plain(
        tensors, x, circuit.shard_seed(9, 0), 8, levels + 4)
    assert torch.equal(xs.gather(), want_x)
    assert torch.equal(founds.gather(), want_found)


def test_sharding_checks_its_shapes():
    tensors, x, levels = _example_batch()
    mesh = mesh_over(["cpu"] * 8)  # dp 4: 4 slots split, 8 lanes split
    fn = circuit.make_sharded_round(mesh, 0, levels + 4)
    fn(circuit.shard_tables(mesh, tensors), circuit.shard_lanes(mesh, x), 1)
    with pytest.raises(ValueError):
        circuit.shard_lanes(mesh, x[:, :7].contiguous())  # 7 over mp 2
    with pytest.raises(ValueError):
        circuit.shard_tables(mesh_over(["cpu"] * 6), tensors)  # dp 3


@pytest.mark.parametrize("seed", range(12))
def test_found_mask_equals_the_bruteforce_oracle(seed):
    """Random small cones (tests/test_ragged.py _random_cone; an odd seed
    makes one UNSAT for certain) on a 2 x 2 mesh: every SAT cone solved
    within ROUNDS rounds, no UNSAT cone ever, every found lane a model of
    its roots, every shard held to the plain round each round."""
    cones = _cones(seed)
    batch, tensors = _batch(cones, 4)
    levels, v1 = batch["out_idx"].shape[1], batch["ga_var"].shape[1]
    sat = np.array([cone[4] for cone in cones] + [True])
    mesh = mesh_over(["cpu"] * 4)
    rng = np.random.RandomState(seed)
    ever = np.zeros((4,), dtype=bool)
    for round_index in range(ROUNDS):
        x = torch.as_tensor(rng.randint(0, 2, (4, LANES, v1)),
                            dtype=torch.int32)
        xs, founds, solved = _hold_per_shard(
            mesh, tensors, x, seed * 1000 + round_index, STEPS, levels + 4)
        x_all, found = xs.gather(), founds.gather()
        ever |= solved.numpy()
        for qi, (aig, roots, ref_pc, _port, _sat) in enumerate(cones):
            for lane in np.nonzero(found[qi].numpy())[0]:
                row = x_all[qi, lane].numpy()
                assignment = {int(gvar): bool(row[lvar]) for lvar, gvar
                              in enumerate(ref_pc.var_map) if lvar > 0}
                assert all(_eval_root(aig, assignment, root)
                           for root in roots), (qi, lane)
        if (ever >= sat).all():
            break
    assert list(ever) == list(sat)


def _example_queries():
    preps = graft.example_problems(4)[0]
    return preps, [(p.num_vars, p.clauses, p.aig_roots) for p in preps]


class _Recorder:
    """Wraps circuit_kernel.run_round_circuit_kernel: the x shapes and
    the devices of every launch."""

    def __init__(self, monkeypatch):
        self.shapes = []
        original = circuit_kernel.run_round_circuit_kernel

        def record(tensors, x, seed, steps, walk_depth, layout=None):
            self.shapes.append(tuple(x.shape))
            return original(tensors, x, seed, steps, walk_depth,
                            layout=layout)

        monkeypatch.setattr(circuit_kernel, "run_round_circuit_kernel",
                            record)


@pytest.mark.parametrize("restarts", [7, 8])
def test_the_mesh_branch_solves_with_the_reference_formulas(monkeypatch,
                                                            restarts):
    preps, problems = _example_queries()
    backend = DeviceSolverBackend(num_restarts=restarts, device="cpu",
                                  mesh_devices=["cpu"] * 4)
    backend.CIRCUIT_STEPS = 16
    launches = _Recorder(monkeypatch)
    results = backend.try_solve_batch_circuit(
        problems[:3], budget_seconds=120.0,
        size_caps=graft.DRYRUN_CAPS)
    assert all(bits is not None for bits in results)
    for bits, prep in zip(results, preps):
        assert DeviceSolverBackend._honors(bits, prep.clauses)
    stats = backend.stats()
    # 3 queries over dp 2: 4 slots; the lanes rounded up to mp's multiple
    lanes = 8
    rounds = len(launches.shapes) // 4
    assert len(launches.shapes) == 4 * rounds and rounds >= 1
    assert set(launches.shapes) == {(2, lanes // 2, launches.shapes[0][2])}
    pcs = [circuit.PackedCircuit(p.aig_roots[0], p.aig_roots[1])
           for p in preps[:3]]
    n_levels = ref_backend.shape_bucket(max(pc.num_levels for pc in pcs))
    width = ref_backend.shape_bucket(max(pc.max_width for pc in pcs))
    assert stats["flips"] == rounds * 4 * lanes * 16
    assert stats["cells_stepped"] == rounds * 4 * 16 * 2 * n_levels * width
    assert stats["batch_queries"] == 3
    assert stats["batch_sat"] == 3


def test_prefer_single_device_pads_from_one(monkeypatch):
    preps, problems = _example_queries()
    backend = DeviceSolverBackend(num_restarts=7, device="cpu",
                                  mesh_devices=["cpu"] * 8)
    backend.CIRCUIT_STEPS = 16
    launches = _Recorder(monkeypatch)
    results = backend.try_solve_batch_circuit(
        problems[:1], budget_seconds=120.0, size_caps=graft.DRYRUN_CAPS,
        prefer_single_device=True)
    assert results[0] is not None
    # one launch a round over the whole batch: 1 slot, 7 lanes unrounded
    assert {shape[:2] for shape in launches.shapes} == {(1, 7)}
    assert backend.stats()["flips"] == len(launches.shapes) * 1 * 7 * 16


def test_the_mesh_redraws_the_whole_axis_first_half():
    """Between rounds the first half of the WHOLE lane axis is re-drawn
    for unsolved queries, across shard boundaries (reference
    backend.py:605-621)."""
    from mythril_tpu_torch.gpu.backend import _redraw_sharded

    mesh = mesh_over(["cpu"] * 8)  # 4 x 2
    x = torch.zeros((4, 6, 3), dtype=torch.int32)
    grid = circuit.shard_lanes(mesh, x)
    fresh = torch.ones((4, 4, 3), dtype=torch.int32)
    unsolved = torch.tensor([True, False, True, True])[:, None, None]
    _redraw_sharded(grid, fresh, unsolved, 4)
    got = grid.gather()
    want = x.clone()
    want[:, :4] = torch.where(unsolved, fresh, want[:, :4])
    assert torch.equal(got, want)
    assert int(got[0, :4].sum()) == 12 and int(got[0, 4:].sum()) == 0


def test_the_evidence_profile_prefers_one_device(monkeypatch):
    """The router's bucketed dispatch on the CPU (evidence mode) passes
    prefer_single_device=True and counts its slots from 1 (reference
    tpu/router.py:1064-1070, :1239-1241)."""
    from mythril_tpu_torch.gpu.router import QueryRouter
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from tests.test_torch_router_bucketed import FakeBackend, FakePC, problem

    monkeypatch.setenv("MYTHRIL_GPU_RAGGED", "0")
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    calls = []
    backend = FakeBackend()
    original = backend.padded_query_slots

    def padded(n, single_device=False):
        calls.append(single_device)
        return original(n, single_device)

    backend.padded_query_slots = padded
    router = QueryRouter(backend)
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    pcs = [FakePC(500) for _ in range(2)]
    router.dispatch([problem(pc) for pc in pcs], 10.0, stats=stats)
    stats.reset()
    assert backend.dispatch_log
    for _ids, _budget, kwargs in backend.dispatch_log:
        assert kwargs.get("prefer_single_device") is True
    assert calls and all(calls)
