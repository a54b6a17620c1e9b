"""K3, the bucketed path's per-query round (mythril_tpu_torch/gpu/
circuit_kernel.py), held against the JAX package's XLA round
(mythril_tpu/tpu/circuit.py run_round_circuit_batch) on the CPU.

- padded_to: byte for byte the reference's, on the sibling window's cones
  prepared in both packages.
- At steps=0 the round is deterministic in both packages (simulate, then
  the root check): x and found must be bit-identical (zero tolerance).
- With steps the randomness differs (the port's counter hash, the
  reference's threefry bits), so the found mask is held to the
  brute-force oracle of tests/test_ragged.py over 30 seeds: every SAT cone
  found within ROUNDS rounds (they stop once every SAT cone is), no
  UNSAT cone ever found, every found row a model of its roots
  (_eval_root), every returned row gate-consistent, the query axis's
  padding slots found at step 0, and the same seed the same result.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda_circuit.py, chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mythril_tpu.smt as ref_smt
import mythril_tpu_torch.smt as port_smt
from mythril_tpu.smt.solver import frontend as ref_frontend
from mythril_tpu.tpu import circuit as ref_circuit
from mythril_tpu.tpu.backend import shape_bucket
from mythril_tpu_torch.gpu import circuit_kernel
from mythril_tpu_torch.gpu.circuit import PackedCircuit as PortPacked
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support.workloads import sibling_window
from tests.test_ragged import _bruteforce_sat, _eval_root, _random_cone
from tests.torch_helpers import assert_packed_equal, port_packed

ROUNDS = 4   # rounds every SAT cone must be found within
STEPS = 32
LANES = 8


def _bucket_shape(pcs):
    return (shape_bucket(max(pc.num_levels for pc in pcs) or 1),
            shape_bucket(max(pc.max_width for pc in pcs)),
            shape_bucket(max(pc.v1 for pc in pcs)),
            shape_bucket(max(pc.num_roots for pc in pcs)))


def test_padded_to_equals_the_reference_on_the_sibling_window(monkeypatch):
    monkeypatch.setattr(ref_frontend, "_global_blaster", None)
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    packed = {}
    for name, smt, frontend, packer in (
            ("ref", ref_smt, ref_frontend, ref_circuit.PackedCircuit),
            ("port", port_smt, port_frontend, PortPacked)):
        pcs = []
        for constraints in sibling_window(smt, 8, seed=5):
            solver = frontend.Solver(timeout=20)
            solver.add(constraints)
            prep = solver._prepare([])
            if prep.trivial is None:
                pcs.append(packer(prep.aig_roots[0], prep.aig_roots[1]))
        packed[name] = pcs
    assert len(packed["port"]) == len(packed["ref"]) >= 6
    shape = _bucket_shape(packed["ref"])
    for ref_pc, pc in zip(packed["ref"], packed["port"]):
        assert_packed_equal(ref_pc, pc)
        want, got = ref_pc.padded_to(*shape), pc.padded_to(*shape)
        assert set(got) == set(want) == set(ref_circuit.TENSOR_KEYS)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key


def _cones(seed, count=3):
    """(ref aig, roots, ref pc, port pc, satisfiable) of `count` random
    cones; with an odd seed the second asserts its root and the root's
    negation (UNSAT for certain)."""
    rng = random.Random(seed)
    out, cache = [], {}
    while len(out) < count:
        aig, roots = _random_cone(rng, rng.randint(3, 8), rng.randint(8, 40))
        if seed % 2 and len(out) == 1:
            roots = [roots[0], roots[0] ^ 1]
        pc = ref_circuit.PackedCircuit(aig, roots)
        if not pc.ok:
            continue
        port_pc = port_packed(pc, aig, roots, cache)
        assert_packed_equal(pc, port_pc)
        out.append((aig, roots, pc, port_pc, _bruteforce_sat(aig, roots)))
    return out


def _batch(cones, slots):
    pcs = [port_pc for _a, _r, _pc, port_pc, _s in cones]
    batch = circuit_kernel.stack_padded(pcs, _bucket_shape(pcs), slots)
    return batch, circuit_kernel.device_batch(batch, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_zero_steps_equal_the_reference_round(seed):
    cones = _cones(seed)
    batch, tensors = _batch(cones, 4)
    q_count, levels = batch["out_idx"].shape[:2]
    v1 = batch["ga_var"].shape[1]
    x = np.random.RandomState(seed).randint(
        0, 2, (q_count, LANES, v1)).astype(np.int32)
    want_x, want_found = ref_circuit.run_round_circuit_batch(
        {key: jnp.asarray(value) for key, value in batch.items()},
        jnp.asarray(x), jax.random.split(jax.random.PRNGKey(seed), q_count),
        steps=0, walk_depth=levels + 4)
    got_x, got_found = circuit_kernel.run_round_circuit_kernel(
        tensors, torch.as_tensor(x), seed, 0, levels + 4)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    # the padding slot: no live root, found at step 0
    assert bool(got_found[-1].all())


def _rounds(tensors, batch, seed, sat, count=ROUNDS):
    """Up to `count` rounds from fresh seeded lanes, until every query of
    the `sat` mask has been found: per round (x, found)."""
    q_count, levels = batch["out_idx"].shape[:2]
    v1 = batch["ga_var"].shape[1]
    rng = np.random.RandomState(seed)
    out, ever = [], np.zeros((q_count,), dtype=bool)
    for round_index in range(count):
        x = torch.as_tensor(rng.randint(0, 2, (q_count, LANES, v1)),
                            dtype=torch.int32)
        out.append(circuit_kernel.run_round_circuit_plain(
            tensors, x, seed * 1000 + round_index, STEPS, levels + 4))
        ever |= out[-1][1].numpy().any(axis=1)
        if (ever >= sat).all():
            break
    return out


@pytest.mark.parametrize("seed", range(30))
def test_found_mask_equals_the_bruteforce_oracle(seed):
    cones = _cones(seed)
    batch, tensors = _batch(cones, 4)
    levels = batch["out_idx"].shape[1]
    sat = np.array([cone[4] for cone in cones] + [True])
    rounds = _rounds(tensors, batch, seed, sat)
    ever = np.zeros((4,), dtype=bool)
    for x, found in rounds:
        ever |= found.numpy().any(axis=1)
        # gate-consistent: one more simulate changes nothing
        again, _found = circuit_kernel.run_round_circuit_plain(
            tensors, x, 0, 0, levels + 4)
        assert torch.equal(again, x)
        for qi, (aig, roots, ref_pc, _port, _sat) in enumerate(cones):
            for lane in np.nonzero(found[qi].numpy())[0]:
                row = x[qi, lane].numpy()
                assignment = {int(gvar): bool(row[lvar]) for lvar, gvar
                              in enumerate(ref_pc.var_map) if lvar > 0}
                assert all(_eval_root(aig, assignment, root)
                           for root in roots), (qi, lane)
    for qi, cone in enumerate(cones):
        assert ever[qi] == cone[4], (qi, cone[4])
    assert ever[3], "the padding slot reports found"
    # the same seed: the same result
    (x1, f1), = rounds[:1]
    (x2, f2), = _rounds(tensors, batch, seed, sat, count=1)
    assert torch.equal(x1, x2) and torch.equal(f1, f2)


def test_wrapper_checks_its_operands():
    cones = _cones(4)
    batch, tensors = _batch(cones, 4)
    v1 = batch["ga_var"].shape[1]
    x = torch.zeros((4, 2, v1), dtype=torch.int32)
    with pytest.raises(ValueError, match="x must be"):
        circuit_kernel.run_round_circuit_kernel(
            tensors, x.long(), 1, 1, 8)
    with pytest.raises(ValueError, match="is_gate"):
        circuit_kernel.run_round_circuit_kernel(
            {**tensors, "is_gate": tensors["is_gate"][:, :-1]}, x, 1, 1, 8)
    with pytest.raises(ValueError, match="layout"):
        circuit_kernel.run_round_circuit_kernel(
            tensors, x, 1, 1, 8, layout=torch.zeros((4, 1),
                                                    dtype=torch.int32))
    launches = circuit_kernel.launches
    circuit_kernel.run_round_circuit_kernel(tensors, x, 1, 1, 8)
    assert circuit_kernel.launches == launches, "the plain version counts none"


def test_level_rows_bound_each_level_and_launch_shape():
    cones = _cones(6)
    batch, tensors = _batch(cones, 4)
    rows = circuit_kernel.level_rows(tensors).numpy()
    live = batch["out_idx"] > 0
    for q in range(4):
        for level in range(live.shape[1]):
            cells = np.nonzero(live[q, level])[0]
            assert rows[q, level] == (cells.max() + 1 if len(cells) else 0)
    assert rows[3].sum() == 0, "a padding slot has no live cell"
    # 32 lanes a word below 16,384 variables, 8 past 98,304, and x in
    # global memory past 196,608 (tests/test_torch_circuit_layout.py
    # holds every tier's threshold)
    assert circuit_kernel.launch_shape(4096, 64)[:2] == ("shared32", 32)
    assert circuit_kernel.launch_shape(1 << 17, 8)[:2] == ("xshared", 8)
    assert circuit_kernel.launch_shape(
        circuit_kernel.SMEM_CAP, 8)[:2] == ("global", 32)
