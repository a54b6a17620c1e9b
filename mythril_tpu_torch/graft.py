"""entry(): one step of the device solver on a batch of blasted path
queries, the twin of the JAX package's __graft_entry__.entry.

The step is one K3 round (gpu/circuit_kernel.py, the per-query round of
the bucketed path) of STEPS_PER_ROUND steps over a batch of four
selector-dispatch queries at 64 bits with eight restart lanes each. It
runs on the CUDA card unless the caller names another device
(entry(device="cpu") runs the round's plain PyTorch version).
"""

from mythril_tpu_torch.gpu import circuit, circuit_kernel
from mythril_tpu_torch.gpu.device import resolve_device

BITS = 64
QUERIES = 4
RESTARTS = 8
STEPS_PER_ROUND = 8


def example_problems(num_queries: int = QUERIES):
    """Blast a batch of QF_BV path-constraint queries to circuits: (preps,
    PackedCircuits, the numpy batch padded to their largest shape,
    levels, v1)."""
    from mythril_tpu_torch.smt import symbol_factory
    from mythril_tpu_torch.smt.solver.frontend import Solver

    preps = []
    for q in range(num_queries):
        # selector-dispatch-shaped constraints (what JUMPI forks produce)
        data = symbol_factory.BitVecSym(f"calldata_word_{q}", BITS)
        value = symbol_factory.BitVecSym(f"callvalue_{q}", BITS)
        sender = symbol_factory.BitVecSym(f"sender_{q}", BITS)
        solver = Solver()
        solver.add((data >> (BITS - 16)) == 0x4100 + q)
        solver.add(value < (1 << 40), sender != 0)
        solver.add(value + data != sender)
        prep = solver._prepare([])
        if prep.trivial is not None:
            raise AssertionError(f"example query {q} prepared trivially")
        preps.append(prep)
    packed = [circuit.PackedCircuit(p.aig_roots[0], p.aig_roots[1])
              for p in preps]
    if not all(p.ok for p in packed):
        raise AssertionError("an example query failed to pack")
    batch = circuit_kernel.stack_padded(packed)
    return (preps, packed, batch, max(p.num_levels for p in packed),
            max(p.v1 for p in packed))


def entry(device=None):
    """(fn, example_args): fn(tensors, x, seed) runs one round and returns
    (x [4, 8, V1] int32, found [4, 8] bool)."""
    import torch

    device = resolve_device(device)
    _, _, batch, n_levels, v1 = example_problems()
    tensors = circuit_kernel.device_batch(batch, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(2)
    x = torch.randint(0, 2, (QUERIES, RESTARTS, v1), generator=generator,
                      device=device, dtype=torch.int32)
    walk_depth = n_levels + 4

    def step(tensors, x, seed):
        return circuit_kernel.run_round_circuit_kernel(
            tensors, x, seed, steps=STEPS_PER_ROUND, walk_depth=walk_depth)

    return step, (tensors, x, 1)
