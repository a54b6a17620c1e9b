"""entry(): one step of the device solver on a batch of blasted path
queries, the twin of the JAX package's __graft_entry__.entry.

The step is one K3 round (gpu/circuit_kernel.py, the per-query round of
the bucketed path) of STEPS_PER_ROUND steps over a batch of four
selector-dispatch queries at 64 bits with eight restart lanes each. It
runs on the CUDA card unless the caller names another device
(entry(device="cpu") runs the round's plain PyTorch version).

dryrun_multichip(n): the production bucketed solver
(DeviceSolverBackend.try_solve_batch_circuit) over a dp x mp mesh of n
shards, so every round is K4 (circuit.make_sharded_round), on the
256-bit queries of a real in-process analyze — the twin of
__graft_entry__.dryrun_multichip.
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


# the harvest's contract: KILLBILLY's unprotected SELFDESTRUCT dispatcher
# with a setter, an adder and a guarded deep store
# (__graft_entry__._harvest_analyze_queries)
HARVEST_RUNTIME = """
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0xe0
    SHR
    DUP1
    PUSH4 0x41c0e1b5
    EQ
    PUSH1 @kill
    JUMPI
    DUP1
    PUSH4 0x50f21a1f
    EQ
    PUSH1 @setter
    JUMPI
    DUP1
    PUSH4 0x60b0f21a
    EQ
    PUSH1 @adder
    JUMPI
    DUP1
    PUSH4 0x70c1d2e3
    EQ
    PUSH1 @branch
    JUMPI
    STOP
:kill
    JUMPDEST
    CALLER
    SELFDESTRUCT
:setter
    JUMPDEST
    PUSH1 0x04
    CALLDATALOAD
    PUSH1 0x01
    SSTORE
    STOP
:adder
    JUMPDEST
    PUSH1 0x04
    CALLDATALOAD
    PUSH1 0x24
    CALLDATALOAD
    ADD
    PUSH1 0x02
    SSTORE
    STOP
:branch
    JUMPDEST
    PUSH1 0x04
    CALLDATALOAD
    PUSH2 0x1000
    GT
    PUSH1 @deep
    JUMPI
    STOP
:deep
    JUMPDEST
    PUSH1 0x24
    CALLDATALOAD
    PUSH1 0x03
    SSTORE
    STOP
"""
# the dryrun's caps (level, cell, var) and its split of the harvest: the
# cones at most SHALLOW_LEVELS deep are solved (leg 1), the deeper ones
# executed at full shape (leg 2)
DRYRUN_CAPS = (2048, 1 << 22, 1 << 17)
SHALLOW_LEVELS = 640


def harvest_analyze_queries():
    """Every blasted query a real in-process analyze of the pinned 256-bit
    contract solved, as (prep, status) pairs, captured at the solve path
    (support/model.capture_sink). The analyze runs on the host CDCL, the
    JAX package's harvest's backend, with the quick-sat probe off (it
    would absorb the shallow sibling queries before a real solve); the
    global args are restored after it."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.disasm.asm import easm_to_code
    from mythril_tpu_torch.support import model as model_mod
    from mythril_tpu_torch.support.args import args

    runtime = easm_to_code(HARVEST_RUNTIME)
    init = easm_to_code(f"""
        PUSH2 0x{len(runtime):04x}
        PUSH1 0x0f
        PUSH1 0x00
        CODECOPY
        PUSH2 0x{len(runtime):04x}
        PUSH1 0x00
        RETURN
        STOP
    """)

    class _Args:
        execution_timeout = 60
        transaction_count = 1
        max_depth = 128
        solver_backend = "cpu"

    saved_args = dict(vars(args))
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode((init + runtime).hex())
    captured = []
    model_mod.capture_sink = captured
    saved_quick_sat = model_mod.model_cache.check_quick_sat
    model_mod.model_cache.check_quick_sat = lambda constraints: None
    try:
        model_mod.clear_caches()
        analyzer = MythrilAnalyzer(disassembler, cmd_args=_Args(),
                                   strategy="bfs")
        report = analyzer.fire_lasers(
            modules=["accidentally_killable",
                     "integer_overflow_and_underflow"],
            transaction_count=1)
        swcs = {issue.swc_id for issue in report.sorted_issues()}
        if not {"106", "101"} <= swcs:
            raise AssertionError(
                f"the harvest's analyze lost its pinned findings (got "
                f"{swcs})")
    finally:
        model_mod.capture_sink = None
        model_mod.model_cache.check_quick_sat = saved_quick_sat
        vars(args).clear()
        vars(args).update(saved_args)
    return captured


def _mesh_devices(n_devices: int, device, virtual: bool) -> list:
    """The dryrun's placement: n shards on one device (virtual: the named
    one, or the card), or the first n cards, which must be visible."""
    import torch

    if virtual:
        return [resolve_device(device)] * n_devices
    if device is not None:
        raise ValueError("a named device holds a virtual mesh only: pass "
                         "virtual=True")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, "
            f"{visible} visible (virtual=True places the shards on one "
            f"device)")
    return [torch.device("cuda", index) for index in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None, virtual: bool = False,
                     deep: bool = True) -> dict:
    """Run the production bucketed solver over a mesh of `n_devices`
    shards (mesh_over's dp x mp) on real analyze-derived queries: the
    pinned contract is analyzed in process (harvest_analyze_queries), and
    its satisfiable 256-bit cones go
    through DeviceSolverBackend.try_solve_batch_circuit, whose every round
    is K4. Leg 1 solves the cones at most SHALLOW_LEVELS deep, every model
    host-checked against the blasted CNF; leg 2 (`deep`) executes the two
    deepest at full shape (convergence is not asserted, as in the JAX
    package). The shards lie on the first n cards, or with `virtual` all
    on one device (the named one, or the card): the placement is never
    chosen on its own. Rounds are shrunk as the JAX package's dryrun
    shrinks them (8 restart lanes, 32 steps, no stall exit). Returns the
    summary it prints."""
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend

    devices = _mesh_devices(n_devices, device, virtual)
    backend = DeviceSolverBackend(num_restarts=8, device=devices[0],
                                  mesh_devices=devices)
    backend.CIRCUIT_STEPS = 32
    backend.STALL_ROUNDS = 1000
    mesh = backend._get_mesh()
    if mesh.size < n_devices:
        raise AssertionError(f"mesh {mesh.dp}x{mesh.mp} < {n_devices} "
                             f"shards")
    placement = (f"virtual: {mesh.size} shards on {mesh.lead}"
                 if mesh.virtual else
                 "one shard a device: " + ", ".join(map(str, mesh.devices)))

    captured = harvest_analyze_queries()
    if not captured:
        raise AssertionError("analyze produced no solver queries to harvest")
    level_cap, cell_cap, v1_cap = DRYRUN_CAPS
    candidates, seen = [], set()
    for prep, status in captured:
        if status != "sat" or prep.aig_roots is None:
            continue
        roots = tuple(prep.aig_roots[1])
        if roots in seen:
            continue
        seen.add(roots)
        pc = circuit.PackedCircuit(prep.aig_roots[0], prep.aig_roots[1])
        if (pc.ok and pc.num_levels <= level_cap
                and pc.num_levels * pc.max_width <= cell_cap
                and pc.v1 <= v1_cap):
            candidates.append((pc.num_levels, len(candidates), prep))
    if not candidates:
        raise AssertionError("no mesh-eligible satisfiable analyze queries")
    candidates.sort(key=lambda c: (c[0], c[1]))
    if not any(any(sort == 256 for _name, sort in (prep.symbols or ()))
               for _levels, _index, prep in candidates):
        raise AssertionError("harvested queries are not 256-bit cones")

    shallow = [c for c in candidates if c[0] <= SHALLOW_LEVELS]
    if len(shallow) < 2:
        raise AssertionError(f"too few shallow analyze cones to solve on "
                             f"the mesh: levels "
                             f"{[c[0] for c in candidates]}")
    selected = [c[2] for c in shallow[:mesh.dp * 2]]
    results = backend.try_solve_batch_circuit(
        [(p.num_vars, p.clauses, p.aig_roots) for p in selected],
        budget_seconds=420.0, size_caps=DRYRUN_CAPS)
    solved = [bits is not None for bits in results]
    if not all(solved):
        raise AssertionError(f"the sharded solver missed analyze-derived "
                             f"SAT queries: solved {solved} "
                             f"(stats {backend.stats()})")
    for index, prep in enumerate(selected):
        if not DeviceSolverBackend._honors(results[index], prep.clauses):
            raise AssertionError(f"the mesh's model of query {index} "
                                 f"fails the host clause check")

    deep_cones = [c for c in candidates if c[0] > SHALLOW_LEVELS][:2] \
        if deep else []
    executed = 0
    if deep_cones:
        before = backend.batch_queries
        backend.try_solve_batch_circuit(
            [(c[2].num_vars, c[2].clauses, c[2].aig_roots)
             for c in deep_cones],
            budget_seconds=30.0, size_caps=DRYRUN_CAPS)
        executed = backend.batch_queries - before
        if executed != len(deep_cones):
            raise AssertionError(f"deep cones were not executed on the "
                                 f"mesh (stats {backend.stats()})")
    stats = backend.stats()
    summary = {"dp": mesh.dp, "mp": mesh.mp, "placement": placement,
               "solved": len(selected),
               "solved_levels": [c[0] for c in shallow[:mesh.dp * 2]],
               "deep_executed": executed,
               "deep_levels": [c[0] for c in deep_cones],
               "batch_sat": stats["batch_sat"], "flips": stats["flips"],
               "cells_stepped": stats["cells_stepped"],
               "batch_queries": stats["batch_queries"]}
    print(f"dryrun_multichip ok: mesh dp={mesh.dp} mp={mesh.mp} "
          f"({placement}), {len(selected)} analyze-derived 256-bit queries "
          f"(cones {summary['solved_levels']} levels) solved through the "
          f"production backend with host-checked models; {executed} deep "
          f"cones ({summary['deep_levels']} levels) executed at full "
          f"shape; batch_sat={stats['batch_sat']}", flush=True)
    return summary
