"""Host-side driver of the device circuit-SLS solver.

try_solve_batch_ragged() solves one chunk of a window: the router
(gpu/router.py) levelizes each admitted cone through pack_cone (cached by
circuit structure), chunks the window, and hands each chunk here; the
chunk is packed into ONE ragged flat stream (circuit.RaggedStream) and
rounds run until every cone is solved or the search stalls, with the cube
second pass on the cones the plain rounds miss. The round is the kernel
mode's (ragged_kernel.kernel_mode(), MYTHRIL_GPU_KERNEL): in "pallas" mode
K1 (ragged_kernel.py) over the exact stream, falling back to K2 for a
stream past one of K1's capacities; in "xla" mode K2 (xla_kernel.py), which
has none, over the stream padded to its shape bucket.

try_solve_batch_circuit() is the bucketed path (--no-ragged): one level
bucket of queries, each cone padded to the bucket's shape and the query
axis to a power of two, runs rounds of the per-query round
(circuit_kernel.py) over every query at once. try_solve() is its
single-query form.

Found models are checked against the CNF on the host; None entries are
left to the caller's CDCL, which alone proves UNSAT. A kernel that fails
to build or to launch, or a device error, raises: nothing here drops the
device path silently.
"""

import logging
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.gpu import (
    circuit,
    circuit_kernel,
    ragged_kernel,
    xla_kernel,
)
from mythril_tpu_torch.gpu.device import mesh_over, resolve_device
from mythril_tpu_torch.observe import transfers
from mythril_tpu_torch.observe.tracer import span as trace_span
from mythril_tpu_torch.preanalysis import cubes
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.env import env_int

log = logging.getLogger(__name__)

# per-stream memory budget of the router's chunking
# (MYTHRIL_GPU_RAGGED_STREAM_BYTES overrides)
RAGGED_STREAM_BYTES_DEFAULT = 48 * 1024 * 1024
# the cube second pass: split width on a real device, and the depth a
# missed cone needs to get it
CUBE_VARS_DEFAULT = 7
CUBE_MIN_LEVELS_DEFAULT = 64


def shape_bucket(n: int) -> int:
    """1.5x geometric shape bucket: 64, 96, 128, 192, 256, ... (the JAX
    package pads its XLA rounds to it). The router groups cones by the
    bucket of their depth and charges its cost model over bucketed
    rectangles, as the JAX package's router does."""
    size = 64
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size


def _pow2_slots(dp: int, n: int) -> int:
    """Query-axis padding: a pow2 ramp from `dp` (1 on one card)."""
    q = max(1, dp)
    while q < n:
        q *= 2
    return q


def _redraw_sharded(grid, fresh, unsolved, half: int) -> None:
    """The bucketed round's re-draw on a mesh: lanes [0, half) of the whole
    lane axis take `fresh` ([Q, half, V1]) where `unsolved` ([Q, 1, 1]),
    in each shard's block that holds some of them, in place."""
    mesh = grid.mesh
    for i in range(mesh.dp):
        for j in range(mesh.mp):
            block = grid.block(i, j)
            qs, rs = block.shape[:2]
            lo, hi = j * rs, min((j + 1) * rs, half)
            if lo >= hi:
                continue
            rows = slice(i * qs, (i + 1) * qs)
            block[:, :hi - lo] = torch.where(
                unsolved[rows].to(block.device),
                fresh[rows, lo:hi].to(block.device), block[:, :hi - lo])


def _circuit_struct_key(aig, roots) -> tuple:
    """(aig identity, roots) — the pack cache key. The AIG is append-only
    with structural hashing, so a root literal's cone is fully determined
    by (aig.uid, roots)."""
    return (getattr(aig, "uid", id(aig)), tuple(roots))


class _LRU(OrderedDict):
    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get_or(self, key, make):
        if key in self:
            self.move_to_end(key)
            return self[key], True
        value = make()
        self[key] = value
        if len(self) > self.maxsize:
            self.popitem(last=False)
        return value, False


def problem_from_arrays(num_vars, cnf_lits, cnf_offsets, gate_lhs, gate_rhs,
                        roots, dense=None):
    """One blasted query handed over as numpy arrays (mythril_tpu's
    AIG.gate_arrays(), CNF.lits / CNF.offsets, its root literals and the
    dense map's array) -> the port's (num_vars, clauses, aig_roots)."""
    from mythril_tpu_torch.smt.bitblast import AIG, CNF, DenseMap

    lits = np.ascontiguousarray(cnf_lits, dtype=np.int32)
    offsets = np.ascontiguousarray(cnf_offsets, dtype=np.int64)
    num_clauses = len(offsets) - 1
    has_empty = bool((offsets[1:] == offsets[:-1]).any())
    clauses = CNF(lits, offsets, num_clauses, has_empty)
    aig = AIG.from_gate_arrays(gate_lhs, gate_rhs)
    aig_roots = (aig, [int(r) for r in roots])
    if dense is not None:
        aig_roots += (DenseMap(np.asarray(dense, dtype=np.int32)),)
    return int(num_vars), clauses, aig_roots


_backends = {}


def get_device_backend(device=None) -> "DeviceSolverBackend":
    """The process-global backend of `device` (None = the CUDA device;
    raises without one). Pack caches and counters live on it."""
    resolved = resolve_device(device)
    if resolved not in _backends:
        _backends[resolved] = DeviceSolverBackend(device=device)
    return _backends[resolved]


def reset_backends() -> None:
    """Drop every device's backend, its pack caches, counters and seed with
    it: the next get_device_backend builds one that re-reads its knobs
    (tune.apply_tuned_profile)."""
    _backends.clear()


class DeviceSolverBackend:
    CIRCUIT_STEPS = 64
    STALL_ROUNDS = 2  # stop after this many rounds with no new solves

    def __init__(self, num_restarts: Optional[int] = None,
                 device=None, mesh_devices: Optional[Sequence] = None):
        self.device = resolve_device(device)
        # the bucketed path's dp x mp mesh (_get_mesh): over these devices
        # when given (a device may repeat: a virtual mesh), else 1x1 on a
        # card the caller named by its index, else every visible card, or
        # 1x1 on the CPU
        self._mesh_devices = (None if mesh_devices is None
                              else tuple(mesh_devices))
        self._named_card = (device is not None
                            and self.device.index is not None)
        self._mesh = None
        self._sharded_rounds = {}  # (steps, walk_depth) -> K4's round
        # explicit constructor arg wins; the env var only sets the default
        if num_restarts is None:
            num_restarts = env_int("MYTHRIL_GPU_RESTARTS", 64)
        self.num_restarts = num_restarts
        circuit_steps = env_int("MYTHRIL_GPU_CIRCUIT_STEPS", 0)
        if circuit_steps > 0:
            self.CIRCUIT_STEPS = circuit_steps
        self.reset_stats()
        self._seed = 0
        self._pack_cache = _LRU(512)  # struct key -> PackedCircuit
        # (struct key, bucket shape) -> the padded tables on the device
        self._padded_cache = _LRU(256)
        # test hook: on_stream(stream, entries) before each upload
        self.on_stream = None

    def reset_stats(self) -> None:
        """Zero the counters stats() reports (the backend lives as long as
        the process; the pack cache and the seed stay)."""
        # queries that reached the device and those it left to the CDCL
        self.queries = 0
        self.fallbacks = 0
        self.sat_found = 0
        self.batch_calls = 0
        self.batch_queries = 0
        self.batch_sat = 0
        self.device_seconds = 0.0
        self.pack_seconds = 0.0
        self.ship_seconds = 0.0
        self.solve_seconds = 0.0
        self.cap_rejects = 0
        self.pack_hits = 0
        self.pack_misses = 0
        self.flips = 0
        # work units: bytes levelized into packed tensors (pack misses),
        # bytes of flattened streams uploaded to the device, and gate
        # cells stepped by kernel rounds
        self.pack_bytes = 0
        self.ship_bytes = 0
        self.cells_stepped = 0
        # ragged streams dispatched, the cones they carried, assembled
        # stream bytes and the wall spent assembling + uploading them
        self.ragged_windows = 0
        self.ragged_cones = 0
        self.paged_stream_bytes = 0
        self.ragged_seconds = 0.0
        # the cube-and-conquer second pass: cubes shipped, and cubes that
        # came back modelless (candidate refutations the CDCL may confirm)
        self.cubes_dispatched = 0
        self.cube_device_refutes = 0
        # ragged-round launches and the block-aligned cells they stepped
        self.kernel_launches = 0
        self.kernel_cells_stepped = 0

    def try_solve(self, num_vars: int, clauses, assumptions=(),
                  budget_seconds: float = 2.0,
                  aig_roots: Optional[Tuple] = None):
        """Search one query's model on the device; None if not found in
        budget. The caller provides the blasted AIG (`aig_roots = (aig,
        root_lits[, dense])`); assumption probes and bare CNF go back to
        the CDCL (None). A model found is validated against the CNF on
        the host."""
        if aig_roots is None or assumptions:
            return None
        return self.try_solve_batch_circuit(
            [(num_vars, clauses, aig_roots)],
            budget_seconds=budget_seconds)[0]

    def count_cap_reject(self, count: int = 1,
                         under_floor: bool = False) -> None:
        """A cone the router turned away from the device: never sent, the
        CDCL settles it. Mirrored into SolverStatistics; `under_floor`
        flags a cone inside the admission floor (must never happen)."""
        self.cap_rejects += count
        SolverStatistics().add_cap_reject(count, under_floor=under_floor)

    def pack_problem(self, problem, v1_cap: int):
        """Levelize one (num_vars, clauses, aig_roots) query through the
        pack cache; None on a pre-pack var-cap reject (counted), so a
        query past the kernel's variable space never pays for packing."""
        num_vars, _clauses, aig_roots = problem[:3]
        if num_vars + 1 > v1_cap:
            self.count_cap_reject()
            return None
        return self.pack_cone(aig_roots[0], aig_roots[1])

    def pack_cone(self, aig, roots, carry_lits=()):
        """Levelize one root cone through the pack cache. `carry_lits`:
        literals levelized in UNASSERTED so extra roots can pin them —
        keyed into the cache so a plain cone never aliases a carry cone."""
        skey = _circuit_struct_key(aig, roots)
        if carry_lits:
            skey = (skey, "carry", tuple(carry_lits))

        def _build():
            start = time.monotonic()
            pc = circuit.PackedCircuit(aig, roots, carry_lits=carry_lits)
            self.pack_seconds += time.monotonic() - start
            return pc

        pc, hit = self._pack_cache.get_or(skey, _build)
        if hit:
            self.pack_hits += 1
        else:
            self.pack_misses += 1
            self.pack_bytes += pc.nbytes
        return pc

    @staticmethod
    def ragged_entry_bytes(pc) -> int:
        """Estimated contribution of one cone to an assembled ragged
        stream (the JAX package's router estimate): the level-row payload
        over the cone's levels x widest-real-row rectangle plus the
        per-var tables, with 2x slack for combined-row bucketing."""
        rows = pc.level_rows
        widest = int(rows.max()) if len(rows) else 1
        return (pc.num_levels * widest * 5 + pc.v1 * 5) * 4 * 2

    # -- the bucketed path (circuit_kernel.py) ---------------------------------

    def padded_query_slots(self, n: int, single_device: bool = False) -> int:
        """Query-axis padding of a bucketed launch of n live queries (the
        pow2 ramp from the mesh's dp, from 1 with `single_device`) —
        occupancy accounting."""
        dp = 1 if single_device else self._get_mesh().dp
        return _pow2_slots(dp, n)

    def _get_mesh(self):
        """The dp x mp mesh of the bucketed path (mesh_over's rule): over
        the constructor's `mesh_devices`, else every visible card when the
        backend's device is a card the caller did not name by its index
        (no device, or "cuda"), else 1x1 on the backend's device: a named
        card (`--torch-device cuda:1`) confines the work to it."""
        if self._mesh is None:
            if self._mesh_devices is not None:
                devices = self._mesh_devices
            elif self.device.type == "cuda" and not self._named_card:
                devices = [torch.device("cuda", index) for index
                           in range(torch.cuda.device_count())]
            else:
                devices = [self.device]
            self._mesh = mesh_over(devices)
        return self._mesh

    def _get_sharded_round(self, steps: int, walk_depth: int):
        key = (steps, walk_depth)
        if key not in self._sharded_rounds:
            self._sharded_rounds[key] = circuit.make_sharded_round(
                self._get_mesh(), steps, walk_depth)
        return self._sharded_rounds[key]

    def _platform_caps(self) -> Tuple[int, int, int]:
        """The router's (level, cell, var) eligibility caps."""
        from mythril_tpu_torch.gpu.router import get_router

        return get_router(self.device).resolve_caps()

    def _padded_device(self, pc, skey, shape_key) -> dict:
        """One cone's tables padded to the bucket shape, on the device,
        through the padded-tensor cache: ship bytes and wall accrue per
        miss (only misses pad and upload)."""
        def upload():
            start = time.monotonic()
            entry = circuit_kernel.device_batch(
                {key: value[None] for key, value
                 in pc.padded_to(*shape_key).items()}, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.ship_seconds += time.monotonic() - start
            return entry

        entry, hit = self._padded_cache.get_or((skey, shape_key), upload)
        if not hit:
            self.ship_bytes += int(sum(t.numel() * t.element_size()
                                       for t in entry.values()))
        return entry

    def try_solve_batch_circuit(
        self,
        problems: Sequence[Tuple[int, Sequence, Tuple]],
        budget_seconds: float = 4.0,
        size_caps: Optional[Tuple[int, int, int]] = None,
        num_restarts: Optional[int] = None,
        steps: Optional[int] = None,
        prefer_single_device: bool = False,
        packed_hint: Optional[Sequence] = None,
    ) -> List[Optional[List[bool]]]:
        """Solve many blasted queries with the per-query round in one
        launch a round (one a shard on a mesh). `problems` entries are
        (num_vars, clauses, (aig, root_lits[, dense])). Returns per-query
        model bits or None (the caller's CDCL settles misses and alone
        proves UNSAT).

        Each cone is padded to the batch's 1.5x shape bucket (levels,
        width, variables, roots), the query axis to a power of two with
        all-zero slots (no live root: found at step 0). Packing and the
        padded device tables are cached by circuit structure across
        calls. `size_caps` overrides the router's (level, cell, var)
        caps; `num_restarts` / `steps` the per-round work (the router's
        evidence profile on the CPU); `packed_hint` (aligned with
        `problems`) supplies PackedCircuits the router already built.

        On a mesh of more than one shard (_get_mesh) the round is K4
        (circuit.make_sharded_round): the query axis padded to a power of
        two from dp and split over dp, the restart lanes rounded up to a
        multiple of mp and split over mp, the tables and their layouts
        placed on the shards once a batch. `prefer_single_device` skips
        the mesh and pads the query axis from 1 (the router's evidence
        profile on the CPU, as in the JAX package).

        Rounds run until every query is solved, STALL_ROUNDS rounds pass
        without a new solve, or the budget is spent. A query solved in
        one round keeps that lane's assignment; between rounds the first
        half of each unsolved query's lanes (of the whole lane axis,
        across shard boundaries) is re-drawn from a seeded generator on
        the backend's device."""
        results: List[Optional[List[bool]]] = [None] * len(problems)
        if size_caps is not None:
            level_cap, cell_cap, v1_cap = size_caps
        else:
            level_cap, cell_cap, v1_cap = self._platform_caps()

        # entries: (orig idx, num_vars, pc, struct key, dense map or None)
        packed: List[Tuple] = []
        with trace_span("device.pack", cat="device",
                        queries=len(problems)):
            for qi, (num_vars, clauses, aig_roots) in enumerate(problems):
                if num_vars == 0:
                    continue
                if packed_hint is not None and packed_hint[qi] is not None:
                    pc = packed_hint[qi]
                else:
                    pc = self.pack_problem(
                        (num_vars, clauses, aig_roots), v1_cap)
                    if pc is None:
                        continue
                dense = aig_roots[2] if len(aig_roots) > 2 else None
                skey = _circuit_struct_key(aig_roots[0], aig_roots[1])
                if (pc.ok and pc.num_levels <= level_cap
                        and pc.num_levels * pc.max_width <= cell_cap
                        and pc.v1 <= v1_cap):
                    packed.append((qi, num_vars, pc, skey, dense))
                elif pc.ok:
                    self.count_cap_reject()
        self.queries += len(packed)
        if not packed:
            return results
        call_start = time.monotonic()
        deadline = call_start + budget_seconds
        self.batch_calls += 1
        self.batch_queries += len(packed)
        self._seed += 1

        pcs = [p for _, _, p, _, _ in packed]
        n_levels = shape_bucket(max(p.num_levels for p in pcs) or 1)
        width = shape_bucket(max(p.max_width for p in pcs))
        v1 = shape_bucket(max(p.v1 for p in pcs))
        n_roots = shape_bucket(max(p.num_roots for p in pcs))
        walk_depth = min(n_levels + 4, circuit.MAX_LEVELS)
        if prefer_single_device:
            mesh, dp, mp = None, 1, 1
        else:
            mesh = self._get_mesh()
            dp, mp = mesh.dp, mesh.mp
        multi = dp * mp > 1
        if num_restarts is None:
            num_restarts = self.num_restarts
        if steps is None:
            steps = self.CIRCUIT_STEPS
        if multi and num_restarts % mp:
            num_restarts += mp - num_restarts % mp
        q = _pow2_slots(dp, len(packed))
        shape_key = (n_levels, width, v1, n_roots)

        with trace_span("device.ship", cat="device", slots=q):
            padded = [self._padded_device(p, skey, shape_key)
                      for _, _, p, skey, _ in packed]
            if q > len(packed):
                zero, _ = self._padded_cache.get_or(
                    ("zero", shape_key),
                    lambda: {key: torch.zeros_like(value)
                             for key, value in padded[0].items()})
                padded += [zero] * (q - len(packed))
            # batch assembly of resident tables, on the device
            tensors = {key: torch.cat([entry[key] for entry in padded])
                       for key in circuit.TENSOR_KEYS}
            # the kernel's records and real-gate stream, once per batch (on
            # a mesh: placed on each shard, a layout each)
            if multi:
                placed = circuit.shard_tables(mesh, tensors)
            else:
                layout = circuit_kernel.circuit_layout(tensors)
        solve_start = time.monotonic()

        generator = torch.Generator(device=self.device)
        generator.manual_seed(self._seed)
        x = torch.randint(0, 2, (q, num_restarts, v1), generator=generator,
                          device=self.device, dtype=torch.int32)
        if multi:
            x = circuit.shard_lanes(mesh, x)
            round_fn = self._get_sharded_round(steps, walk_depth)
        # sticky per-slot results: a query solved in round k keeps its
        # model even if later rounds re-randomize
        solved = np.zeros((q,), dtype=bool)
        best_rows = {}  # slot -> host copy of the satisfying assignment
        rounds = stall = 0
        half = num_restarts // 2
        with trace_span("device.kernel", cat="device", slots=q,
                        levels=n_levels, width=width,
                        restarts=num_restarts) as kernel_span:
            while True:
                seed = (self._seed * 1000003 + rounds) & 0x7FFFFFFF
                if multi:
                    # solved is the mp MAX; only a newly solved slot's
                    # lanes come back to the host
                    x, found, round_solved = round_fn(placed, x, seed)
                    round_solved = transfers.to_numpy(round_solved,
                                                      "bucketed.solved")
                else:
                    x, found = circuit_kernel.run_round_circuit_kernel(
                        tensors, x, seed=seed, steps=steps,
                        walk_depth=walk_depth, layout=layout)
                    found_host = transfers.to_numpy(found, "bucketed.found")
                    round_solved = found_host.any(axis=1)
                rounds += 1
                self.flips += q * num_restarts * steps
                # the calibration's cell unit: each step resimulates the
                # bucket's levels x width cells plus a walk (the 2x), per
                # padded query slot
                self.cells_stepped += q * steps * 2 * n_levels * width
                newly = round_solved & ~solved
                if newly.any():
                    stall = 0
                    x_host = (None if multi
                              else transfers.to_numpy(x, "bucketed.x"))
                    for slot in np.nonzero(newly)[0]:
                        slot = int(slot)
                        if multi:
                            # row() reads the slot's blocks to the host
                            found_row = found.row(slot, site="bucketed.found")
                            lane = int(np.argmax(found_row.numpy()))
                            best_rows[slot] = x.row(
                                slot, site="bucketed.x")[lane].numpy()
                        else:
                            lane = int(np.argmax(found_host[slot]))
                            best_rows[slot] = x_host[slot, lane].copy()
                else:
                    stall += 1
                solved |= round_solved
                if (solved.all() or stall >= self.STALL_ROUNDS
                        or time.monotonic() >= deadline):
                    break
                # re-draw the unsolved queries' first half of lanes
                # (solved slots keep their frozen assignments)
                if half:
                    fresh = torch.randint(
                        0, 2, (q, half, v1), generator=generator,
                        device=self.device, dtype=torch.int32)
                    unsolved = torch.as_tensor(
                        ~solved, device=self.device)[:, None, None]
                    if multi:
                        _redraw_sharded(x, fresh, unsolved, half)
                    else:
                        x[:, :half] = torch.where(unsolved, fresh,
                                                  x[:, :half])
            kernel_span.set(rounds=rounds)
        self.solve_seconds += time.monotonic() - solve_start

        with trace_span("device.check", cat="device", queries=len(packed)):
            for slot, (qi, num_vars, pc, _skey, dense) in enumerate(packed):
                assignment = best_rows.get(slot)
                if assignment is None:
                    self.fallbacks += 1
                    continue
                bits = self.bits_from_circuit_assignment(
                    pc, dense, num_vars, assignment)
                if self._honors(bits, problems[qi][1]):
                    results[qi] = bits
                    self.batch_sat += 1
                    self.sat_found += 1
                else:
                    self.fallbacks += 1
                    log.warning("circuit model failed host clause check")
        self.device_seconds += time.monotonic() - call_start
        return results

    # -- ragged flat-stream dispatch (circuit.RaggedStream) ------------------

    def try_solve_batch_ragged(
        self,
        problems: Sequence[Tuple[int, Sequence, Tuple]],
        budget_seconds: float = 4.0,
        num_restarts: Optional[int] = None,
        steps: Optional[int] = None,
        packed_hint: Optional[Sequence] = None,
        cube_vars: int = 0,
        cube_min_levels: int = 64,
        stream_budget: Optional[int] = None,
        extra_roots: Optional[Sequence] = None,
    ) -> List[Optional[List[bool]]]:
        """Solve a WINDOW of blasted queries as ONE ragged flat stream:
        the cones concatenate into a combined circuit with per-cone paged
        gate/root tables, so a single kernel launch per round covers the
        whole window regardless of per-cone shape. Returns per-query model
        bits or None. `extra_roots[qi]`: (local var, want) pins asserted
        as additional roots of that query's cone. In pallas mode a window
        past one of K1's capacities runs on K2.

        Cones the plain rounds miss get a cube-and-conquer second pass
        when `cube_vars` > 0: the cone is replicated onto a fresh stream
        with up to 2^cube_vars high-fanout input assignments pinned, one
        per replica (preanalysis/cubes.py). A model of any cube is a model
        of the cone; modelless cubes are only candidate refutations
        (cube_device_refutes) — the host CDCL alone proves UNSAT."""
        results: List[Optional[List[bool]]] = [None] * len(problems)
        packed: List[Tuple] = []
        with trace_span("device.pack", cat="device",
                        queries=len(problems)):
            for qi, (num_vars, clauses, aig_roots) in enumerate(problems):
                if num_vars == 0:
                    continue
                if packed_hint is not None and packed_hint[qi] is not None:
                    pc = packed_hint[qi]
                else:
                    pc = self.pack_cone(aig_roots[0], aig_roots[1])
                if not pc.ok:
                    continue
                dense = aig_roots[2] if len(aig_roots) > 2 else None
                extra = (tuple(extra_roots[qi])
                         if extra_roots is not None and extra_roots[qi]
                         else ())
                packed.append((qi, num_vars, pc, dense, extra))
        self.queries += len(packed)
        if not packed:
            return results
        call_start = time.monotonic()
        deadline = call_start + budget_seconds
        self.batch_calls += 1
        self.batch_queries += len(packed)
        if num_restarts is None:
            num_restarts = self.num_restarts
        if steps is None:
            steps = self.CIRCUIT_STEPS

        solved, window_bytes, _done = self._solve_ragged_stream(
            [(pc, extra) for _qi, _nv, pc, _d, extra in packed],
            deadline, num_restarts, steps)

        cubes_shipped = cube_refutes = 0
        if cube_vars > 0 and len(solved) < len(packed):
            caps = (ragged_kernel.kernel_caps()
                    if ragged_kernel.kernel_mode() == "pallas" else None)
            if stream_budget is None:
                stream_budget = RAGGED_STREAM_BYTES_DEFAULT
            for i, (_qi, _nv, pc, _dense, extra) in enumerate(packed):
                if i in solved or pc.num_levels < cube_min_levels:
                    continue
                if time.monotonic() >= deadline - 0.05:
                    break
                entries = self.cube_entries(pc, extra, cube_vars, caps,
                                            stream_budget)
                if not entries:
                    continue
                cubes_shipped += len(entries)
                cube_solved, nbytes, cube_done = self._solve_ragged_stream(
                    entries, deadline, num_restarts, steps,
                    stop_at_first=True)
                window_bytes += nbytes
                if cube_done and not cube_solved:
                    # only a stream that ran out its stall budget counts
                    # its cubes as candidate refutations
                    cube_refutes += len(entries)
                if cube_solved:
                    solved[i] = cube_solved[min(cube_solved)]
        self.ragged_windows += 1
        self.ragged_cones += len(packed)
        self.paged_stream_bytes += window_bytes
        self.cubes_dispatched += cubes_shipped
        self.cube_device_refutes += cube_refutes
        stats = SolverStatistics()
        stats.add_ragged_window(len(packed), window_bytes)
        if cubes_shipped:
            stats.add_cube_dispatch(cubes_shipped, cube_refutes)

        with trace_span("device.check", cat="device", queries=len(packed)):
            for i, (qi, num_vars, pc, dense, _extra) in enumerate(packed):
                assignment = solved.get(i)
                if assignment is None:
                    self.fallbacks += 1
                    continue
                bits = self.bits_from_circuit_assignment(
                    pc, dense, num_vars, assignment)
                if self._honors(bits, problems[qi][1]):
                    results[qi] = bits
                    self.batch_sat += 1
                    self.sat_found += 1
                else:
                    self.fallbacks += 1
                    log.warning(
                        "ragged circuit model failed host clause check")
        self.device_seconds += time.monotonic() - call_start
        return results

    def cube_entries(self, pc, extra, cube_vars: int, caps,
                     stream_budget: int):
        """The cube second pass's stream entries for one missed cone: the
        cone replicated once per cube of its plan, each replica asserting
        the cube's pins as extra roots; [] when no plan fits. With K1's
        KernelCaps the replica stream must fit K1: the root capacity, the
        var capacity and the cone slots. With `caps` None (K2, which has
        no capacities) the replicated pages must fit circuit.MAX_VARS, as
        in mythril_tpu. Either way the per-stream byte budget holds."""
        replica_bytes = max(stream_budget // max(
            self.ragged_entry_bytes(pc), 1), 1)
        if caps is None:
            max_cubes = min((circuit.MAX_VARS - 1) // max(pc.v1 - 1, 1),
                            replica_bytes)
            plan = cubes.plan_cubes(pc, cube_vars, max_cubes)
            return [(pc, tuple(extra) + tuple(cube)) for cube in plan]
        if pc.num_roots + len(extra) + cube_vars > caps.root_cap:
            return []
        max_cubes = min(
            (caps.var_cap - 1) // max(pc.v1 - 1, 1),
            caps.cone_cap, replica_bytes)
        plan = cubes.plan_cubes(pc, cube_vars, max_cubes)
        return [(pc, tuple(extra) + tuple(cube)) for cube in plan]

    def _solve_ragged_stream(self, entries, deadline, num_restarts: int,
                             steps: int, stop_at_first: bool = False):
        """Assemble, upload, and run ONE ragged stream until every cone is
        solved, the search stalls for STALL_ROUNDS rounds, or the deadline
        passes (`stop_at_first`: until any entry is solved — one cube's
        model settles its cone). Returns ({entry index: local cone
        assignment}, stream bytes, completed): completed is False when
        the deadline cut the search. The kernel mode picks the round: K1
        in "pallas" mode, and K2 for a stream past one of K1's capacities
        or in "xla" mode."""
        if ragged_kernel.kernel_mode() == "pallas":
            out = self._solve_ragged_stream_k1(entries, deadline,
                                               num_restarts, steps,
                                               stop_at_first)
            if out is not None:
                return out
            log.debug("ragged stream exceeds a K1 capacity; it runs on K2")
        return self._solve_ragged_stream_xla(entries, deadline,
                                             num_restarts, steps,
                                             stop_at_first)

    def _solve_ragged_stream_k1(self, entries, deadline, num_restarts: int,
                                steps: int, stop_at_first: bool):
        """The stream on K1, at its fixed capacities over the exact
        stream; None when the stream exceeds one of them."""
        caps = ragged_kernel.kernel_caps()
        ship_start = time.monotonic()
        stream = circuit.RaggedStream(entries)
        if not stream.ok:
            self.ragged_seconds += time.monotonic() - ship_start
            return {}, 0, False
        flat = ragged_kernel.flatten_stream(stream, caps)
        if flat is None:
            self.ragged_seconds += time.monotonic() - ship_start
            return None
        if self.on_stream is not None:
            self.on_stream(stream, entries)
        upload_start = time.monotonic()
        flat = ragged_kernel.device_flat(flat, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        self.ship_seconds += now - upload_start
        self.ship_bytes += int(sum(t.numel() * t.element_size()
                                   for t in flat.arrays.values()))
        self.ragged_seconds += now - ship_start
        lanes = ragged_kernel.pad_lanes(num_restarts, caps)
        # a launch steps the block-aligned real-gate stream twice per
        # step (sim + walk)
        cells_per_round = steps * 2 * flat.padded_cells
        walk_depth = min(stream.num_levels + 4, circuit.MAX_LEVELS)
        stats = SolverStatistics()

        def launch(x, seed):
            x, found = ragged_kernel.run_round_ragged_kernel(
                flat, x, seed=seed, steps=steps, walk_depth=walk_depth,
                caps=caps)
            self.kernel_launches += 1
            self.kernel_cells_stepped += cells_per_round
            stats.add_kernel_launch(cells_per_round)
            return x, found

        return self._round_loop(stream, launch, lanes, caps.var_cap,
                                cells_per_round, deadline, steps,
                                stop_at_first)

    def _solve_ragged_stream_xla(self, entries, deadline, num_restarts: int,
                                 steps: int, stop_at_first: bool):
        """The stream on K2 over the stream padded to its shape bucket, as
        mythril_tpu's XLA round takes it: K2 has no capacities."""
        ship_start = time.monotonic()
        stream = circuit.RaggedStream(entries, bucket=shape_bucket)
        if not stream.ok:
            self.ragged_seconds += time.monotonic() - ship_start
            return {}, 0, False
        if self.on_stream is not None:
            self.on_stream(stream, entries)
        # the tables and K2's per-cone layout, built on the device once
        # a stream: its bytes count as shipped, its build and syncs in
        # the ship and ragged stages
        upload_start = time.monotonic()
        xs = xla_kernel.device_stream(stream, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        self.ship_seconds += now - upload_start
        self.ship_bytes += xs.nbytes
        self.ragged_seconds += now - ship_start
        walk_depth = min(stream.num_levels + 4, circuit.MAX_LEVELS)

        def launch(x, seed):
            return xla_kernel.run_round_xla_kernel(
                xs, x, seed=seed, steps=steps, walk_depth=walk_depth)

        # mythril_tpu's cell unit for its XLA round: the bucketed
        # levels x width rectangle, sim + walk per step
        cells_per_round = steps * 2 * stream.num_levels * stream.width
        return self._round_loop(stream, launch, num_restarts, stream.v1,
                                cells_per_round, deadline, steps,
                                stop_at_first)

    def _round_loop(self, stream, launch, lanes: int, width: int,
                    cells_per_round: int, deadline, steps: int,
                    stop_at_first: bool):
        """Rounds of `launch(x, seed) -> (x, found)` over one uploaded
        stream from a seeded x of [lanes, width] until every cone is
        solved, STALL_ROUNDS rounds pass without a new one, `stop_at_first`
        is met, or the deadline passes; between rounds the first half of
        the lanes is re-drawn. Returns the _solve_ragged_stream triple."""
        self._seed += 1
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self._seed)
        x = circuit.init_inputs(generator, lanes, width, self.device)
        n = stream.num_cones
        solved = {}
        rounds = stall = 0
        solve_start = time.monotonic()
        with trace_span("device.kernel", cat="device", cones=n,
                        levels=stream.num_levels, width=stream.width,
                        restarts=lanes) as kernel_span:
            while True:
                x, found = launch(
                    x, (self._seed * 1000003 + rounds) & 0x7FFFFFFF)
                rounds += 1
                self.cells_stepped += cells_per_round
                self.flips += n * lanes * steps
                found_host = transfers.to_numpy(  # [lanes, cones]
                    found[:, :n], "ragged.found")
                newly = [ci for ci in range(n)
                         if ci not in solved and found_host[:, ci].any()]
                if newly:
                    stall = 0
                    x_host = transfers.to_numpy(x, "ragged.x")
                    for ci in newly:
                        lane = int(np.argmax(found_host[:, ci]))
                        solved[ci] = stream.cone_assignment(
                            ci, x_host[lane])
                else:
                    stall += 1
                if (len(solved) == n or stall >= self.STALL_ROUNDS
                        or (stop_at_first and solved)):
                    completed = True
                    break
                if time.monotonic() >= deadline:
                    completed = False
                    break
                # re-randomize half the lanes for diversification (solved
                # cones' assignments are already copied to host)
                half = lanes // 2
                if half:
                    x[:half] = circuit.init_inputs(
                        generator, half, width, self.device)
            kernel_span.set(rounds=rounds)
        self.solve_seconds += time.monotonic() - solve_start
        return solved, stream.nbytes, completed

    @staticmethod
    def bits_from_circuit_assignment(pc, dense, num_vars, assignment):
        """Translate a cone-local circuit assignment into CNF model bits.
        `pc.var_map` maps local -> global AIG var; `dense` (or None for
        identity) maps global -> the problem's compact CNF numbering."""
        bits = [False] * (num_vars + 1)
        for lvar, gvar in enumerate(pc.var_map):
            cvar = dense.get(gvar) if dense is not None else gvar
            if cvar is not None and 0 < cvar <= num_vars:
                bits[cvar] = bool(assignment[lvar])
        return bits

    @staticmethod
    def _honors(bits: List[bool], clauses) -> bool:
        if hasattr(clauses, "lits"):  # CNF buffers: vectorized check
            if clauses.has_empty:
                return False
            if not len(clauses):
                return True
            bits_arr = np.asarray(bits, dtype=bool)
            lits = clauses.lits
            values = np.where(lits > 0, bits_arr[np.abs(lits)],
                              ~bits_arr[np.abs(lits)])
            # per-clause any via reduceat (no empty segments: checked above)
            sat = np.logical_or.reduceat(values, clauses.offsets[:-1])
            return bool(sat.all())
        for clause in clauses:
            if not any(bits[lit] if lit > 0 else not bits[-lit]
                       for lit in clause):
                return False
        return True

    def stats(self) -> dict:
        return {
            "queries": self.queries,
            "sat_found": self.sat_found,
            "fallbacks": self.fallbacks,
            "batch_calls": self.batch_calls,
            "batch_queries": self.batch_queries,
            "batch_sat": self.batch_sat,
            "cap_rejects": self.cap_rejects,
            "pack_hits": self.pack_hits,
            "pack_misses": self.pack_misses,
            "pack_bytes": self.pack_bytes,
            "ship_bytes": self.ship_bytes,
            "cells_stepped": self.cells_stepped,
            "ragged_windows": self.ragged_windows,
            "ragged_cones": self.ragged_cones,
            "paged_stream_bytes": self.paged_stream_bytes,
            "ragged_seconds": round(self.ragged_seconds, 4),
            "cubes_dispatched": self.cubes_dispatched,
            "cube_device_refutes": self.cube_device_refutes,
            "kernel_launches": self.kernel_launches,
            "kernel_cells_stepped": self.kernel_cells_stepped,
            # K1, K2 and K3 each build once and take every window shape
            # at run time: nothing recompiles
            "kernel_recompiles": 0,
            # the kernel mode (MYTHRIL_GPU_KERNEL), as mythril_tpu stamps
            # it; the device is the stats JSON's "device" section
            "kernel_backend": ragged_kernel.kernel_mode(),
            "pack_seconds": round(self.pack_seconds, 4),
            "ship_seconds": round(self.ship_seconds, 4),
            "solve_seconds": round(self.solve_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "flips": self.flips,
            "flips_per_second": (
                round(self.flips / self.device_seconds)
                if self.device_seconds else 0
            ),
        }
