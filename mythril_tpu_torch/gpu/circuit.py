"""Justification-based circuit SLS — host side of the device solver.

The search runs over the AIG *inputs* only:

  1. forward-simulate the levelized AIG — every gate is consistent by
     construction, so the ONLY possible violations are the asserted root
     literals;
  2. pick a violated root;
  3. walk backward through its justification frontier: at an AND gate
     whose output must be 1, descend into a child literal that is
     currently 0; at a gate whose output must be 0, descend into a
     currently-true child; stop when the subgoal is already justified or
     an input variable is reached;
  4. flip that input to the wanted value; resimulate.

A satisfying input assignment found this way satisfies the WHOLE CNF after
one simulation pass. This module holds the host side: the levelized cone
(PackedCircuit, and its copy padded to a batch shape for the bucketed
path), the window of cones packed into one flat stream (RaggedStream) and
the restart-lane initialisation. The rounds themselves are the CUDA
kernels in gpu/ragged_kernel.py (a ragged stream) and
gpu/circuit_kernel.py (a bucketed batch of padded cones).

Shapes: x is [R, V1] int32 in {0,1} (var 0 pinned to 0 = constant FALSE;
literal value = x[var] ^ neg). Level tensors [L, G]; per-var gate tables
[V1]. Padding gates read and write var 0 with value 0 — a no-op.
"""

from typing import List, NamedTuple

import numpy as np
import torch

from mythril_tpu_torch.gpu.ragged_kernel import _MASK32, _hash32
from mythril_tpu_torch.observe import transfers

# caps: circuits past these take the CDCL path
MAX_LEVELS = 4096
MAX_VARS = 1 << 18


def exact(n: int) -> int:
    """RaggedStream's default padding: none. The kernel is sized by its
    fixed capacities, never by the window shape (mythril_tpu passes its
    1.5x shape bucket here for the XLA rounds, which compile per shape)."""
    return max(int(n), 1)


class PackedCircuit:
    """Levelized AIG cone of the asserted roots, as dense numpy tensors.

    `ok` is False when the roots are trivially unsatisfiable or the
    circuit exceeds the device caps."""

    __slots__ = ("var_map", "v1", "num_levels", "max_width",
                 "out_idx", "a_var", "a_neg", "b_var", "b_neg",
                 "ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate",
                 "root_var", "root_neg", "root_mask", "ok", "num_roots",
                 "num_gates", "level_rows", "carry_local")

    def __init__(self, aig, roots: List[int], carry_lits=()):
        """`carry_lits`: literals whose cones are levelized INTO the
        circuit but NOT asserted as roots — the fork lane packs a pair's
        shared base roots once and carries the fork literal's node so
        each side can pin it via RaggedStream extra_roots (the cube
        mechanism). carry_local maps their global vars to local ids."""
        self.ok = False
        self.carry_local = {}
        gate_of_var = aig.gate_of_var  # incremental index (append-only AIG)

        live_roots = []
        for lit in roots:
            if lit == 1:  # constant TRUE root: vacuous
                continue
            if lit == 0:  # constant FALSE root: unsatisfiable
                return
            live_roots.append(lit)

        # cone of influence + levelization (iterative)
        level = {0: 0}
        stack = [lit >> 1 for lit in live_roots]
        stack.extend(lit >> 1 for lit in carry_lits if lit > 1)
        while stack:
            var = stack[-1]
            if var in level:
                stack.pop()
                continue
            gate = gate_of_var.get(var)
            if gate is None:
                level[var] = 0  # input
                stack.pop()
                continue
            lhs, rhs = gate
            children = (lhs >> 1, rhs >> 1)
            missing = [c for c in children if c not in level]
            if missing:
                stack.extend(missing)
            else:
                level[var] = 1 + max(level[c] for c in children)
                stack.pop()

        num_levels = max(level.values(), default=0)
        if num_levels > MAX_LEVELS or len(level) > MAX_VARS:
            return

        # compact local variable space: the AIG is SHARED across problems
        # (solver/frontend.py get_global_blaster), so tensors sized by the
        # global var count would grow with every query ever blasted. Local
        # id 0 stays the constant; var_map maps local -> global for model
        # extraction.
        cone_vars = sorted(v for v in level if v != 0)
        self.var_map = [0] + cone_vars
        local = {0: 0}
        for i, var in enumerate(cone_vars, start=1):
            local[var] = i
        for lit in carry_lits:
            if lit > 1:
                self.carry_local[lit >> 1] = local[lit >> 1]

        by_level: List[List[int]] = [[] for _ in range(num_levels + 1)]
        for var, lv in level.items():
            if lv > 0:
                by_level[lv].append(var)
        max_width = max((len(g) for g in by_level[1:]), default=1) or 1

        v1 = len(self.var_map)
        self.v1 = v1
        self.num_levels = num_levels
        self.max_width = max_width

        shape = (max(num_levels, 1), max_width)
        out_idx = np.zeros(shape, dtype=np.int32)
        a_var = np.zeros(shape, dtype=np.int32)
        a_neg = np.zeros(shape, dtype=np.int32)
        b_var = np.zeros(shape, dtype=np.int32)
        b_neg = np.zeros(shape, dtype=np.int32)
        ga_var = np.zeros((v1,), dtype=np.int32)
        ga_neg = np.zeros_like(ga_var)
        gb_var = np.zeros_like(ga_var)
        gb_neg = np.zeros_like(ga_var)
        is_gate = np.zeros_like(ga_var)
        for lv in range(1, num_levels + 1):
            for slot, var in enumerate(by_level[lv]):
                lhs, rhs = gate_of_var[var]
                lvar = local[var]
                la, lb = local[lhs >> 1], local[rhs >> 1]
                out_idx[lv - 1, slot] = lvar
                a_var[lv - 1, slot] = la
                a_neg[lv - 1, slot] = lhs & 1
                b_var[lv - 1, slot] = lb
                b_neg[lv - 1, slot] = rhs & 1
                ga_var[lvar], ga_neg[lvar] = la, lhs & 1
                gb_var[lvar], gb_neg[lvar] = lb, rhs & 1
                is_gate[lvar] = 1

        self.out_idx, self.a_var, self.a_neg = out_idx, a_var, a_neg
        self.b_var, self.b_neg = b_var, b_neg
        self.ga_var, self.ga_neg = ga_var, ga_neg
        self.gb_var, self.gb_neg = gb_var, gb_neg
        self.is_gate = is_gate
        # real gate counts (no level padding): per-level row occupancy and
        # its total. level_rows sizes a cone's share of a ragged stream
        # (gpu/backend.py chunking), which needs the level histogram
        self.level_rows = (self.out_idx > 0).sum(axis=1).astype(np.int64) \
            if self.num_levels else np.zeros((0,), dtype=np.int64)
        self.num_gates = int(is_gate.sum())

        self.num_roots = max(len(live_roots), 1)
        root_var = np.zeros((self.num_roots,), dtype=np.int32)
        root_neg = np.zeros_like(root_var)
        root_mask = np.zeros_like(root_var)
        for i, lit in enumerate(live_roots):
            root_var[i] = local[lit >> 1]
            root_neg[i] = lit & 1
            root_mask[i] = 1
        self.root_var, self.root_neg, self.root_mask = (
            root_var, root_neg, root_mask
        )
        self.ok = True

    @property
    def nbytes(self) -> int:
        """Total bytes of the packed (unpadded) tensors — the pack stage's
        work unit (pack_bytes)."""
        if not self.ok:
            return 0
        return int(sum(getattr(self, key).nbytes for key in TENSOR_KEYS))

    def padded_to(self, num_levels, max_width, v1, num_roots) -> dict:
        """Copy the tensors into a shared batch shape (the bucketed path's
        query axis): zero padding, so padded level cells read and write
        var 0 and padded roots are masked."""
        def pad2(a):
            out = np.zeros((max(num_levels, 1), max_width), dtype=np.int32)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        def pad1(a, n):
            out = np.zeros((n,), dtype=np.int32)
            out[: a.shape[0]] = a
            return out

        return dict(
            out_idx=pad2(self.out_idx), a_var=pad2(self.a_var),
            a_neg=pad2(self.a_neg), b_var=pad2(self.b_var),
            b_neg=pad2(self.b_neg),
            ga_var=pad1(self.ga_var, v1), ga_neg=pad1(self.ga_neg, v1),
            gb_var=pad1(self.gb_var, v1), gb_neg=pad1(self.gb_neg, v1),
            is_gate=pad1(self.is_gate, v1),
            root_var=pad1(self.root_var, num_roots),
            root_neg=pad1(self.root_neg, num_roots),
            root_mask=pad1(self.root_mask, num_roots),
        )


TENSOR_KEYS = ("out_idx", "a_var", "a_neg", "b_var", "b_neg",
               "ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate",
               "root_var", "root_neg", "root_mask")



class RaggedStream:
    """Flat packed gate stream over a WINDOW of variable-shape cones,
    with per-cone offset tables (paged gate tables).

    Instead of padding every cone to a common shape, the window's cones
    concatenate:

      variables  each cone's local var space (minus the shared constant
                 0) maps onto a contiguous page [base, base + v1 - 1) of
                 ONE combined space — cones are variable-disjoint by
                 construction, so the pages never alias;
      gates      level l of the combined circuit is the concatenation of
                 every cone's REAL level-l gates (the per-level padding
                 of the source PackedCircuits is stripped via the
                 out_idx > 0 mask), so the simulated cell count is the
                 sum of gate counts, not levels x max_width x cones;
      roots      per-cone paged root tables [C, R_max] (root literals
                 remapped into the page) — `extra_roots` appends cube
                 assumption literals as additional asserted roots, so
                 cube-and-conquer replicas ride the same stream.

    One kernel round then covers the whole window regardless
    of per-cone shape: per step it simulates the combined circuit once
    and walks/flips ONE input per cone (per restart lane), which is
    exactly the per-cone dispatch semantics minus the padding."""

    __slots__ = ("ok", "num_cones", "cone_slots", "v1", "num_levels",
                 "width", "max_roots", "pages", "tensors")

    def __init__(self, entries, bucket=None):
        """`entries`: sequence of (PackedCircuit, extra_roots) where
        extra_roots is a sequence of (local_var, want_bool) cube
        assumptions (empty for plain cones). Every pc must be `ok`.

        `bucket` pads the levels, row width, combined vars and roots
        (default `exact`: no padding); cone slots follow a pow2 ramp.
        Padding cone slots carry an all-zero root mask (satisfied at step
        0, walks park on var 0); padding vars and levels are inert var-0
        plumbing."""
        if bucket is None:
            bucket = exact
        self.ok = False
        self.num_cones = len(entries)
        if not entries:
            return
        pages = []
        cursor = 1
        num_levels = 0
        max_roots = 1
        for pc, extra in entries:
            if not pc.ok:
                return
            pages.append((cursor, pc.v1 - 1))
            cursor += pc.v1 - 1
            num_levels = max(num_levels, pc.num_levels)
            max_roots = max(max_roots, pc.num_roots + len(extra))
        self.pages = pages
        self.v1 = bucket(cursor)
        self.num_levels = bucket(max(num_levels, 1))
        self.max_roots = bucket(max_roots)
        # pow2 cone-slot ramp (cone counts are small; 1.5x buckets under
        # 64 would all collapse to 64 and waste root-table rows), STOPPED
        # at the coalescing window cone cap (scheduler
        # DEFAULT_COALESCE_MAX_RAGGED): windows only exceed it via cube
        # replica streams, and doubling past it allocated root-table rows
        # no window composition could fill (65 cones paid 128 slots).
        # Beyond the cap the slot count is exact — those oversized
        # streams are per-cone cube fans, not a recurring window shape
        # worth bucketing.
        slots = 1
        while slots < self.num_cones and slots < 64:
            slots *= 2
        self.cone_slots = max(slots, self.num_cones)

        # combined per-level rows: real gates only (out_idx > 0 strips the
        # source circuits' per-level padding), remapped into the page
        def remap(arr, base):
            return np.where(arr > 0, arr + (base - 1), 0).astype(np.int32)

        level_keys = ("out_idx", "a_var", "a_neg", "b_var", "b_neg")
        # per-cone scatter plan: each cone's live (real-gate) cells land
        # at its running per-level offset in one fancy-index assignment
        # per (cone, key) — assembly wall accrues into ragged_seconds, and
        # an O(cones x levels) python loop here would dominate it
        offsets = np.zeros((num_levels,), dtype=np.int64)
        placements = []  # (pc, base, live mask, level idx, column idx)
        for (pc, _extra), (base, _size) in zip(entries, pages):
            live = pc.out_idx > 0
            if not live.any():
                continue
            lv_idx = np.nonzero(live)[0]
            rank = (live.cumsum(axis=1) - 1)[live]
            placements.append((pc, base, live, lv_idx,
                               offsets[lv_idx] + rank))
            offsets[: pc.num_levels] += live.sum(axis=1)
        self.width = bucket(max(int(offsets.max()) if num_levels else 1, 1))

        tensors = {}
        for key in level_keys:
            out = np.zeros((self.num_levels, self.width), dtype=np.int32)
            for pc, base, live, lv_idx, col_idx in placements:
                src = getattr(pc, key)[live]
                if key in ("out_idx", "a_var", "b_var"):
                    src = remap(src, base)
                out[lv_idx, col_idx] = src
            tensors[key] = out

        # combined per-var gate tables (page-sliced copies)
        for key in ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate"):
            out = np.zeros((self.v1,), dtype=np.int32)
            for (pc, _extra), (base, size) in zip(entries, pages):
                src = getattr(pc, key)[1:]
                if key in ("ga_var", "gb_var"):
                    src = remap(src, base)
                out[base: base + size] = src
            tensors[key] = out

        # per-cone paged root tables (cone roots + cube assumption roots;
        # padding cone slots keep an all-zero mask)
        root_var = np.zeros((self.cone_slots, self.max_roots),
                            dtype=np.int32)
        root_neg = np.zeros_like(root_var)
        root_mask = np.zeros_like(root_var)
        for ci, ((pc, extra), (base, _size)) in enumerate(
                zip(entries, pages)):
            n = pc.num_roots
            root_var[ci, :n] = remap(pc.root_var, base)
            root_neg[ci, :n] = pc.root_neg
            root_mask[ci, :n] = pc.root_mask
            for j, (lvar, want) in enumerate(extra):
                root_var[ci, n + j] = lvar + base - 1 if lvar > 0 else 0
                root_neg[ci, n + j] = 0 if want else 1
                root_mask[ci, n + j] = 1
        tensors["root_var"] = root_var
        tensors["root_neg"] = root_neg
        tensors["root_mask"] = root_mask
        self.tensors = tensors
        self.ok = True

    @property
    def nbytes(self) -> int:
        """Assembled stream bytes — the ragged pack/ship work unit
        (paged_stream_bytes)."""
        if not self.ok:
            return 0
        return int(sum(self.tensors[k].nbytes for k in TENSOR_KEYS))

    def cone_assignment(self, ci: int, x_row: np.ndarray) -> np.ndarray:
        """Slice one cone's local assignment out of a combined restart
        row: local var v (v >= 1) lives at combined index base + v - 1;
        local var 0 is the shared constant FALSE."""
        base, size = self.pages[ci]
        out = np.zeros((size + 1,), dtype=x_row.dtype)
        out[1:] = x_row[base: base + size]
        return out



def init_inputs(generator: torch.Generator, num_restarts: int, v1: int,
                device) -> torch.Tensor:
    """Uniform random restart lanes [num_restarts, v1] int32 in {0, 1},
    var 0 pinned to the constant FALSE. `generator` lives on `device`."""
    x = torch.randint(0, 2, (num_restarts, v1), generator=generator,
                      device=device, dtype=torch.int32)
    x[:, 0] = 0
    return x


# -- K4: the bucketed round sharded over a dp x mp mesh -----------------------

# a shard's id, dp index * SHARD_DP_STRIDE + mp index, as the JAX package
# folds it into its keys (mythril_tpu/tpu/circuit.py:648-650)
SHARD_DP_STRIDE = 7919
_C_SHARD = 0x2545F491


def shard_seed(seed: int, shard_id: int) -> int:
    """A round's seed folded with a shard id, the port's twin of
    `jax.random.fold_in(key, shard_id)`: the 32-bit mix
    hash32(seed ^ hash32((shard_id + C_SHARD) mod 2^32)), cut to the 31
    bits the kernels take. Shard 0 folds too, as in the reference."""
    folded = _hash32((int(seed) & _MASK32)
                     ^ _hash32((int(shard_id) + _C_SHARD) & _MASK32))
    return int(folded) & 0x7FFFFFFF


class ShardGrid:
    """One array sharded over a mesh: blocks[i][j] is shard (i, j)'s block
    on its device, the query axis split over dp, the lane axis over mp
    (the reference's P("dp", "mp", ...))."""

    def __init__(self, mesh, blocks):
        self.mesh = mesh
        self.blocks = tuple(tuple(row) for row in blocks)

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.blocks[i][j]

    def row(self, slot: int, site: str = "mesh.row") -> torch.Tensor:
        """Query slot `slot`'s whole lane axis (the mp blocks of its dp
        block joined) on the host, each block's copy counted under
        `site` (observe/transfers.py)."""
        qs = self.blocks[0][0].shape[0]
        return torch.cat([transfers.to_host(block[slot % qs], site)
                          for block in self.blocks[slot // qs]])

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (default: the mesh's lead)."""
        device = self.mesh.lead if device is None else device
        return torch.cat([torch.cat([b.to(device) for b in row], dim=1)
                          for row in self.blocks], dim=0)


def shard_lanes(mesh, x: torch.Tensor) -> ShardGrid:
    """x [Q, R, V1] split into contiguous blocks, Q over dp and R over mp,
    each on its shard's device."""
    q_count, lanes = x.shape[:2]
    if q_count % mesh.dp or lanes % mesh.mp:
        raise ValueError(f"x of shape {tuple(x.shape)} does not split over "
                         f"a {mesh.dp} x {mesh.mp} mesh")
    qs, rs = q_count // mesh.dp, lanes // mesh.mp
    return ShardGrid(mesh, [
        [x[i * qs:(i + 1) * qs, j * rs:(j + 1) * rs].to(
            mesh.shard(i, j)).contiguous() for j in range(mesh.mp)]
        for i in range(mesh.dp)])


class ShardedTables(NamedTuple):
    """A batch's tables placed on a mesh: tables[i][j] is dp block i's
    TENSOR_KEYS on shard (i, j)'s device and layouts[i][j] its
    circuit_layout (K3's side input). Shards of one dp block on one device
    share one copy and one layout."""
    mesh: object
    tables: tuple
    layouts: tuple


def shard_tables(mesh, tensors: dict) -> ShardedTables:
    """Place a batch's tables (every TENSOR_KEYS array with a leading
    query axis, Q divisible by dp) on the mesh, and build each placed
    block's circuit_layout once."""
    from mythril_tpu_torch.gpu import circuit_kernel

    q_count = tensors["out_idx"].shape[0]
    if q_count % mesh.dp:
        raise ValueError(f"{q_count} query slots do not split over dp "
                         f"{mesh.dp}")
    qs = q_count // mesh.dp
    placed = {}
    tables, layouts = [], []
    for i in range(mesh.dp):
        row_tables, row_layouts = [], []
        for j in range(mesh.mp):
            device = mesh.shard(i, j)
            if (i, device) not in placed:
                block = {key: tensors[key][i * qs:(i + 1) * qs].to(
                    device).contiguous() for key in TENSOR_KEYS}
                placed[i, device] = (block,
                                     circuit_kernel.circuit_layout(block))
            block, layout = placed[i, device]
            row_tables.append(block)
            row_layouts.append(layout)
        tables.append(tuple(row_tables))
        layouts.append(tuple(row_layouts))
    return ShardedTables(mesh, tuple(tables), tuple(layouts))


def make_sharded_round(mesh, steps: int, walk_depth: int):
    """K4, the twin of mythril_tpu/tpu/circuit.py make_sharded_round
    (:631-669): the bucketed round with queries sharded over the mesh's
    "dp" axis and restart lanes over "mp", each shard's seed folded with
    its shard id, and the solved verdict reduced over "mp".

    Returns fn(placed, x, seed) -> (x, found, solved). `placed` is
    shard_tables' placement of a batch's tables (a leading query axis
    divisible by dp), x shard_lanes' grid of the lanes [Q, R, V1] (R
    divisible by mp). Each shard runs K3
    (circuit_kernel.run_round_circuit_kernel: the CUDA kernel on a card,
    the plain round on CPU tensors) on its own blocks with
    shard_seed(seed, dp index * 7919 + mp index), on its device's current
    stream; every launch is queued before anything is gathered. x and
    found come back as ShardGrids ([Q, R, V1] and [Q, R] when gathered);
    solved [Q] bool, on the mesh's lead device, is the MAX over a query's
    mp shards of its lanes' found (the reference's pmax)."""
    from mythril_tpu_torch.gpu import circuit_kernel

    def sharded_round(placed, grid, seed):
        xs, founds = [], []
        for i in range(mesh.dp):
            row_x, row_found = [], []
            for j in range(mesh.mp):
                # K3's wrapper launches on the shard's device's stream
                out_x, found = circuit_kernel.run_round_circuit_kernel(
                    placed.tables[i][j], grid.block(i, j),
                    shard_seed(seed, i * SHARD_DP_STRIDE + j), steps,
                    walk_depth, layout=placed.layouts[i][j])
                row_x.append(out_x)
                row_found.append(found)
            xs.append(row_x)
            founds.append(row_found)
        lead = mesh.lead
        solved = torch.cat([
            torch.stack([found.any(dim=1).to(lead) for found in row])
            .any(dim=0) for row in founds])
        return ShardGrid(mesh, xs), ShardGrid(mesh, founds), solved

    return sharded_round
