"""K3's layout (mythril_tpu_torch/gpu/circuit_kernel.circuit_layout) and
its tiers (launch_shape) on the CPU.

- The layout decodes back to exactly the live cells, level by level, and
  the per-variable and root tables of the padded batch: on 30
  circuit_batch seeds, the sibling window's padded batch, a big_cone
  batch, and the wide layout (V1 past 32,768).
- It raises on a batch the kernel would not compute exactly (a cell that
  disagrees with its out variable's record, a cell reading its own level,
  an out variable with two cells, an index out of range).
- launch_shape picks each tier, the lanes a word and a resident stream at
  their thresholds.
- The kernel's algorithm over the layout, emulated here (bit-sliced lane
  groups of launch_shape's width, the stream in steps with a barrier at a
  level's end, the records with is_gate folded in, the early stop of a
  group whose lanes are all found), equals the plain round bit for bit.
  The CUDA kernel itself is held to the plain round on the card
  (tests/test_torch_cuda_circuit.py, chip_smoke.py).
- The launch: the wrapper's arguments (launch_arguments), read back the
  way csrc/circuit_round.cu reads them (the C signature's order, each
  table's length from the sizes and the kernel's own constants, the
  block's shared memory), drive the emulation over the raw buffers.
"""

import ctypes
import os
import random
import re

import numpy as np
import pytest
import torch

import mythril_tpu_torch.smt as port_smt
from mythril_tpu_torch.gpu import circuit_kernel
from mythril_tpu_torch.gpu.circuit import PackedCircuit
from mythril_tpu_torch.gpu.ragged_kernel import (
    _C_COIN,
    _C_CONE,
    _C_DEPTH,
    _C_LANE,
    _C_ROOT,
    _C_STEP,
    _hash32,
    _mul32,
)
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support.workloads import (
    big_cone,
    circuit_batch,
    sibling_window,
)


def _layout(batch):
    return circuit_kernel.circuit_layout(
        circuit_kernel.device_batch(batch, "cpu"))


def slots(layout, q):
    """The query's stream slots as (out, a0, a1, a, b0, b1, b, pair end,
    second level): variables and literals, read back from the byte
    offsets and masks of circuit_layout's format."""
    shape = circuit_kernel.launch_shape(layout.v1, layout.stride)
    word = shape.lanes_per_word // 8
    body = layout.stream[q, :int(layout.stream_steps[q])].numpy().astype(
        np.int64) & 0xFFFFFFFF  # [steps, 2, 32, 4]
    head, masks = body[:, 0, :, 0], body[:, 1, :, 0]

    def lit(offset, k):
        return offset // word * 2 + ((masks >> (8 * k)) & 1)

    return np.stack((
        (head & 0x3FFFFFFF) // word,
        lit(body[:, 0, :, 1], 0), lit(body[:, 0, :, 2], 1), body[:, 0, :, 3],
        lit(body[:, 1, :, 1], 2), lit(body[:, 1, :, 2], 3), body[:, 1, :, 3],
        (head >> 30) & 1, head >> 31), -1)  # [steps, 32, 9]


def decode(layout):
    """Per query: (levels, each a list of (out, a, a_neg, b, b_neg) in
    stream order; the per-variable tables; the root tables), read back
    from the layout alone. Each second-level cell's operands are checked
    on the way: a first-level child's own inputs, else the child twice."""
    records = layout.records.numpy().astype(np.int64) & 0xFFFFFFFF
    out = []
    for q in range(len(records)):
        if records.ndim == 3:  # wide
            lit_a, lit_b = records[q, :, 0], records[q, :, 1]
        else:
            lit_a, lit_b = records[q] & 0xFFFF, records[q] >> 16
        body = slots(layout, q)
        ends = body[:, :, 7]
        assert (ends == ends[:, :1]).all(), "a step lies in one pair"
        levels, pair = [], ([], [])
        for s, step in enumerate(body):
            for o, a0, a1, a, b0, b1, b, _end, second in step:
                if not o:
                    continue
                firsts = {cell[0] for cell in pair[0]} if second else ()
                for lit, lo, hi in ((a, a0, a1), (b, b0, b1)):
                    var = lit >> 1
                    want = (lit_a[var], lit_b[var]) if var in firsts \
                        else (2 * var, 2 * var)
                    assert (lo, hi) == want, (q, s, o)
                pair[second].append((int(o), int(a >> 1), int(a & 1),
                                     int(b >> 1), int(b & 1)))
            if ends[s, 0]:
                levels += [cells for cells in pair if cells]
                pair = ([], [])
        assert not any(pair), "the stream ends on a pair's last step"
        v1 = layout.v1
        var = np.arange(v1)
        gate = (lit_a[:v1] >> 1) != var
        tables = {"is_gate": gate.astype(np.int32)}
        for key, lit in (("ga", lit_a[:v1]), ("gb", lit_b[:v1])):
            tables[f"{key}_var"] = np.where(gate, lit >> 1, 0)
            tables[f"{key}_neg"] = np.where(gate, lit & 1, 0)
        roots = layout.roots[q].numpy().astype(np.int64) & 0xFFFFFFFF
        tables.update(root_var=roots >> 2, root_neg=(roots >> 1) & 1,
                      root_mask=roots & 1)
        out.append((levels, tables))
    return out


def assert_decodes_to(batch):
    layout = _layout(batch)
    for q, (levels, tables) in enumerate(decode(layout)):
        want = []
        for level in range(batch["out_idx"].shape[1]):
            cols = np.nonzero(batch["out_idx"][q, level] > 0)[0]
            if len(cols):
                want.append([tuple(int(batch[key][q, level, c]) for key in
                                   circuit_kernel.LEVEL_KEYS) for c in cols])
        assert levels == want, q
        for key, value in tables.items():
            np.testing.assert_array_equal(value, batch[key][q],
                                          err_msg=f"{key} of query {q}")
    return layout


def _stacked(pcs, min_v1=0):
    shape = (max(pc.num_levels for pc in pcs), max(pc.max_width for pc in pcs),
             max(max(pc.v1 for pc in pcs), min_v1),
             max(pc.num_roots for pc in pcs))
    slots = 1
    while slots < len(pcs):
        slots *= 2
    return circuit_kernel.stack_padded(pcs, shape, slots)


@pytest.mark.parametrize("seed", range(30))
def test_layout_decodes_to_the_random_batch(seed):
    layout = assert_decodes_to(circuit_batch(random.Random(seed)))
    assert layout.records.dim() == 2, "16-bit records below 32,768 vars"


def test_layout_decodes_to_the_sibling_window(monkeypatch):
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    pcs = []
    for constraints in sibling_window(port_smt, 8, seed=5):
        solver = port_frontend.Solver(timeout=20)
        solver.add(constraints)
        prep = solver._prepare([])
        if prep.trivial is None:
            pcs.append(PackedCircuit(prep.aig_roots[0], prep.aig_roots[1]))
    assert len(pcs) >= 6
    assert_decodes_to(_stacked(pcs))


def test_layout_decodes_to_a_big_cone_and_the_wide_layout():
    pc = big_cone(random.Random(3), gates=6000, reach=256, roots=8)
    layout = assert_decodes_to(_stacked([pc]))
    steps = int(layout.stream_steps[0])
    # a pair of levels takes ceil(cells / 32) steps
    live = (pc.out_idx > 0).sum(axis=1)
    live = live[live > 0]
    pairs = np.add.reduceat(live, np.arange(0, len(live), 2))
    assert steps == int(((pairs + 31) // 32).sum())
    assert layout.stride % circuit_kernel.CHUNK_STEPS == 0
    wide = assert_decodes_to(_stacked([pc], min_v1=circuit_kernel.NARROW_V1
                                      + 1))
    assert wide.records.shape[-1] == 2
    assert torch.equal(wide.stream, layout.stream)
    # second-level cells read first-level children's inputs in their place
    cells = slots(layout, 0)
    assert ((cells[..., 8] == 1) & (cells[..., 1] >> 1 != cells[..., 3] >> 1)
            ).any()


def _defect(batch, kind):
    """A copy of `batch` with one defect the kernel cannot compute
    exactly."""
    batch = {key: value.copy() for key, value in batch.items()}
    q, level, col = (int(i[0]) for i in np.nonzero(batch["out_idx"] > 0))
    if kind == "record":
        batch["a_neg"][q, level, col] ^= 1
        return batch, "children equal"
    if kind == "not a gate":
        batch["is_gate"][q, batch["out_idx"][q, level, col]] = 0
        return batch, "is a gate"
    # the last level's first cell
    q = int(np.nonzero((batch["out_idx"] > 0).any(axis=(1, 2)))[0][0])
    level = int(np.nonzero((batch["out_idx"][q] > 0).any(axis=1))[0][-1])
    cols = np.nonzero(batch["out_idx"][q, level] > 0)[0]
    out = int(batch["out_idx"][q, level, cols[0]])
    if kind == "own level":
        # a second cell on the level reads the first one's out variable
        spare = int(np.nonzero(batch["out_idx"][q, level] == 0)[0][0])
        other = int(np.nonzero(batch["is_gate"][q] == 0)[0][-1])
        for key, value in (("out_idx", other), ("a_var", out), ("a_neg", 0),
                           ("b_var", out), ("b_neg", 0)):
            batch[key][q, level, spare] = value
        batch["is_gate"][q, other] = 1
        batch["ga_var"][q, other] = batch["gb_var"][q, other] = out
        batch["ga_neg"][q, other] = batch["gb_neg"][q, other] = 0
        return batch, "lower levels"
    if kind == "two cells":
        spare = int(np.nonzero(batch["out_idx"][q, level] == 0)[0][0])
        for key in circuit_kernel.LEVEL_KEYS:
            batch[key][q, level, spare] = batch[key][q, level, cols[0]]
        return batch, "one live cell"
    assert kind == "range"
    batch["b_var"][q, level, cols[0]] = batch["is_gate"].shape[1]
    return batch, r"lie in \[0, V1\)"


@pytest.mark.parametrize("kind", ["record", "not a gate", "own level",
                                  "two cells", "range"])
def test_layout_raises_on_a_batch_it_cannot_compute(kind):
    rng = random.Random(11)
    batch = circuit_batch(rng, max_queries=2)
    while (batch["out_idx"] == 0).sum(axis=2).min() == 0:
        batch = circuit_batch(rng, max_queries=2)  # a spare cell a level
    _layout(batch)  # the batch itself is fine
    broken, message = _defect(batch, kind)
    with pytest.raises(ValueError, match=message):
        _layout(broken)


@pytest.mark.parametrize("v1, tier, lanes", [
    (1, "shared32", 32), (16384, "shared32", 32), (16385, "shared16", 16),
    (32768, "shared16", 16), (32769, "xshared", 32), (49152, "xshared", 32),
    (49153, "xshared", 16), (98304, "xshared", 16), (98305, "xshared", 8),
    (196608, "xshared", 8), (196609, "global", 32), (1 << 18, "global", 32)])
def test_launch_shape_picks_each_tier_at_its_threshold(v1, tier, lanes):
    shape = circuit_kernel.launch_shape(v1, circuit_kernel.CHUNK_STEPS)
    assert (shape.tier, shape.lanes_per_word) == (tier, lanes)
    assert shape.smem_bytes <= circuit_kernel.SMEM_CAP
    ring = circuit_kernel.launch_shape(v1, 1 << 14)
    assert not ring.resident, "16,384 steps never fit"
    assert ring.smem_bytes <= circuit_kernel.SMEM_CAP


def test_launch_shape_streams_what_does_not_fit():
    cap = circuit_kernel.SMEM_CAP
    ring_bytes = circuit_kernel.RING * circuit_kernel.CHUNK_BYTES
    # shared32 at 16,384 vars: 128 KiB of x and records, 96 KiB of stream
    room = (cap - 8 * 16384) // (32 * circuit_kernel.ENTRY_BYTES)
    assert circuit_kernel.launch_shape(16384, room).resident
    ring = circuit_kernel.launch_shape(16384,
                                       room + circuit_kernel.CHUNK_STEPS)
    assert not ring.resident
    assert ring.smem_bytes == 8 * 16384 + ring_bytes
    # shared16 at 32,768 vars: x, the records and the ring fill the cap
    assert circuit_kernel.launch_shape(32768, 1 << 14).smem_bytes == cap
    # the global tier keeps only the stream in shared memory
    shape = circuit_kernel.launch_shape(300000, 10 ** 6)
    assert (shape.tier, shape.resident) == ("global", False)
    assert shape.smem_bytes == ring_bytes


# -- the kernel's algorithm, emulated -----------------------------------------


def emulate(layout, x, seed, steps, walk_depth):
    """circuit_round.cu's round over `layout`, in numpy: per (query, lane
    group of launch_shape's width) the simulate in stream steps (each
    step's slots read, then written), thread k's root check, walk and
    flip on lane k, the group's early stop. Returns (x, found)."""
    q_count, lanes, v1 = x.shape
    shape = circuit_kernel.launch_shape(v1, layout.stride)
    width = shape.lanes_per_word
    records = layout.records.numpy().astype(np.int64)
    if records.ndim == 2:
        word = records & 0xFFFFFFFF
        records = np.stack((word & 0xFFFF, word >> 16), -1)
    roots = layout.roots.numpy().astype(np.int64) & 0xFFFFFFFF
    x = x.numpy().copy()
    found_out = np.zeros((q_count, lanes), dtype=bool)
    seed = int(seed) & 0x7FFFFFFF
    for q in range(q_count):
        rec = records[q]
        # each step's slots read only what earlier steps wrote: one at a
        # time is the same as all at once
        gates = slots(layout, q)[..., :7].reshape(-1, 7)
        gates = gates[gates[:, 0] > 0]
        for lane0 in range(0, lanes, width):
            group = slice(lane0, min(lane0 + width, lanes))
            xs = x[q, group]  # a view: the group's rows

            def lit(value):
                return xs[:, value >> 1] ^ (value & 1)

            def simulate():
                xs[:, 0] = 0
                for o, a0, a1, a, b0, b1, b in gates:
                    xs[:, o] = ((lit(a0) & lit(a1)) ^ (a & 1)) \
                        & ((lit(b0) & lit(b1)) ^ (b & 1))

            def check(k, key_base):
                best_key, best = -1, 0
                for j, r in enumerate(roots[q]):
                    if r & 1 and xs[k, r >> 2] == (r >> 1) & 1:
                        key = int(_hash32(key_base ^ _mul32(j, _C_ROOT))) >> 1
                        if key > best_key:
                            best_key, best = key, j
                return best_key >= 0, best

            found = [False] * len(xs)
            salts = [_mul32(q, _C_CONE) ^ _mul32(lane0 + k, _C_LANE)
                     for k in range(len(xs))]
            final = True
            for step in range(steps):
                simulate()
                step_key = int(_hash32(seed ^ _mul32(step, _C_STEP)))
                picks = {}
                for k in range(len(xs)):
                    if not found[k]:
                        violated, choice = check(k, step_key ^ salts[k])
                        found[k] = not violated
                        if violated:
                            picks[k] = choice
                if all(found):
                    final = False
                    break
                for k, choice in picks.items():
                    r = roots[q, choice]
                    cur, want = int(r >> 2), 1 ^ int((r >> 1) & 1)
                    coin_base = step_key ^ _C_COIN ^ salts[k]
                    for depth in range(walk_depth):
                        a, b = (int(v) for v in rec[cur])
                        if a >> 1 == cur:
                            break  # not a gate
                        av = int(xs[k, a >> 1]) ^ (a & 1)
                        bv = int(xs[k, b >> 1]) ^ (b & 1)
                        if av & bv == want:
                            break
                        coin = int(_hash32(coin_base
                                           ^ _mul32(depth, _C_DEPTH))) & 1
                        # the kernel's form of the choice
                        choose_b = (bv ^ want) & ((av ^ want ^ 1) | coin)
                        cur = (b if choose_b else a) >> 1
                        want ^= (b if choose_b else a) & 1
                    xs[k, cur] = want
            if final:
                simulate()
                for k in range(len(xs)):
                    if not found[k]:
                        found[k] = not check(k, salts[k])[0]
            found_out[q, group] = found
    return torch.as_tensor(x), torch.as_tensor(found_out)


@pytest.mark.parametrize("seed, lanes, steps, min_v1", [
    (1, 1, 12, 0), (2, 31, 8, 0), (3, 33, 6, 0), (4, 5, 0, 0),
    (5, 17, 10, 20000), (6, 9, 6, 40000), (7, 40, 4, 0)])
def test_emulated_kernel_equals_the_plain_round(seed, lanes, steps, min_v1):
    rng = random.Random(seed)
    batch = circuit_batch(rng, max_queries=4, min_v1=min_v1)
    tensors = circuit_kernel.device_batch(batch, "cpu")
    layout = circuit_kernel.circuit_layout(tensors)
    q_count, levels = batch["out_idx"].shape[:2]
    x = torch.as_tensor(np.random.RandomState(seed).randint(
        0, 2, (q_count, lanes, batch["ga_var"].shape[1])), dtype=torch.int32)
    walk = rng.choice((levels + 4, rng.randint(0, levels + 4)))
    got_x, got_found = emulate(layout, x, seed * 7, steps, walk)
    want_x, want_found = circuit_kernel.run_round_circuit_plain(
        tensors, x, seed * 7, steps, walk)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_found, want_found)


def test_plain_round_counts_walks_without_changing_its_result():
    batch = circuit_batch(random.Random(8), max_queries=4)
    tensors = circuit_kernel.device_batch(batch, "cpu")
    q_count, levels = batch["out_idx"].shape[:2]
    x = torch.as_tensor(np.random.RandomState(8).randint(
        0, 2, (q_count, 6, batch["ga_var"].shape[1])), dtype=torch.int32)
    walks = []
    got = circuit_kernel.run_round_circuit_plain(tensors, x, 3, 5,
                                                 levels + 4, walks=walks)
    want = circuit_kernel.run_round_circuit_plain(tensors, x, 3, 5,
                                                  levels + 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(walks) == 5
    for length, walked in walks:
        assert length.shape == walked.shape == (q_count, 6)
        assert int(length.max()) <= levels
        assert not bool(length[~walked].any()), "a found lane walks not"


# -- the launch arguments, read the way the kernel reads them -----------------


def _kernel_source():
    """The kernel's source and the header of the warp-level pieces it
    includes (csrc/sliced_round.cuh)."""
    text = ""
    for path in (circuit_kernel.KERNEL_SOURCE, os.path.join(os.path.dirname(
            circuit_kernel.KERNEL_SOURCE), "sliced_round.cuh")):
        with open(path) as handle:
            text += handle.read()
    assert '#include "sliced_round.cuh"' in text
    return text


def _c_signature():
    """The parameter names of csrc/circuit_round.cu's circuit_round_launch."""
    params = re.search(r"int circuit_round_launch\(([^)]*)\)",
                       _kernel_source()).group(1)
    return [re.split(r"[\s*]+", part.strip())[-1]
            for part in params.split(",")]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _kernel_source()).group(1))


def _view(address, count):
    """A numpy int32 view of `count` elements at a raw address."""
    return np.ctypeslib.as_array((ctypes.c_int32 * count).from_address(
        address))


@pytest.mark.parametrize("seed, lanes, steps, min_v1", [
    (21, 5, 6, 0), (22, 33, 4, 20000), (23, 9, 5, 40000),
    (24, 3, 3, 200000)])
def test_launch_arguments_read_as_the_kernel_reads_them(seed, lanes, steps,
                                                        min_v1):
    """The C signature's parameters in the wrapper's order; every table's
    length as the kernel indexes it from the size arguments and its own
    constants (a step is 32 slots of kSlotQuads 16-byte quads, the stream
    `stride` steps a query, whole chunks of kChunkBytes); the block's
    shared memory inside the launch's; and the round emulated over the
    raw buffers equal to the plain round."""
    assert _c_signature() == list(circuit_kernel.ARG_ORDER)
    assert _constant("kThreads") == circuit_kernel.THREADS
    step_bytes = 32 * 16 * _constant("kSlotQuads")
    chunk_bytes, ring = _constant("kChunkBytes"), _constant("kRing")
    assert (chunk_bytes, ring) == (circuit_kernel.CHUNK_BYTES,
                                   circuit_kernel.RING)
    rng = random.Random(seed)
    batch = circuit_batch(rng, max_queries=3, min_v1=min_v1)
    tensors = circuit_kernel.device_batch(batch, "cpu")
    layout = circuit_kernel.circuit_layout(tensors)
    q_count, levels = batch["out_idx"].shape[:2]
    v1 = batch["ga_var"].shape[1]
    x = torch.as_tensor(np.random.RandomState(seed).randint(
        0, 2, (q_count, lanes, v1)), dtype=torch.int32)
    shape = circuit_kernel.launch_shape(v1, layout.stride)
    x_out = torch.full_like(x, 7)
    found = torch.zeros((q_count, lanes), dtype=torch.bool)
    groups = -(-lanes // shape.lanes_per_word)
    x_work = torch.zeros((q_count, groups, -(-v1 // 4) * 4),
                         dtype=torch.int32) if shape.tier == "global" \
        else None
    walk = levels + 4
    args = circuit_kernel.launch_arguments(layout, x, x_out, found, x_work,
                                           seed, steps, walk)
    assert list(args) == list(circuit_kernel.ARG_ORDER)
    q, v1p, stride, nr = (args[k] for k in ("queries", "v1p", "stride",
                                            "nr"))
    assert (q, args["lanes"], args["v1"]) == tuple(x.shape)
    assert circuit_kernel.TIERS[args["tier"]] == shape.tier
    narrow = shape.tier in ("shared32", "shared16")
    assert stride % (chunk_bytes // step_bytes) == 0
    lengths = {"records": q * (v1p if narrow else 2 * v1),
               "stream_table": q * stride * step_bytes // 4,
               "stream_steps": q, "roots": q * nr, "x_in": x.numel(),
               "x_out": x.numel()}
    buffers = {"records": layout.records, "stream_table": layout.stream,
               "stream_steps": layout.stream_steps, "roots": layout.roots,
               "x_in": x, "x_out": x_out}
    for key, length in lengths.items():
        assert args[key] == buffers[key].data_ptr(), key
        assert buffers[key].numel() == length, key
    assert args["found"] == found.data_ptr()
    if x_work is None:
        assert args["x_work"] is None
    else:
        assert args["x_work"] == x_work.data_ptr()
        assert x_work.numel() == q * groups * v1p
    assert (_view(args["stream_steps"], q) <= stride).all()
    # a block's shared memory, laid out as the kernel lays it out
    word = args["lanes_per_word"]
    need = (4 * v1p if narrow else 0) + (
        stride * step_bytes if args["resident"] else ring * chunk_bytes) + (
        v1p * word // 8 if shape.tier != "global" else 0)
    assert need <= args["smem_bytes"] <= 227 * 1024
    # the layout as the kernel sees it, read back from the raw buffers
    records = _view(args["records"], lengths["records"])
    seen = circuit_kernel.CircuitLayout(
        torch.as_tensor(records.reshape((q, v1p) if narrow else (q, v1, 2))),
        torch.as_tensor(_view(args["stream_table"], lengths["stream_table"])
                        .reshape(q, stride, 2, 32, 4)),
        torch.as_tensor(_view(args["stream_steps"], q)),
        torch.as_tensor(_view(args["roots"], q * nr).reshape(q, nr)),
        args["v1"], stride)
    got_x, got_found = emulate(seen, x, args["seed"], args["steps"],
                               args["walk_depth"])
    want_x, want_found = circuit_kernel.run_round_circuit_plain(
        tensors, x, seed, steps, walk)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_found, want_found)
