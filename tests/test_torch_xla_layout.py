"""K2's per-cone layout (mythril_tpu_torch/gpu/xla_kernel.xla_layout), its
tiers (cone_shape) and the kernel's algorithm over it, on the CPU.

- The layout decodes back to each cone's live cells, level by level, in
  its own page, and to its records and roots: on random windows, the
  sibling window and a stream whose cones land in different tiers.
- It raises on a stream the per-cone rounds would not compute exactly: a
  cell, a record or a root that reaches into another cone's page, a live
  root in a padding cone slot, and K3's defects.
- cone_shape picks each tier and word at its thresholds, and at most the
  word it is given.
- csrc/xla_round.cu's two kernels, emulated over the raw buffers the
  launch passes (emulate_launch: the header's offsets, the stream's slots
  and chunks, the roots and the blocks read as the kernel reads them,
  every read held inside its buffer and every block inside the shared
  memory the launch asks for; the words packed from the lanes' rows, the
  paired steps, the lockstep walks and the flips on the word), equal the
  plain round bit for bit at 1, 31, 33, 64 and 96 lanes, with padding
  cone slots and a gate-free cone.
- The bytes the backend counts for a stream (ship_bytes) are the bytes
  device_stream uploads, layout included.

The CUDA kernel itself is held to the plain round on the card
(tests/test_torch_cuda_xla.py, chip_smoke.py).
"""

import copy
import ctypes
import os
import random
import re
import time

import numpy as np
import pytest
import torch

import mythril_tpu_torch.smt as port_smt
from mythril_tpu_torch.gpu import circuit, circuit_kernel, xla_kernel
from mythril_tpu_torch.gpu.backend import shape_bucket
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
from mythril_tpu_torch.smt.bitblast import AIG
from mythril_tpu_torch.smt.solver import frontend as port_frontend
from mythril_tpu_torch.support.workloads import random_cones, sibling_window

FIELD = {name: k for k, name in enumerate(xla_kernel.CONE_FIELDS)}


def _entries(seed, count):
    """`count` random cones, every third one with a pinned input (a cube
    assumption root)."""
    return [(pc, ((1, bool(i % 2)),) if i % 3 and pc.v1 > 1 else ())
            for i, pc in enumerate(random_cones(random.Random(seed), count))]


def _gate_free_cone():
    """A cone with no gate: its root is an input, asserted FALSE."""
    aig = AIG()
    return circuit.PackedCircuit(aig, [aig.lit_of_var(aig.new_var()) ^ 1])


def _widened(pc, v1):
    """A copy of `pc` whose page holds `v1` local variables: those past its
    own are inputs no gate reads."""
    wide = copy.copy(pc)
    for key in xla_kernel.VAR_KEYS:
        setattr(wide, key, np.pad(getattr(pc, key), (0, v1 - pc.v1)))
    wide.v1 = v1
    return wide


# one page of each tier, at 32 lanes a word where the tier allows it
TIER_PAGES = (60, 16384, 32768, 49152, 98304, 196608, 196609)


def _tiered_entries(seed):
    cones = random_cones(random.Random(seed), len(TIER_PAGES))
    return [(_widened(pc, max(v1, pc.v1)), ())
            for pc, v1 in zip(cones, TIER_PAGES)]


def _stream(entries):
    return circuit.RaggedStream(entries, bucket=shape_bucket)


# -- the layout, decoded -------------------------------------------------------


def _u32(tensor):
    return tensor.numpy().astype(np.int64) & 0xFFFFFFFF


def decode(xs):
    """Per live cone: (levels, each a list of (out, a, a_neg, b, b_neg) in
    combined variables in stream order; the per-variable tables of its
    page; its root rows), read back from the layout alone. Each
    second-level cell's operands are checked on the way: a first-level
    child's own inputs, else the child twice."""
    layout = xs.layout
    records, roots = _u32(layout.records), _u32(layout.roots)
    stream = _u32(layout.stream)
    out = []
    for row in layout.header:
        cone = {name: int(row[k]) for name, k in FIELD.items()}
        base, v1 = cone["base"], cone["v1"]
        word = cone["lanes_per_word"] // 8

        def combined(local):
            return np.where(local > 0, local + base - 1, 0) \
                if isinstance(local, np.ndarray) else \
                int(local + base - 1 if local > 0 else 0)

        at = cone["rec_off"]
        if cone["tier"] < circuit_kernel.TIERS.index("xshared"):
            packed = records[at: at + v1]
            lit_a, lit_b = packed & 0xFFFF, packed >> 16
        else:
            pairs = records[at: at + 2 * v1].reshape(v1, 2)
            lit_a, lit_b = pairs[:, 0], pairs[:, 1]
        start = cone["stream_off"]
        body = stream[start: start + cone["stream_steps"]]
        assert not stream[start + cone["stream_steps"]:
                          start + cone["chunks"] * 8].any(), "empty padding"
        head, masks = body[:, 0, :, 0], body[:, 1, :, 0]
        for k in range(4):
            assert np.isin((masks >> (8 * k)) & 0xFF, (0, 0xFF)).all()

        def lit(offset, k):
            assert (offset % word == 0).all()
            return offset // word * 2 + ((masks >> (8 * k)) & 1)

        cells = np.stack((
            (head & 0x3FFFFFFF) // word,
            lit(body[:, 0, :, 1], 0), lit(body[:, 0, :, 2], 1),
            body[:, 0, :, 3], lit(body[:, 1, :, 1], 2),
            lit(body[:, 1, :, 2], 3), body[:, 1, :, 3],
            (head >> 30) & 1, head >> 31), -1)  # [steps, 32, 9]
        levels, pair = [], ([], [])
        for s, step in enumerate(cells):
            assert (step[:, 7] == step[0, 7]).all(), "a step lies in one pair"
            for o, a0, a1, a, b0, b1, b, _end, second in step:
                if not o:
                    continue
                firsts = {cell[0] for cell in pair[0]} if second else ()
                for literal, lo, hi in ((a, a0, a1), (b, b0, b1)):
                    var = literal >> 1
                    want = (lit_a[var], lit_b[var]) \
                        if combined(var) in firsts else (2 * var, 2 * var)
                    assert (lo, hi) == want, (s, o)
                pair[second].append((int(combined(o)),
                                     int(combined(a >> 1)), int(a & 1),
                                     int(combined(b >> 1)), int(b & 1)))
            if step[0, 7]:
                levels += [level for level in pair if level]
                pair = ([], [])
        assert not any(pair), "the stream ends on a pair's last step"
        var = np.arange(v1)
        gate = (lit_a >> 1) != var
        tables = {"is_gate": gate.astype(np.int32)}
        for key, literal in (("ga", lit_a), ("gb", lit_b)):
            tables[f"{key}_var"] = np.where(gate, combined(literal >> 1), 0)
            tables[f"{key}_neg"] = np.where(gate, literal & 1, 0)
        mine = roots[cone["root_off"]: cone["root_off"] + cone["root_count"]]
        tables.update(root_var=combined(mine >> 2), root_neg=(mine >> 1) & 1,
                      root_mask=mine & 1)
        out.append((cone, levels, tables))
    return out


def assert_decodes_to(stream, widest=32):
    xs = xla_kernel.device_stream(stream, "cpu", widest)
    tensors = stream.tensors
    owner = np.full(stream.v1, -1)
    for c, (base, size) in enumerate(stream.pages):
        owner[base: base + size] = c
    decoded = decode(xs)
    assert len(decoded) == stream.num_cones
    for c, (cone, levels, tables) in enumerate(decoded):
        base, size = stream.pages[c]
        assert (cone["base"], cone["v1"]) == (base, size + 1)
        want = []
        for level in range(stream.num_levels):
            cols = np.nonzero((tensors["out_idx"][level] > 0)
                              & (owner[tensors["out_idx"][level]] == c))[0]
            if len(cols):
                want.append([tuple(int(tensors[key][level, col])
                                   for key in xla_kernel.LEVEL_KEYS)
                             for col in cols])
        assert levels == want, c
        page = slice(base, base + size)
        for key in xla_kernel.VAR_KEYS:
            np.testing.assert_array_equal(tables[key][1:], tensors[key][page],
                                          err_msg=f"{key} of cone {c}")
            assert tables[key][0] == 0, key
        count = cone["root_count"]
        for key in xla_kernel.ROOT_KEYS:
            np.testing.assert_array_equal(
                tables[key], tensors[key][c, :count] * tensors["root_mask"][
                    c, :count], err_msg=f"{key} of cone {c}")
        assert not tensors["root_mask"][c, count:].any()
    return xs


@pytest.mark.parametrize("seed", range(12))
def test_layout_decodes_to_random_windows(seed):
    rng = random.Random(seed)
    entries = _entries(seed, rng.randint(1, 24))
    if seed % 4 == 1:
        entries.append((_gate_free_cone(), ()))
    xs = assert_decodes_to(_stream(entries))
    assert (xs.layout.header[:, FIELD["tier"]] == 0).all(), "all shared32"


def test_layout_decodes_to_the_sibling_window(monkeypatch):
    monkeypatch.setattr(port_frontend, "_global_blaster", None)
    entries = []
    for constraints in sibling_window(port_smt, 8, seed=5):
        solver = port_frontend.Solver(timeout=20)
        solver.add(constraints)
        prep = solver._prepare([])
        if prep.trivial is None:
            entries.append((PackedCircuit(prep.aig_roots[0],
                                          prep.aig_roots[1]), ()))
    assert len(entries) >= 6
    assert_decodes_to(_stream(entries))


def test_layout_decodes_a_stream_of_every_tier():
    xs = assert_decodes_to(_stream(_tiered_entries(3)))
    header = xs.layout.header
    shapes = [(circuit_kernel.TIERS[tier], lanes) for tier, lanes in zip(
        header[:, FIELD["tier"]], header[:, FIELD["lanes_per_word"]])]
    assert shapes == [("shared32", 32), ("shared32", 32), ("shared16", 16),
                      ("xshared", 32), ("xshared", 16), ("xshared", 8),
                      ("global", 32)]
    # each cone's records start on 16 bytes (the bulk copy's alignment)
    assert (header[:, FIELD["rec_off"]] % 4 == 0).all()
    # the narrower words of `widest` keep the cells, in other offsets
    narrow = assert_decodes_to(_stream(_tiered_entries(3)[:2]), widest=8)
    assert (narrow.layout.header[:, FIELD["lanes_per_word"]] == 8).all()


def _defect(stream, kind):
    """A copy of `stream`'s tensors with one defect the per-cone rounds
    cannot compute exactly, and the message it raises with."""
    tensors = {key: value.copy() for key, value in stream.tensors.items()}
    (b1, s1), (b2, _s2) = stream.pages[:2]
    level, col = (int(i[0]) for i in np.nonzero(
        (tensors["out_idx"] > 0) & (tensors["out_idx"] >= b2)))
    out = int(tensors["out_idx"][level, col])
    if kind == "cell":
        # cone 1's cell reads cone 0's first variable
        tensors["a_var"][level, col] = tensors["ga_var"][out] = b1
        return tensors, "reads only its own cone's page"
    if kind == "record":
        gate = int(np.nonzero(tensors["is_gate"][b2:])[0][0]) + b2
        tensors["gb_var"][gate] = b1 + s1 - 1
        return tensors, "children lie in its own cone's page"
    if kind == "root":
        tensors["root_var"][1, 0] = b1
        return tensors, "live root lies in its own cone's page"
    if kind == "padding root":
        tensors["root_mask"][stream.num_cones, 0] = 1
        return tensors, "padding cone slot"
    if kind == "padding gate":
        tensors["is_gate"][-1] = 1
        return tensors, "a gate lies in a cone's page"
    if kind == "two cells":
        spare = int(np.nonzero(tensors["out_idx"][level] == 0)[0][0])
        for key in xla_kernel.LEVEL_KEYS:
            tensors[key][level, spare] = tensors[key][level, col]
        return tensors, "one live cell"
    if kind == "not its record":
        tensors["a_neg"][level, col] ^= 1
        return tensors, "children equal"
    assert kind == "range"
    tensors["b_var"][level, col] = stream.v1
    return tensors, r"lie in \[0, V1\)"


@pytest.mark.parametrize("kind", ["cell", "record", "root", "padding root",
                                  "padding gate", "two cells",
                                  "not its record", "range"])
def test_layout_raises_on_a_stream_it_cannot_split(kind):
    stream = _stream(_entries(21, 3))
    assert stream.cone_slots > stream.num_cones and stream.v1 > \
        stream.pages[-1][0] + stream.pages[-1][1]
    xla_kernel.device_stream(stream, "cpu")  # the stream itself is fine
    tensors, message = _defect(stream, kind)
    with pytest.raises(ValueError, match=f"xla_layout: .*{message}"):
        xla_kernel.xla_layout({key: torch.as_tensor(value) for key, value
                               in tensors.items()}, stream.pages)


def test_layout_raises_on_pages_that_do_not_tile():
    stream = _stream(_entries(22, 2))
    tensors = {key: torch.as_tensor(value)
               for key, value in stream.tensors.items()}
    (b1, s1), (b2, s2) = stream.pages
    for pages, message in (([(b1, s1), (b2 + 1, s2)], "do not tile"),
                           ([(b1, s1), (b2, stream.v1)], "past V1"),
                           ([(b1, s1)] * 9, "cone slots")):
        with pytest.raises(ValueError, match=message):
            xla_kernel.xla_layout(tensors, pages)


@pytest.mark.parametrize("v1, widest, tier, lanes", [
    (1, 32, "shared32", 32), (16384, 32, "shared32", 32),
    (16385, 32, "shared16", 16), (32768, 32, "shared16", 16),
    (32769, 32, "xshared", 32), (49152, 32, "xshared", 32),
    (49153, 32, "xshared", 16), (98304, 32, "xshared", 16),
    (98305, 32, "xshared", 8), (196608, 32, "xshared", 8),
    (196609, 32, "global", 32), (100, 16, "xshared", 16),
    (100, 8, "xshared", 8), (20000, 8, "xshared", 8),
    (37382, 16, "xshared", 16), (37382, 8, "xshared", 8),
    (300000, 8, "global", 32)])
def test_cone_shape_picks_each_tier_at_its_threshold(v1, widest, tier,
                                                     lanes):
    shape = xla_kernel.cone_shape(v1, circuit_kernel.CHUNK_STEPS, widest)
    assert (shape.tier, shape.lanes_per_word) == (tier, lanes)
    assert shape.smem_bytes <= circuit_kernel.SMEM_CAP
    if widest == 32:
        assert shape == circuit_kernel.launch_shape(
            v1, circuit_kernel.CHUNK_STEPS), "K3's tiers"
    ring = xla_kernel.cone_shape(v1, 1 << 14, widest)
    assert not ring.resident, "16,384 steps never fit"
    assert ring.smem_bytes <= circuit_kernel.SMEM_CAP


# -- the kernels, emulated over the launch's raw buffers ----------------------


def _kernel_source():
    """The kernel's source and the header of the warp-level pieces it
    includes (csrc/sliced_round.cuh)."""
    text = ""
    for path in (xla_kernel.KERNEL_SOURCE, os.path.join(os.path.dirname(
            xla_kernel.KERNEL_SOURCE), "sliced_round.cuh")):
        with open(path) as handle:
            text += handle.read()
    assert '#include "sliced_round.cuh"' in text
    return text


def test_the_kernel_source_mirrors_the_wrapper():
    """The constants and the header row the kernel reads are the ones the
    layout and the launch write."""
    source = _kernel_source()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kThreads") == xla_kernel.THREADS
    assert constant("kCopyThreads") == xla_kernel.COPY_THREADS
    assert constant("kChunkBytes") == circuit_kernel.CHUNK_BYTES
    assert constant("kRing") == circuit_kernel.RING
    assert constant("kSlotQuads") * 16 == circuit_kernel.ENTRY_BYTES
    assert circuit_kernel.CHUNK_BYTES // (
        circuit_kernel.STEP_GATES * circuit_kernel.ENTRY_BYTES) \
        == circuit_kernel.CHUNK_STEPS
    body = re.search(r"struct Cone \{([^}]*)\};", source).group(1)
    fields = re.findall(r"int (\w+);", body)
    assert tuple(fields) == xla_kernel.CONE_FIELDS
    tiers = re.search(r"enum \{ kShared32 = 0, kShared16 = 1, "
                      r"kXShared = 2, kGlobal = 3 \};", source)
    assert tiers and circuit_kernel.TIERS == ("shared32", "shared16",
                                              "xshared", "global")


def _view(address, count, ctype=ctypes.c_int32):
    """A numpy view of `count` elements at a raw address."""
    return np.ctypeslib.as_array((ctype * count).from_address(address))


def _within(index, length, what):
    index = np.asarray(index)
    assert ((index >= 0) & (index < length)).all(), f"{what} out of bounds"


def emulate_launch(args, numel):
    """csrc/xla_round.cu's copy kernel and round kernel over the raw
    buffers named by `args` (xla_kernel.launch_arguments), `numel` the
    element count behind each pointer. Every offset comes from the
    header and the size arguments, as the kernel computes it, and every
    read is held inside its buffer."""
    lanes, v1 = args["lanes"], args["v1"]
    num_cones, slots = args["num_cones"], args["cone_slots"]
    page_end = args["page_end"]
    assert numel["cones"] == num_cones * len(xla_kernel.CONE_FIELDS)
    header = _view(args["cones"], numel["cones"]).reshape(num_cones, -1)
    records = _view(args["records"], numel["records"]).astype(
        np.int64) & 0xFFFFFFFF
    assert numel["stream_table"] % (2 * 32 * 4) == 0
    stream = (_view(args["stream_table"], numel["stream_table"]).astype(
        np.int64) & 0xFFFFFFFF).reshape(-1, 2, 32, 4)
    roots = _view(args["roots"], numel["roots"]).astype(
        np.int64) & 0xFFFFFFFF
    assert numel["x_in"] == numel["x_out"] == lanes * v1
    assert numel["found"] == lanes * slots
    x_in = _view(args["x_in"], lanes * v1).reshape(lanes, v1)
    x_out = _view(args["x_out"], lanes * v1).reshape(lanes, v1)
    found_out = _view(args["found"], lanes * slots,
                      ctypes.c_uint8).reshape(lanes, slots)
    steps, walk_depth, seed = args["steps"], args["walk_depth"], args["seed"]

    # the copy kernel: past the pages, var 0, the padding cone slots
    x_out[:, page_end:] = x_in[:, page_end:]
    x_out[:, 0] = 0
    found_out[:, num_cones:] = 1

    # the blocks: the cones' groups in order, the global tier's words
    blocks, work = [], 0
    for c, row in enumerate(header):
        cone = {name: int(row[k]) for name, k in FIELD.items()}
        groups = -(-lanes // cone["lanes_per_word"])
        blocks += [(c, g * cone["lanes_per_word"]) for g in range(groups)]
        if cone["tier"] == 3:
            work += groups * cone["v1p"]
    assert len(blocks) == args["blocks"]
    assert (args["x_work"] is None) == (work == 0)
    assert work <= numel.get("x_work", 0)
    for c, lane0 in blocks:
        cone = {name: int(header[c, k]) for name, k in FIELD.items()}
        _emulate_block(cone, c, lane0, records, stream, roots, x_in, x_out,
                       found_out, args["smem_bytes"], page_end, steps,
                       walk_depth, seed)


def _emulate_block(cone, c, lane0, records, stream, roots, x_in, x_out,
                   found_out, smem_bytes, page_end, steps, walk_depth, seed):
    lanes, width = x_in.shape
    word = cone["lanes_per_word"]
    ones = (1 << word) - 1
    tier = circuit_kernel.TIERS[cone["tier"]]
    narrow = tier in ("shared32", "shared16")
    base, v1, v1p = cone["base"], cone["v1"], cone["v1p"]
    assert v1p == -(-v1 // 4) * 4 and base >= 1
    assert base + v1 - 1 <= page_end
    # the block's shared memory, laid out as the kernel lays it out
    chunk = circuit_kernel.CHUNK_BYTES
    stream_bytes = cone["chunks"] * chunk if cone["resident"] \
        else circuit_kernel.RING * chunk
    assert (4 * v1p if narrow else 0) + stream_bytes + (
        v1p * word // 8 if tier != "global" else 0) <= smem_bytes
    assert cone["chunks"] * circuit_kernel.CHUNK_STEPS \
        >= cone["stream_steps"]
    if cone["chunks"]:
        _within(cone["stream_off"] + cone["chunks"]
                * circuit_kernel.CHUNK_STEPS - 1, len(stream), "stream")
    rec_words = v1p if narrow else 2 * v1
    assert cone["rec_off"] % 4 == 0
    _within(cone["rec_off"] + rec_words - 1, len(records), "records")
    assert cone["root_count"] >= 1
    _within(cone["root_off"] + cone["root_count"] - 1, len(roots), "roots")
    recs = records[cone["rec_off"]: cone["rec_off"] + rec_words]
    if narrow:
        rec_a, rec_b = recs & 0xFFFF, recs >> 16
    else:
        rec_a, rec_b = recs[0::2], recs[1::2]
    my_roots = roots[cone["root_off"]: cone["root_off"]
                     + cone["root_count"]]
    body = stream[cone["stream_off"]: cone["stream_off"]
                  + cone["stream_steps"]]
    nl = min(word, lanes - lane0)
    rows = slice(lane0, lane0 + nl)

    # pack: bit r of local variable v's word is lane lane0 + r's value
    x = np.zeros(v1p, dtype=np.int64)
    page = x_in[rows, base: base + v1 - 1].astype(np.int64)
    x[1:v1] = (page << np.arange(nl)[:, None]).sum(axis=0)

    def simulate():
        x[0] = 0
        for p, q in body:  # a step: 32 slots read, then written
            masks = q[:, 0]

            def value(offset, k):
                assert (offset % (word // 8) == 0).all()
                _within(offset // (word // 8), v1p, "x")
                flip = np.where((masks >> (8 * k)) & 0xFF, ones, 0)
                return x[offset // (word // 8)] ^ flip

            va = (value(p[:, 1], 0) & value(p[:, 2], 1)) \
                ^ np.where(p[:, 3] & 1, ones, 0)
            vb = (value(q[:, 1], 2) & value(q[:, 2], 3)) \
                ^ np.where(q[:, 3] & 1, ones, 0)
            out = (p[:, 0] & 0x3FFFFFFF) // (word // 8)
            x[out] = va & vb

    def bit(v, t):
        _within(v, v1, "x")
        return int(x[v] >> t) & 1

    def check(t, key_base):
        best_key, best = -1, 0
        for j, r in enumerate(my_roots):
            if r & 1 and bit(r >> 2, t) == (r >> 1) & 1:
                key = int(_hash32(key_base ^ _mul32(j, _C_ROOT))) >> 1
                if key > best_key:
                    best_key, best = key, j
        return best_key >= 0, best

    def rec_of(v):
        _within(v, v1, "record")
        return int(rec_a[v]), int(rec_b[v])

    salts = [int(_mul32(lane0 + t, _C_LANE) ^ _mul32(c, _C_CONE))
             for t in range(32)]
    found = [t >= nl for t in range(32)]
    final = True
    for step in range(steps):
        simulate()
        step_key = int(_hash32(seed ^ _mul32(step, _C_STEP)))
        choice, walking = [0] * 32, [False] * 32
        for t in range(32):
            if not found[t]:
                walking[t], choice[t] = check(t, step_key ^ salts[t])
        found = [f or not w for f, w in zip(found, walking)]
        if all(found):
            final = False
            break
        # the warp's walks in lockstep: each reads x before any flips
        state = []
        for t in range(32):
            r = int(my_roots[choice[t]])
            state.append([r >> 2, 1 ^ ((r >> 1) & 1), rec_of(r >> 2),
                          walking[t]])
        for depth in range(walk_depth):
            for t, (cur, want, (ra_lit, rb_lit), active) in enumerate(state):
                coin = int(_hash32(step_key ^ _C_COIN ^ salts[t]
                                   ^ _mul32(depth, _C_DEPTH))) & 1
                a, b = ra_lit >> 1, rb_lit >> 1
                rec_a_child, rec_b_child = rec_of(a), rec_of(b)
                av = bit(a, t) ^ (ra_lit & 1)
                bv = bit(b, t) ^ (rb_lit & 1)
                active = active and a != cur and (av & bv) != want
                fa, fb = av ^ want, bv ^ want
                choose_b = active and bool(fb & ((fa ^ 1) | coin))
                choose_a = active and not choose_b
                if choose_b:
                    cur, want, rec = b, want ^ (rb_lit & 1), rec_b_child
                elif choose_a:
                    cur, want, rec = a, want ^ (ra_lit & 1), rec_a_child
                else:
                    rec = (ra_lit, rb_lit)
                state[t] = [cur, want, rec, active]
            if not any(s[3] for s in state):
                break
        for t, (cur, want, _rec, _active) in enumerate(state):
            if walking[t]:  # the flip: bit t of the word
                x[cur] = x[cur] & ~(1 << t) | (want << t)
    if final:
        simulate()
        for t in range(32):
            found[t] = found[t] or not check(t, salts[t])[0]
    found_out[rows, c] = found[:nl]
    # unpack: the page's variables (local 1 and up) of the group's lanes
    x_out[rows, base: base + v1 - 1] = (
        x[None, 1:v1] >> np.arange(nl)[:, None]) & 1


def run_emulated(xs, x, seed, steps, walk_depth):
    """The launch of run_round_xla_kernel, its kernels emulated."""
    lanes = x.shape[0]
    x_out = torch.full_like(x, 7)
    found = torch.full((lanes, xs.tensors["root_var"].shape[0]), True)
    found[:, :xs.num_cones] = False
    _blocks, work = xla_kernel.launch_blocks(xs.layout, lanes)
    x_work = torch.zeros((work,), dtype=torch.int32) if work else None
    args = xla_kernel.launch_arguments(xs, x, x_out, found, x_work, seed,
                                       steps, walk_depth)
    assert list(args) == list(xla_kernel.ARG_ORDER)
    layout = xs.layout
    numel = {"cones": layout.cones.numel(), "records": layout.records.numel(),
             "stream_table": layout.stream.numel(),
             "roots": layout.roots.numel(), "x_in": x.numel(),
             "x_out": x_out.numel(), "found": found.numel(),
             "x_work": 0 if x_work is None else x_work.numel()}
    emulate_launch(args, numel)
    return x_out, found


def _seeded_x(stream, lanes, seed):
    generator = torch.Generator()
    generator.manual_seed(seed)
    x = circuit.init_inputs(generator, lanes, stream.v1, "cpu")
    x[:, 0] = 1  # var 0 is reset to the constant FALSE by both
    return x


@pytest.mark.parametrize("seed, lanes, steps", [
    (1, 1, 12), (2, 31, 8), (3, 33, 6), (4, 64, 5), (5, 96, 4), (6, 33, 0),
    (7, 1, 0), (8, 64, 1)])
def test_emulated_kernel_equals_the_plain_round(seed, lanes, steps):
    """Random windows with padding cone slots, pinned inputs and a
    gate-free cone."""
    rng = random.Random(seed)
    entries = _entries(seed, rng.choice((2, 4, 6, 8)))
    entries.insert(rng.randint(0, len(entries)), (_gate_free_cone(), ()))
    stream = _stream(entries)
    assert stream.cone_slots > stream.num_cones
    xs = xla_kernel.device_stream(stream, "cpu")
    x = _seeded_x(stream, lanes, seed)
    walk = rng.choice((stream.num_levels + 4, rng.randint(0, 6)))
    got = run_emulated(xs, x, seed * 7, steps, walk)
    want = xla_kernel.run_round_xla_plain(xs, x, seed * 7, steps, walk)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("widest, lanes", [(32, 5), (8, 33)])
def test_emulated_kernel_equals_the_plain_round_on_every_tier(widest, lanes):
    """Cones of different tiers in one stream (widest 8: every word of 8
    lanes, the records in global memory)."""
    entries = _tiered_entries(4) if widest == 32 else _entries(9, 6)
    stream = _stream(entries)
    xs = xla_kernel.device_stream(stream, "cpu", widest)
    x = _seeded_x(stream, lanes, 11)
    got = run_emulated(xs, x, 12, 3, stream.num_levels + 4)
    want = xla_kernel.run_round_xla_plain(xs, x, 12, 3,
                                          stream.num_levels + 4)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_plain_round_counts_walks_without_changing_its_result():
    stream = _stream(_entries(30, 5))
    xs = xla_kernel.device_stream(stream, "cpu")
    x = _seeded_x(stream, 6, 30)
    walks = []
    walk = stream.num_levels + 4
    got = xla_kernel.run_round_xla_plain(xs, x, 3, 5, walk, walks=walks)
    want = xla_kernel.run_round_xla_plain(xs, x, 3, 5, walk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(walks) == 5
    for length, walked in walks:
        assert length.shape == walked.shape == (6, stream.cone_slots)
        assert int(length.max()) <= stream.num_levels
        assert not bool(length[~walked].any()), "a found cone walks not"


# -- what the backend counts -------------------------------------------------


def test_ship_bytes_count_what_device_stream_uploads(monkeypatch):
    """_solve_ragged_stream_xla adds the uploaded tables and the layout to
    ship_bytes: every byte of every tensor device_stream returns."""
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend

    uploaded = []
    real = xla_kernel.device_stream

    def upload(stream, device):
        xs = real(stream, device)
        uploaded.append(xs)
        return xs

    monkeypatch.setattr(xla_kernel, "device_stream", upload)
    backend = DeviceSolverBackend(device=torch.device("cpu"))
    entries = _entries(31, 3)
    backend._solve_ragged_stream_xla(entries, time.monotonic() + 60, 4, 4,
                                     False)
    (xs,) = uploaded
    tensors = list(xs.tensors.values()) + [xs.level_rows] + [
        value for value in xs.layout if isinstance(value, torch.Tensor)]
    assert len(tensors) == len(circuit.TENSOR_KEYS) + 1 + 4
    assert backend.ship_bytes == sum(t.numel() * t.element_size()
                                     for t in tensors)
    assert backend.ship_bytes > xs.nbytes - xs.layout.nbytes > 0
