"""The port's ragged round (mythril_tpu_torch/gpu/ragged_kernel.py) held
against the JAX package's Pallas kernel (tpu/pallas_kernel.py), run as the
JAX package's tests run it on the CPU: in Pallas interpret mode.

Both get the same RaggedStream (built from the same cones), the same numpy
x and the same seed, steps and walk depth. x and found are integers and
bools, so the tolerance is zero: they must be bit-identical. The caps are
small, with cone_tile < cone_cap so the reference runs several cone tiles
(its merge-write path), and lanes > lane_tile. The windows mix plain
cones, cube replicas (extra_roots pins), fork carry-literal pins and
UNSAT replicas (tests/test_pallas_kernel.py's oracle-labeled entries).

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_cuda_kernel.py, chip_smoke.py).
"""

import random

import numpy as np
import pytest
import torch

from mythril_tpu.tpu import pallas_kernel as ref_kernel
from mythril_tpu.tpu.circuit import PackedCircuit as RefPacked
from mythril_tpu.tpu.circuit import RaggedStream as RefStream
from mythril_tpu_torch.gpu import ragged_kernel
from mythril_tpu_torch.gpu.circuit import RaggedStream as PortStream
from mythril_tpu_torch.support.workloads import big_cone, random_cones
from tests.test_pallas_kernel import _build_entries
from tests.test_ragged import _random_cone
from tests.torch_helpers import assert_packed_equal, port_packed

REF_CAPS = ref_kernel.KernelCaps(var_cap=2048, cone_cap=16, root_cap=16,
                                 lane_tile=4, cone_tile=4, block=32)
CAPS = ragged_kernel.KernelCaps(*REF_CAPS)
LANES = 8  # two lane tiles


def _plain_window(seed, count):
    rng = random.Random(seed)
    window = []
    while len(window) < count:
        aig, roots = _random_cone(rng, rng.randint(4, 10),
                                  rng.randint(20, 60))
        pc = RefPacked(aig, roots)
        if pc.ok:
            window.append((pc, (), aig, roots))
    return window


def _mixed_window(start, count):
    return [(pc, extra, aig, roots)
            for pc, extra, aig, roots, _pins, _sat
            in _build_entries()[start: start + count]]


def _identity(n):
    return max(int(n), 1)


def _streams(window):
    cache = {}
    ref_entries, port_entries = [], []
    for ref_pc, extra, aig, roots in window:
        pc = port_packed(ref_pc, aig, roots, cache)
        assert_packed_equal(ref_pc, pc)
        ref_entries.append((ref_pc, extra))
        port_entries.append((pc, extra))
    # no bucket padding, as both backends assemble kernel streams
    return (RefStream(ref_entries, bucket=_identity),
            PortStream(port_entries))


def _flats(window):
    ref_stream, port_stream = _streams(window)
    ref_flat = ref_kernel.flatten_stream(ref_stream, REF_CAPS)
    flat = ragged_kernel.flatten_stream(port_stream, CAPS)
    assert ref_flat is not None and flat is not None
    return ref_stream, ref_flat, flat


def _round_both(window, seed, steps):
    ref_stream, ref_flat, flat = _flats(window)
    x = np.random.default_rng(seed).integers(
        0, 2, size=(LANES, CAPS.var_cap), dtype=np.int32)
    walk_depth = ref_stream.num_levels + 4
    ref_x, ref_found = ref_kernel.run_round_pallas(
        ref_flat, x, seed=seed, steps=steps, walk_depth=walk_depth,
        caps=REF_CAPS, interpret=True)
    launches = ragged_kernel.launches
    port_x, port_found = ragged_kernel.run_round_ragged_kernel(
        ragged_kernel.device_flat(flat, "cpu"), torch.from_numpy(x),
        seed=seed, steps=steps, walk_depth=walk_depth, caps=CAPS)
    # the plain version is never counted as a kernel launch
    assert ragged_kernel.launches == launches
    return (np.asarray(ref_x), np.asarray(ref_found), port_x.numpy(),
            port_found.numpy(), ref_stream)


@pytest.mark.parametrize("window_seed, count, seed, steps", [
    (3, 5, 11, 24),
    (5, 16, 12, 40),   # a full cone_cap window
    (7, 9, 13, 0),     # no steps: the final simulate and check only
])
def test_plain_round_bit_identical_to_pallas_on_plain_cones(
        window_seed, count, seed, steps):
    ref_x, ref_found, x, found, stream = _round_both(
        _plain_window(window_seed, count), seed, steps)
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_array_equal(found, ref_found)
    assert found[:, stream.num_cones:].all(), "padding slots are found"


@pytest.mark.parametrize("start, seed", [(0, 21), (16, 22), (48, 23)])
def test_plain_round_bit_identical_to_pallas_on_cube_and_fork_pins(
        start, seed):
    ref_x, ref_found, x, found, _stream = _round_both(
        _mixed_window(start, 16), seed, steps=48)
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_array_equal(found, ref_found)


@pytest.mark.parametrize("window_seed, seed", [(41, 51), (42, 52)])
def test_plain_round_bit_identical_to_pallas_with_var0_roots(window_seed,
                                                            seed):
    """Two cones assert local var 0 (the constant FALSE) wanted TRUE: the
    root is violated at every step and its walk flips var 0, which the
    next simulate resets. Every other read of var 0 sees 0, so those two
    cones are never found and the rest run as they would alone."""
    window = [(pc, ((0, True),) if i in (1, 3) else extra, aig, roots)
              for i, (pc, extra, aig, roots)
              in enumerate(_plain_window(window_seed, 6))]
    ref_x, ref_found, x, found, _stream = _round_both(window, seed, steps=32)
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_array_equal(found, ref_found)
    assert not found[:, [1, 3]].any()


def test_merge_rule_keeps_input_in_unowned_columns():
    """Column 0 and the padding past the last page are not owned by any
    cone: both kernels return the INPUT x there, even where simulate wrote
    var 0 (the input's column 0 is not zeroed)."""
    window = _plain_window(9, 3)
    ref_x, _rf, x, _f, stream = _round_both(window, seed=31, steps=8)
    x_in = np.random.default_rng(31).integers(
        0, 2, size=(LANES, CAPS.var_cap), dtype=np.int32)
    np.testing.assert_array_equal(x[:, 0], x_in[:, 0])
    np.testing.assert_array_equal(x[:, stream.v1:], x_in[:, stream.v1:])
    np.testing.assert_array_equal(x, ref_x)


@pytest.mark.parametrize("builder, arg", [(_plain_window, 6),
                                          (_mixed_window, 24)])
def test_flatten_stream_matches_reference_array_by_array(builder, arg):
    window = builder(17, 12) if builder is _plain_window else \
        builder(arg, 16)
    ref_stream, ref_flat, flat = _flats(window)
    assert set(flat.arrays) == set(ref_flat.arrays)
    for key in ref_kernel.ARRAY_ORDER:
        np.testing.assert_array_equal(flat.arrays[key],
                                      ref_flat.arrays[key], err_msg=key)
    for field in ("num_cones", "num_gates", "num_levels", "padded_cells"):
        assert getattr(flat, field) == getattr(ref_flat, field), field
    assert flat.num_roots == ref_stream.tensors["root_var"].shape[1]


def test_caps_defaults_and_lane_padding_match_reference(monkeypatch):
    for name in ("VAR_CAP", "CONE_CAP", "ROOT_CAP", "LANE_TILE"):
        monkeypatch.delenv(f"MYTHRIL_GPU_RAGGED_{name}", raising=False)
    for name in ("VAR_CAP", "CONE_CAP", "ROOT_CAP", "LANE_TILE",
                 "CONE_TILE", "BLOCK"):
        monkeypatch.delenv(f"MYTHRIL_TPU_PALLAS_{name}", raising=False)
    assert tuple(ragged_kernel.kernel_caps()) == \
        tuple(ref_kernel.kernel_caps())
    # one package's knobs never steer the other
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS_VAR_CAP", "4096")
    assert ragged_kernel.kernel_caps().var_cap == 1 << 16
    caps = ragged_kernel.kernel_caps()
    for restarts in (1, 8, 13, 64):
        assert ragged_kernel.pad_lanes(restarts, caps) == \
            ref_kernel.pad_lanes(restarts, ref_kernel.kernel_caps())


def test_wrapper_rejects_malformed_operands():
    window = _plain_window(3, 2)
    _ref_stream, _ref_flat, flat = _flats(window)
    flat = ragged_kernel.device_flat(flat, "cpu")
    good = torch.zeros((LANES, CAPS.var_cap), dtype=torch.int32)
    with pytest.raises(ValueError):
        ragged_kernel.run_round_ragged_kernel(
            flat, good.long(), 0, 1, 4, CAPS)
    with pytest.raises(ValueError):
        ragged_kernel.run_round_ragged_kernel(
            flat, good[:3], 0, 1, 4, CAPS)
    numpy_table = flat._replace(arrays=dict(
        flat.arrays, g_out=flat.arrays["g_out"].numpy()))
    with pytest.raises(ValueError):  # a table not uploaded with device_flat
        ragged_kernel.run_round_ragged_kernel(
            numpy_table, good, 0, 1, 4, CAPS)


# -- the kernel's per-cone layout (cone_layout) --------------------------------


def _decode_section(flat, ci):
    """One cone's section, its indices mapped back to combined ones."""
    layout, rk = flat.cones, ragged_kernel
    row = layout.header[ci]
    base, size, levels = int(row[rk.H_BASE]), int(row[rk.H_SIZE]), \
        int(row[rk.H_LEVELS])
    start = int(row[rk.H_SECTION])
    section = layout.blob[start: start + int(row[rk.H_SECTION_BYTES])]

    def combined(local):
        local = local.astype(np.int64)
        return np.where(local > 0, local + base - 1, 0)

    def bit(words, shift):
        return (words >> shift) & 1

    if row[rk.H_PATH] == rk.PATH_GLOBAL:
        passes = int(row[rk.H_STEPS])
        return {"path": "global", "base": base, "size": size,
                "levels": levels,
                "passes": section[:8 * (passes + 1)].view(np.int32)
                .reshape(passes + 1, 2)}
    records = section[:8 * (size + 1)].view(np.uint32).reshape(size + 1, 2)
    step_at = int(row[rk.H_STEP_OFF])
    step_off = section[step_at: step_at + 2 * (int(row[rk.H_STEPS]) + 1)
                       ].view(np.uint16).astype(np.int64)
    gate_at, count = int(row[rk.H_GATE_OFF]), int(step_off[-1])
    quads = section[gate_at: gate_at + 16 * count].view(np.uint32).reshape(
        count, 4)
    padding = section[gate_at + 16 * count:
                      gate_at + 16 * (count + rk.GATE_PAD)]
    root_at = int(row[rk.H_ROOT_OFF])
    roots = section[root_at: root_at + 4 * flat.num_roots].view(np.uint32)
    words = quads[:, 2]
    locals_ = np.concatenate([records[:, 0] & 0xFFFF, records[:, 0] >> 16,
                              quads[:, :2].reshape(-1) & 0xFFFF,
                              quads[:, :2].reshape(-1) >> 16, words & 0xFFFF,
                              roots >> 2])
    return {"path": "shared", "base": base, "size": size,
            "step_off": step_off, "padding": padding,
            "unused_word": quads[:, 3],
            "g_out": combined(quads[:, 0] & 0xFFFF),
            "a0": combined(quads[:, 0] >> 16),
            "a1": combined(quads[:, 1] & 0xFFFF),
            "b0": combined(quads[:, 1] >> 16), "b1": combined(words & 0xFFFF),
            "na0": bit(words, rk.GATE_NA0), "na1": bit(words, rk.GATE_NA1),
            "nb0": bit(words, rk.GATE_NB0), "nb1": bit(words, rk.GATE_NB1),
            "g_an": bit(words, rk.GATE_AN), "g_bn": bit(words, rk.GATE_BN),
            "local_max": int(locals_.max(initial=0)),
            "ga_var": combined(records[:, 0] & 0xFFFF),
            "gb_var": combined(records[:, 0] >> 16),
            "ga_neg": records[:, 1] & 1, "gb_neg": (records[:, 1] >> 1) & 1,
            "is_gate": (records[:, 1] >> 2) & 1,
            "root_var": combined(roots >> 2), "root_neg": (roots >> 1) & 1,
            "root_mask": roots & 1}


def _assert_gate_inputs(cone, arrays, pos, levels):
    """Each gate reads its children directly, or, on the odd level of a
    pair, reads in place of a child on the level below it that child's two
    inputs: exactly what the flat stream's gate and var tables say."""
    var_level = np.full(arrays["var_cone"].shape, -1)
    var_level[arrays["g_out"][pos]] = levels
    odd = levels % 2 == 1
    for side in ("a", "b"):
        child = arrays[f"g_{side}"][pos]
        inline = odd & (var_level[child] == levels - 1)
        first, second = cone[f"{side}0"], cone[f"{side}1"]
        neg0, neg1 = cone[f"n{side}0"], cone[f"n{side}1"]
        np.testing.assert_array_equal(first[~inline], child[~inline])
        np.testing.assert_array_equal(second[~inline], child[~inline])
        assert not (neg0[~inline].any() or neg1[~inline].any())
        for got, key in ((first, "ga_var"), (second, "gb_var"),
                         (neg0, "ga_neg"), (neg1, "gb_neg")):
            np.testing.assert_array_equal(got[inline],
                                          arrays[key][child[inline]],
                                          err_msg=f"{side} {key}")
    for key in ("g_out", "g_an", "g_bn"):
        np.testing.assert_array_equal(cone[key], arrays[key][pos],
                                      err_msg=key)


def _assert_steps(step_off, levels):
    """Steps tile the gate list in runs of at most 32 gates, each inside
    one pair of levels, and every pair starts a step."""
    sizes = np.diff(step_off)
    assert step_off[0] == 0 and step_off[-1] == len(levels)
    assert ((sizes >= 1) & (sizes <= 32)).all()
    pairs = levels // 2
    for begin, end in zip(step_off[:-1], step_off[1:]):
        assert (pairs[begin:end] == pairs[begin]).all()
    starts = np.nonzero(np.diff(pairs))[0] + 1
    assert set(starts.tolist()) <= set(step_off.tolist())


def _cone_positions(flat, ci):
    """Flat-stream positions of cone ci's gates (level order) and their
    levels."""
    arrays = flat.arrays
    g_out = arrays["g_out"][:flat.num_gates]
    level = np.repeat(np.arange(flat.num_levels),
                      np.diff(arrays["level_start"][:flat.num_levels + 1]))
    pos = np.nonzero(arrays["var_cone"][g_out] == ci)[0]
    return pos, level[pos]


@pytest.mark.parametrize("make_window", [_plain_window, _mixed_window])
@pytest.mark.parametrize("path", ["shared", "global"])
def test_cone_layout_restates_the_flat_stream_per_cone(monkeypatch,
                                                       make_window, path):
    """Each cone's level-ordered gate list (with its zero padding, cut
    into the warp's steps) and per-variable records, mapped back to
    combined indices, equal the flat stream's gates and var tables
    restricted to that cone's page; on the shared-memory path every
    local index fits 16 bits and the launch's shared memory holds the
    section and a page per lane. A shared-memory cap of 0 sends every cone
    down the global-table path, whose passes must tile the cone's gates in
    the flat stream, at most GLOBAL_PASS of one level each, and whose
    launch holds one page of bit-sliced lanes."""
    if path == "global":
        monkeypatch.setattr(ragged_kernel, "SMEM_CAP", 0)
    window = make_window(17, 12) if make_window is _plain_window \
        else make_window(24, 16)
    _ref_stream, _ref_flat, flat = _flats(window)
    arrays, layout = flat.arrays, flat.cones
    assert layout.header.shape == (flat.num_cones,
                                   ragged_kernel.HEADER_WORDS)
    assert (layout.header[:, ragged_kernel.H_SECTION] % 16 == 0).all()
    assert layout.v1 == _ref_stream.v1
    needs = []
    for ci in range(flat.num_cones):
        cone = _decode_section(flat, ci)
        assert cone["path"] == path
        base, size = cone["base"], cone["size"]
        assert (arrays["var_cone"][base: base + size] == ci).all()
        pos, levels = _cone_positions(flat, ci)
        row = layout.header[ci]
        assert row[ragged_kernel.H_PAGE_BYTES] >= size + 1
        needs.append(int(row[ragged_kernel.H_PAGE_BYTES]))
        if path == "global":
            passes = cone["passes"]
            assert passes[-1].tolist() == [0, 0]
            passes = passes[:-1]
            got = np.concatenate([np.arange(b, e) for b, e in passes]
                                 or [np.zeros(0, dtype=np.int64)])
            np.testing.assert_array_equal(got, pos)
            sizes = passes[:, 1] - passes[:, 0]
            assert (sizes >= 1).all()
            # the kernel copies from the begin rounded down to 16 bytes
            assert (passes[:, 1] - (passes[:, 0] & ~3)
                    <= ragged_kernel.GLOBAL_PASS).all()
            level_start = arrays["level_start"]
            level = np.searchsorted(level_start, passes[:, 0],
                                    side="right") - 1
            assert (passes[:, 1] <= level_start[level + 1]).all()
            assert len(np.unique(level)) == cone["levels"]
            needs[-1] += (ragged_kernel.GLOBAL_RING
                          * ragged_kernel.GLOBAL_STAGE_BYTES)
            continue
        assert cone["local_max"] <= size < 1 << 16
        _assert_steps(cone["step_off"], levels)
        _assert_gate_inputs(cone, arrays, pos, levels)
        assert not cone["unused_word"].any()
        assert len(cone["padding"]) == 16 * ragged_kernel.GATE_PAD
        assert not cone["padding"].any()
        for key in ragged_kernel.VAR_KEYS:
            np.testing.assert_array_equal(
                cone[key][1:], arrays[key][base: base + size], err_msg=key)
            assert cone[key][0] == 0, key
        for key in ragged_kernel.ROOT_KEYS:
            np.testing.assert_array_equal(
                cone[key], arrays[key][ci, :flat.num_roots], err_msg=key)
        needs[-1] = (int(row[ragged_kernel.H_SECTION_BYTES])
                     + ragged_kernel.LANES_PER_BLOCK * needs[-1])
    assert layout.smem_bytes == max(needs, default=0)
    if path == "shared":
        assert layout.smem_bytes <= ragged_kernel.SMEM_CAP
    assert layout.global_cones == (
        tuple(range(flat.num_cones)) if path == "global" else ())


def test_cone_layout_sends_only_a_cone_past_shared_memory_to_global():
    """At the default capacities a cone of about 20,000 variables needs
    more than SMEM_CAP for its section and four lane pages: it alone takes
    the global-table path."""
    big = big_cone(random.Random(6))
    small = random_cones(random.Random(7), 2)
    stream = PortStream([(small[0], ()), (big, ()), (small[1], ())])
    assert stream.ok
    flat = ragged_kernel.flatten_stream(stream, ragged_kernel.kernel_caps())
    assert stream.pages[1][1] > 16000
    assert flat.cones.global_cones == (1,)
    assert 0 < flat.cones.smem_bytes <= ragged_kernel.SMEM_CAP


def _warp_simulate(cone, page):
    """The shared path's simulate as one warp runs it: per step, the 32
    slots from the step's first gate on (past its end: later gates, then
    the zero padding) all read, then all write, unmasked."""
    page = page.copy()
    page[0] = 0
    base = cone["base"]

    def local(var):
        return np.where(var > 0, var - base + 1, 0)

    quads = {key: np.concatenate([local(cone[key]) if key in (
        "g_out", "a0", "a1", "b0", "b1") else cone[key],
        np.zeros(32, dtype=np.int64)])
        for key in ("g_out", "a0", "a1", "b0", "b1", "na0", "na1", "nb0",
                    "nb1", "g_an", "g_bn")}
    for begin in cone["step_off"][:-1]:
        s = slice(begin, begin + 32)
        q = {key: value[s] for key, value in quads.items()}
        ca = (page[q["a0"]] ^ q["na0"]) & (page[q["a1"]] ^ q["na1"])
        cb = (page[q["b0"]] ^ q["nb0"]) & (page[q["b1"]] ^ q["nb1"])
        page[q["g_out"]] = (ca ^ q["g_an"]) & (cb ^ q["g_bn"])
    return page


@pytest.mark.parametrize("make_window", [_plain_window, _mixed_window])
def test_shared_path_steps_simulate_like_the_plain_round(make_window):
    """Two levels per step, early writes of later gates and the padding
    included, the warp's pass leaves every cone's page as the plain
    simulate leaves it."""
    window = make_window(17, 12) if make_window is _plain_window \
        else make_window(24, 16)
    _ref_stream, _ref_flat, flat = _flats(window)
    x = np.random.default_rng(5).integers(0, 2, size=(3, CAPS.var_cap))
    want = torch.from_numpy(x.astype(np.int32))
    want[:, 0] = 0
    for start, end in zip(flat.arrays["level_start"][:flat.num_levels],
                          flat.arrays["level_start"][1:flat.num_levels + 1]):
        out = torch.from_numpy(flat.arrays["g_out"][start:end]).long()
        a = torch.from_numpy(flat.arrays["g_a"][start:end]).long()
        b = torch.from_numpy(flat.arrays["g_b"][start:end]).long()
        an = torch.from_numpy(flat.arrays["g_an"][start:end])
        bn = torch.from_numpy(flat.arrays["g_bn"][start:end])
        want[:, out] = (want[:, a] ^ an) & (want[:, b] ^ bn)
    for ci in range(flat.num_cones):
        cone = _decode_section(flat, ci)
        base, size = cone["base"], cone["size"]
        for lane in range(len(x)):
            page = np.concatenate([[1], x[lane, base: base + size]])
            got = _warp_simulate(cone, page)
            np.testing.assert_array_equal(
                got[1:], want[lane, base: base + size].numpy())


@pytest.mark.parametrize("make_window", [_plain_window, _mixed_window])
def test_global_path_passes_simulate_like_the_plain_round(monkeypatch,
                                                          make_window):
    """Every cone on the global-table path (a shared-memory cap of 0): the
    warp's passes, each gate of a pass reading before any writes, leave
    every cone's page as the plain simulate leaves it."""
    monkeypatch.setattr(ragged_kernel, "SMEM_CAP", 0)
    monkeypatch.setattr(ragged_kernel, "GLOBAL_PASS", 8)  # several a level
    window = make_window(17, 12) if make_window is _plain_window \
        else make_window(24, 16)
    _ref_stream, _ref_flat, flat = _flats(window)
    arrays = flat.arrays
    x = np.random.default_rng(6).integers(0, 2, size=(3, CAPS.var_cap))
    want = torch.from_numpy(x.astype(np.int32))
    want[:, 0] = 0
    for start, end in zip(arrays["level_start"][:flat.num_levels],
                          arrays["level_start"][1:flat.num_levels + 1]):
        out = torch.from_numpy(arrays["g_out"][start:end]).long()
        a = torch.from_numpy(arrays["g_a"][start:end]).long()
        b = torch.from_numpy(arrays["g_b"][start:end]).long()
        want[:, out] = (want[:, a] ^ torch.from_numpy(
            arrays["g_an"][start:end])) & (want[:, b] ^ torch.from_numpy(
                arrays["g_bn"][start:end]))
    got = x.copy()
    got[:, 0] = 0
    for ci in range(flat.num_cones):
        cone = _decode_section(flat, ci)
        assert cone["path"] == "global"
        for begin, end in cone["passes"][:-1]:
            s = slice(begin, end)
            got[:, arrays["g_out"][s]] = (
                (got[:, arrays["g_a"][s]] ^ arrays["g_an"][s])
                & (got[:, arrays["g_b"][s]] ^ arrays["g_bn"][s]))
    owned = arrays["var_cone"] >= 0
    np.testing.assert_array_equal(got[:, owned], want[:, owned].numpy())
