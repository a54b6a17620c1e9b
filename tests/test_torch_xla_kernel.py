"""K2, the XLA-semantics ragged round (mythril_tpu_torch/gpu/xla_kernel.py),
held against the JAX package's XLA round (mythril_tpu/tpu/circuit.py
run_round_ragged) on the CPU, and the kernel knob (ragged_kernel.
kernel_mode).

- The stream: the port's RaggedStream with the 1.5x shape bucket is byte
  for byte the reference's, on `_random_cone` windows and on the windows of
  tests/test_pallas_kernel.py's `_build_entries` (plain cones, cube
  replicas and fork pins).
- At steps=0 both rounds are deterministic (a reset, one simulate and the
  root check): x and found must be bit-identical (zero tolerance).
- With steps the randomness differs (the port's counter hash, the
  reference's threefry bits), so the found mask is held to the
  brute-force oracle on the reference's `_differential_windows` windows
  (the counterpart of test_xla_kernel_matches_bruteforce_oracle), and every
  witness must pass the host re-evaluation of its roots and pins.
- The launch: the wrapper's arguments, read back the way
  csrc/xla_round.cu reads them (the C signature's order, the row strides
  widened to 64 bits, the tables' lengths), drive an emulation of the
  kernel's phases over the raw buffers that must equal the plain round.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda_xla.py, chip_smoke.py).
"""

import ctypes
import logging
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.tpu import circuit as ref_circuit
from mythril_tpu_torch.gpu import circuit, ragged_kernel, xla_kernel
from mythril_tpu_torch.gpu.backend import shape_bucket
from tests.test_pallas_kernel import _build_entries, _differential_windows
from tests.test_ragged import _random_cone
from tests.torch_helpers import assert_packed_equal, port_packed

LANES = 8


def _random_window(seed, count=4):
    """(reference entries, port entries) of `count` random cones, every
    other one with an input pinned as a cube does."""
    rng = random.Random(seed)
    ref, port, cache = [], [], {}
    while len(ref) < count:
        aig, roots = _random_cone(rng, rng.randint(3, 8), rng.randint(8, 40))
        pc = ref_circuit.PackedCircuit(aig, roots)
        if not pc.ok:
            continue
        port_pc = port_packed(pc, aig, roots, cache)
        assert_packed_equal(pc, port_pc)
        extra = (((1, bool(seed % 2)),) if len(ref) % 2 and pc.v1 > 1
                 else ())
        ref.append((pc, extra))
        port.append((port_pc, extra))
    return ref, port


def _oracle_window(start, size=12):
    """(reference entries, port entries) of `size` of _build_entries'
    oracle-labelled entries from `start`."""
    ref, port, cache = [], [], {}
    for pc, extra, aig, roots, _pins, _sat in _build_entries()[
            start: start + size]:
        port_pc = port_packed(pc, aig, roots, cache)
        assert_packed_equal(pc, port_pc)
        ref.append((pc, extra))
        port.append((port_pc, extra))
    return ref, port


def _assert_stream_equal(ref_stream, stream):
    for name in ("num_cones", "cone_slots", "v1", "num_levels", "width",
                 "max_roots", "pages"):
        assert getattr(stream, name) == getattr(ref_stream, name), name
    for key in ref_circuit.TENSOR_KEYS:
        want, got = ref_stream.tensors[key], stream.tensors[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("source, seed", [
    ("random", 1), ("random", 2), ("random", 3), ("oracle", 0),
    ("oracle", 60)])
def test_zero_steps_equal_the_reference_round(source, seed):
    ref_entries, entries = (_random_window(seed) if source == "random"
                            else _oracle_window(seed))
    ref_stream = ref_circuit.RaggedStream(ref_entries)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    _assert_stream_equal(ref_stream, stream)
    x = np.random.RandomState(seed).randint(
        0, 2, (LANES, stream.v1)).astype(np.int32)
    want_x, want_found = ref_circuit.run_round_ragged(
        {key: jnp.asarray(value) for key, value in ref_stream.tensors.items()},
        jnp.asarray(x), jax.random.PRNGKey(seed), steps=0,
        walk_depth=stream.num_levels + 4)
    xs = xla_kernel.device_stream(stream, "cpu")
    got_x, got_found = xla_kernel.run_round_xla_kernel(
        xs, torch.as_tensor(x), seed, 0, stream.num_levels + 4)
    assert got_x.dtype == torch.int32 and got_found.dtype == torch.bool
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_found.numpy(), np.asarray(want_found))
    # the padding cone slots: no live root, found at step 0
    assert got_found[:, stream.num_cones:].all()


def _run_port_window(stream, seed, steps):
    """_differential_windows' run_window on K2's plain version: the
    reference's stream tensors (bucketed as its XLA round takes them),
    8 lanes from a seeded generator."""
    xs = xla_kernel.device_stream(stream, "cpu")
    generator = torch.Generator()
    generator.manual_seed(seed)
    x = circuit.init_inputs(generator, LANES, stream.v1, "cpu")
    x, found = xla_kernel.run_round_xla_kernel(
        xs, x, seed * 7919 + 13, steps, stream.num_levels + 4)
    return x.numpy(), found.numpy()[:, : stream.num_cones]


def test_found_mask_equals_the_bruteforce_oracle():
    """Every SAT entry found within the rounds, no UNSAT entry ever, and
    every witness a model of its roots and pins on the host AIG."""
    _differential_windows(_run_port_window, "xla (port)")


@pytest.mark.parametrize("seed", [4, 5])
def test_rounds_return_gate_consistent_models(seed):
    """With steps, every returned row is gate-consistent (a final simulate
    changes nothing), every row found for a cone satisfies its roots and
    pins, var 0 stays 0, and the same seed gives the same result."""
    ref_entries, entries = _random_window(seed, count=5)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    xs = xla_kernel.device_stream(stream, "cpu")
    generator = torch.Generator()
    generator.manual_seed(seed)
    x = circuit.init_inputs(generator, LANES, stream.v1, "cpu")
    got_x, got_found = xla_kernel.run_round_xla_plain(xs, x, seed, 48, 64)
    again_x, again_found = xla_kernel.run_round_xla_plain(xs, x, seed, 48, 64)
    assert torch.equal(got_x, again_x) and torch.equal(got_found,
                                                        again_found)
    assert not got_x[:, 0].any()
    resim, _found = xla_kernel.run_round_xla_plain(xs, got_x, seed, 0, 0)
    assert torch.equal(resim, got_x)
    ref_stream = ref_circuit.RaggedStream(ref_entries)
    for ci, (pc, extra) in enumerate(ref_entries):
        for lane in np.nonzero(got_found[:, ci].numpy())[0]:
            local = ref_stream.cone_assignment(ci, got_x[lane].numpy())
            for root in range(pc.num_roots):
                if pc.root_mask[root]:
                    assert local[pc.root_var[root]] ^ pc.root_neg[root]
            for lvar, want in extra:
                assert bool(local[lvar]) == want


# -- the launch arguments, read the way the kernel reads them ---------------


def _c_signature():
    """The parameter names of csrc/xla_round.cu's xla_round_launch."""
    with open(xla_kernel.KERNEL_SOURCE) as handle:
        source = handle.read()
    params = re.search(r"int xla_round_launch\(([^)]*)\)", source).group(1)
    return [re.split(r"[\s*]+", part.strip())[-1]
            for part in params.split(",")]


def _view(address, count, ctype=ctypes.c_int32):
    """A numpy view of `count` elements at a raw address."""
    return np.ctypeslib.as_array((ctype * count).from_address(address))


def _emulate_kernel(args):
    """csrc/xla_round.cu's phases over the raw buffers named by `args`
    (launch_arguments), each index computed as the kernel computes it: the
    tables' lengths and row strides come from the size arguments alone."""
    lanes, v1, levels, width = (args[k] for k in ("lanes", "v1", "levels",
                                                  "width"))
    cones, roots = args["cones"], args["roots"]
    steps, walk_depth, seed = args["steps"], args["walk_depth"], args["seed"]
    level = {k: _view(args[k], levels * width)
             for k in xla_kernel.LEVEL_KEYS}
    rows = _view(args["level_rows"], levels)
    var = {k: _view(args[k], v1) for k in xla_kernel.VAR_KEYS}
    root = {k: _view(args[k], cones * roots) for k in xla_kernel.ROOT_KEYS}
    x_in = _view(args["x_in"], lanes * v1)
    x_out = _view(args["x_out"], lanes * v1)
    found = _view(args["found"], lanes * cones, ctypes.c_uint8)
    flips = _view(args["flips"], lanes * cones * 2)
    h = ragged_kernel._hash32
    m = ragged_kernel._mul32

    def simulate(base):
        x_out[base] = 0
        for lv in range(levels):
            for i in range(min(int(rows[lv]), width)):
                at = lv * width + i
                out = int(level["out_idx"][at])
                if out:
                    x_out[base + out] = (
                        (x_out[base + level["a_var"][at]]
                         ^ level["a_neg"][at])
                        & (x_out[base + level["b_var"][at]]
                           ^ level["b_neg"][at]))

    def check(base, c, key_base):
        best_key, best = -1, 0
        for r in range(roots):
            at = c * roots + r
            if root["root_mask"][at] != 1 or (
                    x_out[base + root["root_var"][at]]
                    ^ root["root_neg"][at]) != 0:
                continue
            key = h(key_base ^ m(r, ragged_kernel._C_ROOT)) >> 1
            if key > best_key:
                best_key, best = key, r
        return best_key < 0, best

    for lane in range(lanes):
        base = lane * v1
        x_out[base: base + v1] = x_in[base: base + v1]
        found[lane * cones: (lane + 1) * cones] = 0
        for step in range(steps):
            simulate(base)
            step_key = h(seed ^ m(step, ragged_kernel._C_STEP))
            for c in range(cones):
                salt = (m(lane, ragged_kernel._C_LANE)
                        ^ m(c, ragged_kernel._C_CONE))
                done, choice = check(base, c, step_key ^ salt)
                end = (0, 0)
                if found[lane * cones + c] or done:
                    found[lane * cones + c] = 1
                else:
                    at = c * roots + choice
                    cur = int(root["root_var"][at])
                    want = 1 ^ int(root["root_neg"][at])
                    coin_base = step_key ^ ragged_kernel._C_COIN ^ salt
                    for depth in range(walk_depth):
                        if var["is_gate"][cur] != 1:
                            break
                        ai, an = int(var["ga_var"][cur]), var["ga_neg"][cur]
                        bi, bn = int(var["gb_var"][cur]), var["gb_neg"][cur]
                        av, bv = x_out[base + ai] ^ an, x_out[base + bi] ^ bn
                        if (av & bv) == want:
                            break
                        coin = h(coin_base
                                 ^ m(depth, ragged_kernel._C_DEPTH)) & 1
                        take_b = (((av == 1 and bv == 0)
                                   or (av == 0 and bv == 0 and coin))
                                  if want == 1 else
                                  ((av == 0 and bv == 1)
                                   or (av == 1 and bv == 1 and coin)))
                        cur = bi if take_b else ai
                        want ^= int(bn if take_b else an)
                    end = (cur, want)
                flips[2 * (lane * cones + c): 2 * (lane * cones + c) + 2] \
                    = end
            for c in range(cones):
                cur, want = flips[2 * (lane * cones + c):
                                  2 * (lane * cones + c) + 2]
                if cur > 0:
                    x_out[base + cur] = want
        simulate(base)
        for c in range(cones):
            if check(base, c, 0)[0]:
                found[lane * cones + c] = 1


@pytest.mark.parametrize("seed, lanes, steps", [(6, 3, 0), (7, 2, 6),
                                                (8, 1, 12)])
def test_launch_arguments_read_as_the_kernel_reads_them(seed, lanes, steps):
    """The C signature's parameters in the wrapper's order, the ctypes
    types behind them, every table's length from the size arguments, and
    an emulation of the kernel over those buffers equal to the plain
    round."""
    assert _c_signature() == list(xla_kernel.ARG_ORDER)
    _ref, entries = _random_window(seed, count=3)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    xs = xla_kernel.device_stream(stream, "cpu")
    generator = torch.Generator()
    generator.manual_seed(seed)
    x = circuit.init_inputs(generator, lanes, stream.v1, "cpu")
    cones, roots = stream.tensors["root_var"].shape
    x_out = torch.full_like(x, 7)
    found = torch.ones((lanes, cones), dtype=torch.bool)
    flips = torch.zeros((lanes, cones, 2), dtype=torch.int32)
    walk = stream.num_levels + 4
    args = xla_kernel.launch_arguments(xs, x, x_out, found, flips, seed,
                                       steps, walk)
    assert list(args) == list(xla_kernel.ARG_ORDER)
    assert (args["lanes"], args["v1"]) == tuple(x.shape)
    assert (args["levels"], args["width"]) == (stream.num_levels,
                                               stream.width)
    assert (args["cones"], args["roots"]) == (cones, roots)
    lengths = dict({key: args["levels"] * args["width"]
                    for key in xla_kernel.LEVEL_KEYS},
                   level_rows=args["levels"],
                   x_in=args["lanes"] * args["v1"],
                   x_out=args["lanes"] * args["v1"],
                   found=args["lanes"] * args["cones"],
                   flips=args["lanes"] * args["cones"] * 2)
    lengths.update({key: args["v1"] for key in xla_kernel.VAR_KEYS})
    lengths.update({key: args["cones"] * args["roots"]
                    for key in xla_kernel.ROOT_KEYS})
    buffers = dict(xs.tensors, level_rows=xs.level_rows, x_in=x,
                   x_out=x_out, found=found, flips=flips)
    for key in xla_kernel.POINTER_ARGS:
        assert args[key] == buffers[key].data_ptr(), key
        assert buffers[key].numel() == lengths[key], key
    # the largest offsets the kernel forms, in 64 bits, stay in the buffers
    assert (args["lanes"] - 1) * args["v1"] + args["v1"] - 1 \
        < buffers["x_in"].numel()
    assert (args["levels"] - 1) * args["width"] + args["width"] - 1 \
        < buffers["out_idx"].numel()
    _emulate_kernel(args)
    want_x, want_found = xla_kernel.run_round_xla_plain(xs, x, seed, steps,
                                                        walk)
    assert torch.equal(x_out, want_x)
    assert torch.equal(found, want_found)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors_only():
    _ref, entries = _random_window(9, count=2)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    xs = xla_kernel.device_stream(stream, "cpu")
    x = circuit.init_inputs(torch.Generator(), LANES, stream.v1, "cpu")
    xla_kernel.reset_launches()
    got = xla_kernel.run_round_xla_kernel(xs, x, 3, 8, 16)
    want = xla_kernel.run_round_xla_plain(xs, x, 3, 8, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert xla_kernel.launches == 0  # the plain version counts nothing
    with pytest.raises(ValueError, match="no xla round"):
        xla_kernel.run_round_xla_kernel(
            xla_kernel.XlaStream({k: v.to("meta") for k, v
                                  in xs.tensors.items()},
                                 xs.level_rows.to("meta"), xs.num_cones),
            x.to("meta"), 3, 8, 16)
    with pytest.raises(ValueError, match="x must be"):
        xla_kernel.run_round_xla_kernel(xs, x.long(), 3, 8, 16)
    with pytest.raises(ValueError, match="ga_var"):
        xla_kernel.run_round_xla_kernel(xs, x[:, :-1].contiguous(), 3, 8, 16)
    with pytest.raises(ValueError, match="root_mask"):
        xla_kernel.run_round_xla_kernel(
            xs._replace(tensors=dict(
                xs.tensors, root_mask=xs.tensors["root_mask"].repeat(1, 2))),
            x, 3, 8, 16)


def test_level_rows_count_to_each_levels_last_gate():
    out_idx = np.array([[3, 4, 0, 0], [0, 0, 0, 0], [0, 5, 0, 6],
                        [7, 0, 0, 0]], dtype=np.int32)
    assert xla_kernel.level_rows(out_idx).tolist() == [2, 0, 4, 1]


# -- the kernel knob ----------------------------------------------------------


@pytest.mark.parametrize("raw, mode", [(None, "pallas"), ("auto", "pallas"),
                                       ("pallas", "pallas"), ("xla", "xla"),
                                       (" XLA ", "xla"), ("", "pallas")])
def test_kernel_mode_resolves_the_knob(monkeypatch, raw, mode):
    if raw is None:
        monkeypatch.delenv("MYTHRIL_GPU_KERNEL", raising=False)
    else:
        monkeypatch.setenv("MYTHRIL_GPU_KERNEL", raw)
    ragged_kernel.reset_kernel_mode()
    try:
        assert ragged_kernel.kernel_mode() == mode
    finally:
        ragged_kernel.reset_kernel_mode()


def test_kernel_mode_warns_caches_and_ignores_the_reference_knob(
        monkeypatch, caplog):
    monkeypatch.setenv("MYTHRIL_TPU_KERNEL", "xla")
    monkeypatch.setenv("MYTHRIL_GPU_KERNEL", "triton")
    ragged_kernel.reset_kernel_mode()
    try:
        with caplog.at_level(logging.WARNING):
            assert ragged_kernel.kernel_mode() == "pallas"
        assert "unknown MYTHRIL_GPU_KERNEL" in caplog.text
        monkeypatch.setenv("MYTHRIL_GPU_KERNEL", "xla")
        assert ragged_kernel.kernel_mode() == "pallas"  # cached
        ragged_kernel.reset_kernel_mode()
        assert ragged_kernel.kernel_mode() == "xla"
        monkeypatch.delenv("MYTHRIL_GPU_KERNEL")
        ragged_kernel.reset_kernel_mode()
        assert ragged_kernel.kernel_mode() == "pallas"
    finally:
        ragged_kernel.reset_kernel_mode()
