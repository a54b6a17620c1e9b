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
  csrc/xla_round.cu reads them (the C signature's order, the per-cone
  layout's header, offsets and tables, the blocks and the shared memory),
  drive an emulation of the kernels over the raw buffers
  (tests/test_torch_xla_layout.py) that must equal the plain round.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it on the card (tests/test_torch_cuda_xla.py, chip_smoke.py).
"""

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


@pytest.mark.parametrize("seed, lanes, steps, widest", [
    (6, 3, 0, 32), (7, 40, 6, 32), (8, 1, 12, 32), (9, 17, 5, 8)])
def test_launch_arguments_read_as_the_kernel_reads_them(seed, lanes, steps,
                                                        widest):
    """The C signature's parameters in the wrapper's order, the sizes and
    the layout's tables behind the pointers, and an emulation of the kernels over those buffers
    (tests/test_torch_xla_layout.emulate_launch: every offset from the
    header, every read inside its buffer) equal to the plain round."""
    assert _c_signature() == list(xla_kernel.ARG_ORDER)
    _ref, entries = _random_window(seed, count=3)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    xs = xla_kernel.device_stream(stream, "cpu", widest)
    generator = torch.Generator()
    generator.manual_seed(seed)
    x = circuit.init_inputs(generator, lanes, stream.v1, "cpu")
    cones = stream.tensors["root_var"].shape[0]
    x_out = torch.full_like(x, 7)
    found = torch.zeros((lanes, cones), dtype=torch.bool)
    blocks, work = xla_kernel.launch_blocks(xs.layout, lanes)
    assert work == 0, "small pages: no global tier"
    walk = stream.num_levels + 4
    args = xla_kernel.launch_arguments(xs, x, x_out, found, None, seed,
                                       steps, walk)
    assert list(args) == list(xla_kernel.ARG_ORDER)
    assert (args["lanes"], args["v1"]) == tuple(x.shape)
    assert (args["num_cones"], args["cone_slots"]) == (stream.num_cones,
                                                        cones)
    assert args["page_end"] == sum(size for _b, size in stream.pages) + 1
    assert args["blocks"] == blocks == stream.num_cones * -(-lanes // widest)
    assert args["smem_bytes"] == xs.layout.smem_bytes
    assert args["x_work"] is None
    buffers = {"cones": xs.layout.cones, "records": xs.layout.records,
               "stream_table": xs.layout.stream, "roots": xs.layout.roots,
               "x_in": x, "x_out": x_out, "found": found}
    for key, buffer in buffers.items():
        assert args[key] == buffer.data_ptr(), key
        assert buffer.dtype in (torch.int32, torch.bool), key
    from tests.test_torch_xla_layout import emulate_launch

    emulate_launch(args, {key: buffer.numel()
                          for key, buffer in buffers.items()})
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
