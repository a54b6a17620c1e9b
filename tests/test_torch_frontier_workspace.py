"""The CUDA frontier step's host side on the CPU: the packed step layout
and workspace (gpu/frontier_kernel.StepLayout, StepWorkspace), the
launch arguments one step hands the library, the block shape chosen from
a run's capacity, the frame checks, and the wrapper's CPU rule (CPU
tensors, and only those, run kernel.step_plain).

A CUDA step is one copy up, one launch and one copy down between reused
buffers; here the test moves the same buffers through the plain version
in the kernel's place, so the packed layout is held to the host step
(numpy) on seeded random runs.
"""

import ctypes
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mythril_tpu_torch.gpu import frontier_kernel
from mythril_tpu_torch.laser.frontier import dense, kernel
from mythril_tpu_torch.support.workloads import (
    frontier_frame,
    frontier_program,
    frontier_run,
    push_bytes,
)

CPU = torch.device("cpu")
# (n_log, n_fork): a run that neither stores nor forks, and one that does
LOG_FORK = ((0, 0), (3, 2))


def _copy(frame):
    copy = dense.DenseFrontier(frame.batch, frame.stack.shape[1],
                               frame.mem.shape[1])
    for name in ("stack", "mem", "mem_written", "msize", "min_gas",
                 "max_gas", "gas_limit", "live"):
        setattr(copy, name, getattr(frame, name).copy())
    return copy


def _random_fields(layout, rng):
    """Random contents for every field of a layout."""
    values = {}
    for name, (_offset, dtype, shape) in layout.fields.items():
        if dtype == np.bool_:
            values[name] = rng.random(shape) < 0.5
        else:
            values[name] = rng.integers(-2**31, 2**31, shape, dtype=np.int32)
    return values


@pytest.mark.parametrize("n_log,n_fork", LOG_FORK)
@pytest.mark.parametrize("window", (1, 2048))
@pytest.mark.parametrize("rows", (1, 3, 4, 5, 64))
def test_layout_packs_and_unpacks_every_field(rows, window, n_log, n_fork):
    """Every field round-trips exactly: written into the host buffer,
    uploaded, read as the device's tensors; written on the device,
    downloaded, read as the host's numpy views. Fields are aligned and
    disjoint; the upload holds the inputs and the window, the download
    the outputs and, only for a run that stores, the window."""
    layout = frontier_kernel.StepLayout(rows, 5, 4, window, n_log, n_fork)
    spans = sorted((offset, offset + np.dtype(dtype).itemsize
                    * int(np.prod(shape)), name)
                   for name, (offset, dtype, shape) in layout.fields.items())
    for (start, end, _), (next_start, _, _) in zip(spans, spans[1:]):
        assert start % frontier_kernel.ALIGN == 0 and end <= next_start
    assert spans[-1][1] <= layout.total
    inputs = [name for name, _ in frontier_kernel.INPUT_FIELDS
              + frontier_kernel.IN_PLACE_FIELDS]
    assert all(layout.fields[name][0] < layout.upload_end for name in inputs)
    assert layout.upload_end <= layout.fields["stack_out"][0]
    assert layout.download_start == layout.fields[
        "mem" if n_log else "stack_out"][0]

    rng = np.random.default_rng(rows * 7 + window + n_log)
    space = frontier_kernel.StepWorkspace(CPU)
    space.reserve(layout.total)
    views = space.views(layout)
    sent = _random_fields(layout, rng)
    for name in inputs:
        views[name][...] = sent[name]
    space.dev[:layout.upload_end].copy_(space.host[:layout.upload_end])
    on_device = layout.tensor_views(space.dev)
    for name in inputs:
        assert np.array_equal(on_device[name].numpy(), sent[name]), name
    back = _random_fields(layout, rng)
    for name, _ in frontier_kernel.IN_PLACE_FIELDS + \
            frontier_kernel.OUTPUT_FIELDS:
        on_device[name].copy_(torch.from_numpy(back[name]))
    start = layout.download_start
    space.host[start:layout.total].copy_(space.dev[start:layout.total])
    for name, _ in frontier_kernel.OUTPUT_FIELDS:
        assert np.array_equal(views[name], back[name]), name
    for name, _ in frontier_kernel.IN_PLACE_FIELDS:
        want = back[name] if n_log else sent[name]
        assert np.array_equal(views[name], want), name


def test_launch_args_are_one_upload_one_launch_one_download():
    """The arguments a CUDA step hands frontier_step: the frame's
    pointers lie in the device buffer at the layout's offsets, and the two
    copies run between the pinned buffer and the device buffer over the
    layout's upload and download spans. They are built once a shape."""
    run = frontier_run(push_bytes(1) + push_bytes(64) + b"\x52"
                       + push_bytes(3) + b"\x01\x00")
    layout = frontier_kernel.step_layout(run, 6, run.window)
    space = frontier_kernel.StepWorkspace(CPU)
    space.reserve(layout.total)
    args = space.launch_args(run, layout)
    assert space.launch_args(run, layout) is args
    host, dev = space.host.data_ptr(), space.dev.data_ptr()
    assert (args.upload_src, args.upload_dst) == (host, dev)
    assert args.upload_bytes == layout.upload_end
    assert args.download_src == dev + layout.download_start
    assert args.download_dst == host + layout.download_start
    assert args.download_bytes == layout.total - layout.download_start
    for field, name in frontier_kernel._FRAME_POINTERS:
        assert getattr(args.frame, field) == dev + layout.fields[name][0]
    ops, consts = frontier_kernel.program_tensors(run, CPU)
    assert (args.frame.ops, args.frame.consts) == (ops.data_ptr(),
                                                   consts.data_ptr())
    assert (args.frame.rows, args.frame.n_log, args.frame.n_fork) == (6, 1, 0)
    assert args.frame.pitch == frontier_kernel.stack_pitch(run.capacity)
    assert args.frame.block_rows == frontier_kernel.MAX_BLOCK_ROWS
    assert ctypes.sizeof(args) == ctypes.sizeof(frontier_kernel._StepArgs)


def test_workspace_grows_geometrically_and_is_reused():
    """Steps of one shape, or a smaller one, allocate nothing; a larger
    one at least doubles the buffers."""
    rng = random.Random(3)
    run = frontier_run(push_bytes(1) + push_bytes(2) + b"\x01\x00")
    space = frontier_kernel.workspace(CPU)
    frontier_kernel.pack_frame(run, frontier_frame(rng, run, 64), CPU)
    allocations, capacity = space.allocations, space.capacity
    for rows in (64, 1, 17, 64):
        frontier_kernel.pack_frame(run, frontier_frame(rng, run, rows), CPU)
    assert (space.allocations, space.capacity) == (allocations, capacity)
    wide = frontier_kernel.step_layout(run, 100 * 64, run.window)
    space.reserve(wide.total)
    assert space.allocations == allocations + 1
    assert space.capacity >= max(wide.total, 2 * capacity)


def _packed_step_on_cpu(run, frame):
    """What step_frame does on a card, with the plain version in the
    kernel's place: the frame packed, the upload span copied, the step run
    on the device buffer's fields and its results written there, the
    download span copied back; step_batch's nine read from the views."""
    space, layout, views = frontier_kernel.pack_frame(run, frame, CPU)
    space.dev[:layout.upload_end].copy_(space.host[:layout.upload_end])
    fields = layout.tensor_views(space.dev)
    results = frontier_kernel.run_step_kernel(
        run, *(fields[name] for name in frontier_kernel.FRAME_FIELDS))
    for name, value in zip(frontier_kernel.RESULT_FIELDS, results):
        if value is not fields[name]:
            fields[name].copy_(value)
    start = layout.download_start
    space.host[start:layout.total].copy_(space.dev[start:layout.total])
    return (views["stack_out"], views["mem"], views["written"],
            views["msize_out"], views["min_gas_out"], views["max_gas_out"],
            views["ok"],
            [(views["log_off"][:, k], views["log_val"][:, k])
             for k in range(layout.key[4])],
            [views["fork_out"][:, k] for k in range(layout.key[5])])


def test_packed_step_on_cpu_equals_the_host_step():
    """The packed layout with the plain version in the kernel's place, and
    step_batch's cuda backend on a CPU device (the wrapper's rule: the
    plain version), each against the numpy step: the same ok mask, and
    every output equal on the ok rows, over seeded random runs of 1-9
    rows."""
    rng = random.Random(0x5EED)
    checked = 0
    while checked < 12:
        code, init_stack = frontier_program(rng, edge_bias=0.25)
        run = frontier_run(code)
        if run is None or any(op.arg in ("div", "mod", "sdiv", "smod")
                              for op in run.ops):
            continue  # the plain version's bit-serial division is slow here
        frame = frontier_frame(rng, run, rng.randint(1, 9), init_stack,
                               edge_bias=0.25)
        want = kernel.step_batch(run, _copy(frame), "numpy")
        for got in (_packed_step_on_cpu(run, frame),
                    kernel.step_batch(run, frame, "cuda", CPU)):
            ok = want[6]
            assert np.array_equal(got[6], ok)
            for x, y in zip(got[:6], want[:6]):
                assert np.array_equal(x[ok], y[ok])
            assert len(got[7]) == len(want[7])
            for (x_off, x_val), (y_off, y_val) in zip(got[7], want[7]):
                assert np.array_equal(x_off[ok], y_off[ok])
                assert np.array_equal(x_val[ok], y_val[ok])
            assert len(got[8]) == len(want[8])
            for x, y in zip(got[8], want[8]):
                assert np.array_equal(x[ok], y[ok])
        checked += 1


def test_cpu_tensors_run_step_plain_and_count_nothing():
    """run_step_kernel on CPU tensors returns step_plain's outputs and
    counts no launch; prepare_launch and step_frame, which only launch the
    kernel, refuse a CPU device."""
    rng = random.Random(11)
    run = frontier_run(push_bytes(7) + push_bytes(32) + b"\x52"
                       + push_bytes(32) + b"\x51" + push_bytes(5) + b"\x02"
                       + push_bytes(3) + b"\x1b\x00")
    frame = frontier_frame(rng, run, 5)
    before = frontier_kernel.launches
    got = frontier_kernel.run_step_kernel(
        run, *kernel.frame_tensors(frame, CPU))
    want = kernel.step_plain(run, *kernel.frame_tensors(frame, CPU))
    assert frontier_kernel.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        frontier_kernel.prepare_launch(run, *kernel.frame_tensors(frame, CPU))
    with pytest.raises(ValueError):
        frontier_kernel.step_frame(run, frame, CPU)
    assert frontier_kernel.launches == before


def _run_like(run, **changes):
    fields = {name: getattr(run, name) for name in (
        "ops", "touch", "out_len", "capacity", "has_mem", "window", "key",
        "fork", "halt")}
    fields.update(changes)
    return SimpleNamespace(**fields)


@pytest.mark.parametrize("case", ("capacity", "misaligned", "window",
                                  "dtype", "shape"))
def test_check_frame_refuses_what_the_kernel_cannot_take(case):
    """A stack over the block's shared memory, a stack not on a 16-byte
    boundary, a memory run's window under 32 bytes, a wrong dtype or shape:
    each raises before anything runs, on the CPU as on the card."""
    rng = random.Random(5)
    run = frontier_run(b"\x01" + push_bytes(0) + b"\x52\x00")
    assert run.touch == 2 and run.has_mem
    frame = frontier_frame(rng, run, 3)
    tensors = kernel.frame_tensors(frame, CPU)
    if case == "capacity":
        run = _run_like(run, capacity=8000)
    elif case == "misaligned":
        flat = torch.zeros(tensors[0].numel() + 1, dtype=torch.int32)
        tensors[0] = flat[1:].view(tensors[0].shape)
    elif case == "window":
        tensors[1] = tensors[1][:, :16].contiguous()
        tensors[2] = tensors[2][:, :16].contiguous()
    elif case == "dtype":
        tensors[3] = tensors[3].long()
    else:
        tensors[4] = tensors[4][:2]
    with pytest.raises(ValueError):
        frontier_kernel.run_step_kernel(run, *tensors)


def test_block_rows_follow_the_capacity():
    """Eight rows a block while their stacks fit 227 KB of shared memory,
    fewer for a deep stack, none past one row's worth; the pitch is odd."""
    assert frontier_kernel.block_rows(0) == frontier_kernel.MAX_BLOCK_ROWS
    assert frontier_kernel.block_rows(900) == frontier_kernel.MAX_BLOCK_ROWS
    assert frontier_kernel.block_rows(1024) == 7
    assert frontier_kernel.block_rows(7263) == 1
    assert frontier_kernel.block_rows(7264) == 0
    assert all(frontier_kernel.stack_pitch(c) % 2 == 1
               for c in (0, 1, 2, 1023, 1024))
