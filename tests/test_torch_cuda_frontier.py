"""The CUDA frontier step (K6, with K7's division inside) held against its
plain PyTorch version on a card: the ok masks equal, and every output
equal on the ok rows (integers: zero tolerance).

Marked `cuda`: these skip without a card. They import only the port (not
even the shared test helpers), so they run where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda_frontier.py -m cuda
"""

import random

import pytest
import torch

from mythril_tpu_torch.gpu import frontier_kernel
from mythril_tpu_torch.laser.frontier import kernel
from mythril_tpu_torch.support.workloads import (
    EDGE_WORDS,
    frontier_frame,
    frontier_program,
    frontier_run,
    push_bytes,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: xdist workers must all
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README, PyTorch/CUDA port)")
    return torch.device("cuda", 0)


def _assert_matches_plain(run, frame, device):
    before = frontier_kernel.launches
    got = frontier_kernel.run_step_kernel(
        run, *kernel.frame_tensors(frame, device))
    assert frontier_kernel.launches == before + 1
    want = kernel.step_plain(run, *kernel.frame_tensors(frame, device))
    torch.cuda.synchronize(device)
    ok = want[6]
    assert torch.equal(got[6], ok)
    for index, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape, index
        assert torch.equal(x[ok], y[ok]), index
    return int(ok.sum())


def test_k6_matches_plain_on_random_runs(cuda_device):
    """40 seeded random runs over 1-64 rows, a quarter of the words at the
    edges (0, 1, 2^255, 2^256 - 1), some rows starved of gas."""
    rng = random.Random(0xC0DA)
    checked = ok_rows = 0
    while checked < 40:
        code, init_stack = frontier_program(rng, edge_bias=0.25)
        run = frontier_run(code)
        if run is None:
            continue
        frame = frontier_frame(rng, run, rng.randint(1, 64), init_stack,
                               edge_bias=0.25)
        ok_rows += _assert_matches_plain(run, frame, cuda_device)
        checked += 1
    assert ok_rows > 0


def test_k6_division_edges(cuda_device):
    """DIV, SDIV, MOD, SMOD and MUL over every pair of edge words, one pair
    a row (-2^255 / -1 included)."""
    rng = random.Random(5)
    for opcode in (0x04, 0x05, 0x06, 0x07, 0x02):
        # [a, b] -> DUP2 DUP2 op, then POP the copies' result back under
        code = bytes([0x81, 0x81, opcode, 0x60, 0x00, 0x52, 0x00])
        run = frontier_run(code)
        pairs = [(a, b) for a in EDGE_WORDS for b in EDGE_WORDS]
        frame = frontier_frame(rng, run, len(pairs), starved_share=0.0)
        for i, (a, b) in enumerate(pairs):
            for j, value in enumerate((b, a)):  # a ends on top
                frame.stack[i, j] = list(value.to_bytes(32, "big"))
        assert _assert_matches_plain(run, frame, cuda_device) == len(pairs)


def test_k6_memory_window_edges(cuda_device):
    """Stores and loads at the last in-window offsets and past them: the
    out-of-window rows drop out of ok, the others match."""
    rng = random.Random(9)
    for offset in (0, 31, 2016, 2017, 2047, 2048, 1 << 24, 1 << 200):
        code = (push_bytes(0xAB) + push_bytes(offset) + b"\x53"
                + push_bytes(offset) + b"\x51"
                + push_bytes(0xCD) + push_bytes(offset) + b"\x52\x00")
        run = frontier_run(code)
        frame = frontier_frame(rng, run, 8, starved_share=0.25)
        _assert_matches_plain(run, frame, cuda_device)


def test_cuda_backend_equals_numpy_step(cuda_device):
    """step_batch(backend="cuda") equals the host step row for row on the
    ok rows, with the same ok mask."""
    rng = random.Random(0xFEED)
    checked = 0
    while checked < 10:
        code, init_stack = frontier_program(rng)
        run = frontier_run(code)
        if run is None:
            continue
        frame = frontier_frame(rng, run, 16, init_stack)
        copy = frontier_frame(random.Random(0), run, 16)
        for name in ("stack", "mem", "mem_written", "msize", "min_gas",
                     "max_gas", "gas_limit", "live"):
            getattr(copy, name)[...] = getattr(frame, name)
        got = kernel.step_batch(run, frame, "cuda", cuda_device)
        want = kernel.step_batch(run, copy, "numpy")
        ok = want[6]
        assert (got[6] == ok).all()
        for x, y in zip(got[:6], want[:6]):
            assert (x[ok] == y[ok]).all()
        for (x_off, x_val), (y_off, y_val) in zip(got[7], want[7]):
            assert (x_off[ok] == y_off[ok]).all()
            assert (x_val[ok] == y_val[ok]).all()
        checked += 1
