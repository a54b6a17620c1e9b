"""The CUDA frontier step (K6, with K7's division inside) held against its
plain PyTorch version on a card: the ok masks equal, and every output
equal on the ok rows (integers: zero tolerance), through the tensor
wrapper and through the packed step the stepper takes.

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


def _assert_packed_matches_plain(run, frame, device):
    """The packed step (one copy up, the launch, one copy down) against
    the plain version: the same ok mask, every output equal on the ok
    rows."""
    before = frontier_kernel.launches
    got = kernel.step_batch(run, frame, "cuda", device)
    assert frontier_kernel.launches == before + 1
    want = [tensor.cpu().numpy() for tensor in kernel.step_plain(
        run, *kernel.frame_tensors(frame, device))]
    ok = want[6]
    assert (got[6] == ok).all()
    for index in range(6):
        assert (got[index][ok] == want[index][ok]).all(), index
    for k, (offsets, values) in enumerate(got[7]):
        assert (offsets[ok] == want[7][:, k][ok]).all()
        assert (values[ok] == want[8][:, k][ok]).all()
    for k, fork_word in enumerate(got[8]):
        assert (fork_word[ok] == want[9][:, k][ok]).all()


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


@pytest.mark.parametrize("rows", (1, 3, 5, 63, 65, 257))
def test_k6_row_counts_off_the_warp(cuda_device, rows):
    """Row counts that are not a multiple of a warp's 4 rows or a block's
    8: the last block's spare lanes write nothing, and through the packed
    step (step_batch's cuda backend) as through the tensor wrapper."""
    rng = random.Random(rows)
    checked = 0
    while checked < 4:
        code, init_stack = frontier_program(rng, edge_bias=0.25)
        run = frontier_run(code)
        if run is None:
            continue
        frame = frontier_frame(rng, run, rows, init_stack, edge_bias=0.25)
        _assert_matches_plain(run, frame, cuda_device)
        _assert_packed_matches_plain(run, frame, cuda_device)
        checked += 1


def test_k6_deep_run_takes_fewer_rows_a_block(cuda_device):
    """A run of DUP16/SWAP16 chains over a 966-word touch: 967 stack slots
    a row leave room for 7 rows a block in shared memory, not 8, so the
    block shape changes; the results do not."""
    chain = bytes([0x8F, 0x9F, 0x50, 0x50]) * 950
    run = frontier_run(chain + bytes([0x8F] * 16) + bytes([0x01] * 15)
                       + b"\x00")
    assert run.capacity == 967
    assert frontier_kernel.block_rows(run.capacity) == 7
    assert frontier_kernel.block_rows(32) == frontier_kernel.MAX_BLOCK_ROWS
    rng = random.Random(0xDEE9)
    for rows in (1, 7, 8, 30):
        frame = frontier_frame(rng, run, rows, edge_bias=0.25,
                               starved_share=0.0)
        assert _assert_matches_plain(run, frame, cuda_device) == rows
        _assert_packed_matches_plain(run, frame, cuda_device)


# (dividend, divisor) pairs whose quotient digit's first estimate is one
# too large after the D3 test, so Algorithm D adds the divisor back: built,
# as in the test table of Hacker's Delight's divmnu, from the digits 0, 1,
# 2^31 - 1, 2^31, 2^32 - 2 and 2^32 - 1, one pair for each divisor length
# of 3 to 8 words (a search over those digits against the algorithm's
# steps found them)
ADD_BACK = (
    (0xFFFFFFFF7FFFFFFF00000000000000000000000000000000FFFFFFFE7FFFFFFF,
     0x7FFFFFFF00000000FFFFFFFF),
    (0xFFFFFFFEFFFFFFFF80000000FFFFFFFE00000001FFFFFFFE00000000FFFFFFFE,
     0x8000000080000000FFFFFFFF7FFFFFFF),
    (0xFFFFFFFE7FFFFFFFFFFFFFFEFFFFFFFF7FFFFFFF7FFFFFFF8000000080000000,
     0xFFFFFFFFFFFFFFFFFFFFFFFF0000000100000000),
    (0xFFFFFFFE8000000000000001FFFFFFFFFFFFFFFE7FFFFFFFFFFFFFFE00000000,
     0xFFFFFFFE80000000FFFFFFFE000000007FFFFFFF00000001),
    (0x7FFFFFFF7FFFFFFF7FFFFFFF000000017FFFFFFFFFFFFFFEFFFFFFFE80000000,
     0xFFFFFFFEFFFFFFFEFFFFFFFEFFFFFFFE7FFFFFFFFFFFFFFE00000000),
    (0xFFFFFFFFFFFFFFFFFFFFFFFF7FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF00000000,
     0x10000000100000001000000018000000000000001FFFFFFFFFFFFFFFE),
)
TOP = (1 << 256) - 1


def _pairs_frame(rng, run, pairs):
    """A frame whose row i holds pairs[i] = (top, second) as its window."""
    frame = frontier_frame(rng, run, len(pairs), starved_share=0.0)
    for i, (top, second) in enumerate(pairs):
        for j, value in enumerate((second, top)):
            frame.stack[i, j] = list((value & TOP).to_bytes(32, "big"))
    return frame


def test_k7_division_cases(cuda_device):
    """DIV, MOD, SDIV and SMOD of one pair a row: division by zero, the
    one-word divisors' short path, a dividend below its divisor, equal
    operands, 2^256 - 1 over 1, -2^255 / -1, the add-back pairs, and
    random dividends over random 1-8-word divisors."""
    rng = random.Random(0xD17)
    # [b, a] -> a/b, a%b, a sdiv b, a smod b
    run = frontier_run(bytes([0x81, 0x81, 0x04, 0x82, 0x82, 0x06, 0x83,
                              0x83, 0x05, 0x84, 0x84, 0x07, 0x00]))
    pairs = [(a, 0) for a in (0, 1, TOP, 1 << 255, rng.getrandbits(256))]
    pairs += [(rng.getrandbits(256), rng.getrandbits(32) | 1)
              for _ in range(8)]
    pairs += [(TOP, 1), (TOP, 2), (TOP, 0xFFFFFFFF), (1 << 255, TOP),
              (TOP, TOP), (5, 1 << 200), (1 << 200, 1 << 200),
              (rng.getrandbits(128), rng.getrandbits(256) | 1 << 255)]
    pairs += [(a, b) for a, b in ADD_BACK]
    pairs += [(-a, b) for a, b in ADD_BACK] + [(a, -b) for a, b in ADD_BACK]
    pairs += [(rng.getrandbits(256), rng.getrandbits(32 * rng.randint(1, 8)))
              for _ in range(40)]
    frame = _pairs_frame(rng, run, pairs)
    assert _assert_matches_plain(run, frame, cuda_device) == len(pairs)
    _assert_packed_matches_plain(run, frame, cuda_device)


def test_k6_mul_and_shifts_at_the_edges(cuda_device):
    """SHL, SHR, SAR, BYTE, SIGNEXTEND and MUL by 0, 1, 31, 32, 255, 256
    and amounts above, over the edge words and random ones."""
    rng = random.Random(0x5A1)
    # [value, amount] -> shl, shr, sar, byte, signextend, mul
    run = frontier_run(bytes([0x81, 0x81, 0x1B, 0x82, 0x82, 0x1C, 0x83,
                              0x83, 0x1D, 0x84, 0x84, 0x1A, 0x85, 0x85,
                              0x0B, 0x86, 0x86, 0x02, 0x00]))
    amounts = (0, 1, 7, 30, 31, 32, 33, 63, 64, 255, 256, 257, 1 << 32,
               1 << 64, 1 << 255, TOP)
    values = list(EDGE_WORDS) + [rng.getrandbits(256) for _ in range(3)]
    pairs = [(amount, value) for amount in amounts for value in values]
    frame = _pairs_frame(rng, run, pairs)
    assert _assert_matches_plain(run, frame, cuda_device) == len(pairs)
    _assert_packed_matches_plain(run, frame, cuda_device)


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
