"""K2, the XLA-semantics ragged round (csrc/xla_round.cu), held against its
plain PyTorch version on a card, bit for bit (x and found are integers and
bools: zero tolerance).

Marked `cuda`: these skip without a card. They import only the port (not
even the shared test helpers), so they run where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda_xla.py -m cuda
"""

import copy
import random

import numpy as np
import pytest
import torch

from mythril_tpu_torch.gpu import circuit, xla_kernel
from mythril_tpu_torch.gpu.backend import shape_bucket
from mythril_tpu_torch.smt.bitblast import AIG
from mythril_tpu_torch.support.workloads import big_cone, random_cones

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: xdist workers must all
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see README, PyTorch/CUDA port)")
    return torch.device("cuda", 0)


def _random_entries(seed, count):
    """Every third cone carries a pinned input, as cubes do."""
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


# a page of each tier at 32 lanes a word: shared32, shared16, xshared at
# 32, 16 and 8 lanes, global
TIER_PAGES = (60, 16384, 32768, 49152, 98304, 196608, 196609)


def _tiered_stream(seed, extra=()):
    cones = random_cones(random.Random(seed), len(TIER_PAGES))
    entries = [(_widened(pc, max(v1, pc.v1)), ())
               for pc, v1 in zip(cones, TIER_PAGES)]
    return circuit.RaggedStream(entries + list(extra), bucket=shape_bucket)


def _assert_kernel_matches_plain(device, stream, seed, lanes, steps,
                                 walk_depth=None, widest=32):
    xs = xla_kernel.device_stream(stream, device, widest)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = circuit.init_inputs(gen, lanes, stream.v1, device)
    x[:, 0] = 1  # var 0 is reset to the constant FALSE by both
    if walk_depth is None:
        walk_depth = stream.num_levels + 4
    before = xla_kernel.launches
    got_x, got_found = xla_kernel.run_round_xla_kernel(xs, x, seed, steps,
                                                       walk_depth)
    assert xla_kernel.launches == before + 1
    want_x, want_found = xla_kernel.run_round_xla_plain(xs, x, seed, steps,
                                                        walk_depth)
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_found, want_found)
    assert not bool(got_x[:, 0].any())
    return got_found


@pytest.mark.parametrize("seed, cones, lanes, steps, extra", [
    (1, 5, 8, 24, None), (2, 40, 3, 64, None), (3, 9, 1, 0, None),
    (4, 7, 64, 40, "gate_free"), (5, 12, 100, 16, "var0_root"),
    (6, 20, 33, 1, None)])
def test_cuda_xla_kernel_bit_identical_to_plain_round(cuda_device, seed,
                                                      cones, lanes, steps,
                                                      extra):
    entries = _random_entries(seed, cones)
    if extra == "gate_free":
        entries.append((_gate_free_cone(), ()))
    elif extra == "var0_root":
        # local var 0 (the constant FALSE) wanted TRUE: never satisfied
        entries[0] = (entries[0][0], ((0, True),))
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    found = _assert_kernel_matches_plain(cuda_device, stream, seed, lanes,
                                         steps)
    # the padding cone slots: no live root, found at step 0
    assert bool(found[:, stream.num_cones:].all())
    if extra == "var0_root":
        assert not bool(found[:, 0].any())


def test_cuda_xla_kernel_takes_a_stream_past_every_k1_capacity(cuda_device):
    """More than 65,536 combined variables, more than 128 cones and more
    than 256 roots in one cone: K1 could take none of it."""
    rng = random.Random(7)
    entries = [(big_cone(rng, roots=300), ())]
    entries += [(big_cone(rng), ()) for _ in range(2)]
    entries += _random_entries(8, 140)
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    assert sum(pc.v1 - 1 for pc, _e in entries) + 1 > 1 << 16
    assert stream.num_cones > 128 and entries[0][0].num_roots > 256
    _assert_kernel_matches_plain(cuda_device, stream, 7, 16, 8)


def test_cuda_xla_kernel_walk_depth_and_seed(cuda_device):
    """A walk cut short (walk_depth 1 and 0) and seeds past 2^31 agree
    too (the seed is masked to 31 bits on both sides)."""
    stream = circuit.RaggedStream(_random_entries(9, 10), bucket=shape_bucket)
    for walk_depth, seed in ((1, 11), (0, 12), (3, (1 << 33) + 5)):
        _assert_kernel_matches_plain(cuda_device, stream, seed, 8, 12,
                                     walk_depth)


@pytest.mark.parametrize("lanes", [1, 31, 33, 96])
def test_cuda_xla_kernel_on_a_stream_of_every_tier(cuda_device, lanes):
    """Cones of every tier in one launch, with a deep big_cone, a gate-free
    cone and padding cone slots."""
    stream = _tiered_stream(lanes, [(big_cone(random.Random(lanes)), ()),
                                    (_gate_free_cone(), ())])
    xs = xla_kernel.device_stream(stream, cuda_device)
    tiers = set(xs.layout.header[:, 3].tolist())
    assert tiers == {0, 1, 2, 3} and stream.cone_slots > stream.num_cones
    found = _assert_kernel_matches_plain(cuda_device, stream, lanes, lanes,
                                         6)
    assert bool(found[:, stream.num_cones:].all())


@pytest.mark.parametrize("widest, lanes", [(16, 33), (8, 96), (8, 1)])
def test_cuda_xla_kernel_at_narrower_words(cuda_device, widest, lanes):
    """Every cone at `widest` lanes a word (x alone in shared memory, the
    records in global memory): the result does not depend on the word."""
    entries = _random_entries(20 + lanes, 9) + [(_gate_free_cone(), ())]
    stream = circuit.RaggedStream(entries, bucket=shape_bucket)
    _assert_kernel_matches_plain(cuda_device, stream, lanes, lanes, 24,
                                 widest=widest)

