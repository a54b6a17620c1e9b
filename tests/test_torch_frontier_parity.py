"""The port's frontier step against the JAX package's, exactly (these are
integers: no tolerance).

- words: every binary op of kernel._BIN_FNS plus not, iszero, byte, shl,
  shr, sar, signextend, mem_offset and small_to_word, on 600 seeded word
  pairs (512 random, a share of them small, plus every pair of the edge
  words 0, 1, 2, 2^255 - 1, 2^255, 2^256 - 1): the port's torch and numpy
  results equal the reference's numpy and jax.numpy results; the port's
  torch bit-serial divmod equals the reference's `_divmod_bitserial` and
  `_divmod_host`.
- step_batch: 12 seeded random programs, each over a padded batch of 3-6
  sibling rows (one of them starved of gas), through the reference's
  step_batch(backend="jax") and the port's "torch" and "numpy" steps: all
  nine outputs equal, array by array, on every row. The port's Run
  (ops with kind, arg and gas, and the stack shape) equals the
  reference's.
"""

import functools
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mythril_tpu import preanalysis as ref_preanalysis
from mythril_tpu.disasm import Disassembly as RefDisassembly
from mythril_tpu.laser.frontier import dense as ref_dense
from mythril_tpu.laser.frontier import fastset as ref_fastset
from mythril_tpu.laser.frontier import kernel as ref_kernel
from mythril_tpu.laser.frontier import words as ref_words
from mythril_tpu_torch import preanalysis
from mythril_tpu_torch.disasm import Disassembly
from mythril_tpu_torch.laser.frontier import fastset, kernel, words
from mythril_tpu_torch.support.workloads import EDGE_WORDS, frontier_program

from tests.test_frontier import make_state as ref_make_state
from tests.torch_helpers import port_frame

CPU = torch.device("cpu")
TORCH = words.torch_namespace(CPU)


def _limbs(values):
    return np.array([words.word_from_int(v) for v in values], dtype=np.int32)


def _word_pairs():
    rng = random.Random(0x5EED)
    a, b = [], []
    for x in EDGE_WORDS:
        for y in EDGE_WORDS:
            a.append(x)
            b.append(y)
    for _ in range(512):
        small = rng.random() < 0.3
        a.append(rng.getrandbits(rng.choice((4, 9, 16)) if small else 256))
        b.append(rng.getrandbits(rng.choice((4, 9, 16))) if small
                 else rng.getrandbits(256))
    return _limbs(a), _limbs(b)


A, B = _word_pairs()

UNARY = {
    "not": lambda w, xp, a: w.bit_not(xp, a),
    "iszero": lambda w, xp, a: w.mask_to_word(xp, w.is_zero_mask(xp, a)),
    "mem_offset_32": lambda w, xp, a: w.mem_offset(xp, a, 32, 2048),
    "mem_offset_1": lambda w, xp, a: w.mem_offset(xp, a, 1, 2048),
}
BINARY_WORDS = {name: (lambda name: lambda w, xp, a, b: getattr(w, name)(
    xp, a, b))(name) for name in ("byte_op", "shl", "shr", "sar",
                                  "signextend")}


def _as_numpy(result):
    if isinstance(result, tuple):
        return tuple(_as_numpy(part) for part in result)
    if isinstance(result, torch.Tensor):
        return result.numpy()
    return np.asarray(result)


def _assert_all_equal(results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            for x, y in zip(first, other):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(first, other)


def _four_ways(fn, *arrays):
    """fn over the reference's numpy and jax.numpy and the port's numpy
    and torch namespaces."""
    return [
        _as_numpy(fn(ref_words, np, *arrays)),
        _as_numpy(fn(ref_words, jnp, *(jnp.asarray(a) for a in arrays))),
        _as_numpy(fn(words, np, *arrays)),
        _as_numpy(fn(words, TORCH, *(torch.from_numpy(a) for a in arrays))),
    ]


@pytest.mark.parametrize("name", sorted(kernel._BIN_FNS))
def test_binary_ops_equal_the_reference(name):
    results = _four_ways(
        lambda w, xp, a, b: (ref_kernel if w is ref_words else kernel)
        ._BIN_FNS[name](xp, a, b), A, B)
    _assert_all_equal(results)


@pytest.mark.parametrize("name", sorted(BINARY_WORDS))
def test_byte_and_shift_ops_equal_the_reference(name):
    # the first operand is the index / shift / position: mostly small
    rng = np.random.default_rng(3)
    small = _limbs(rng.integers(0, 300, size=len(A)).tolist())
    index = np.where((np.arange(len(A)) % 3 == 0)[:, None], A, small)
    _assert_all_equal(_four_ways(BINARY_WORDS[name], index, B))


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_equal_the_reference(name):
    _assert_all_equal(_four_ways(UNARY[name], A))


def test_small_to_word_equals_the_reference():
    values = np.array([0, 1, 31, 32, 255, 256, 2047, 65536, (1 << 30) - 1,
                       (1 << 31) - 1], dtype=np.int32)
    _assert_all_equal(_four_ways(
        lambda w, xp, v: w.small_to_word(xp, v), values))


def test_bitserial_divmod_equals_the_reference():
    want_host = ref_words._divmod_host(np, A, B)
    want_serial = _as_numpy(ref_words._divmod_bitserial(
        jnp, jnp.asarray(A), jnp.asarray(B)))
    got = _as_numpy(words._divmod_bitserial(
        TORCH, torch.from_numpy(A), torch.from_numpy(B)))
    nonzero = ~np.all(B == 0, axis=-1)
    for want in (want_host, want_serial):
        for x, y in zip(got, want):
            # division by zero is divmod_unsigned's (0, 0), not the loop's
            np.testing.assert_array_equal(x[nonzero], y[nonzero])
    _assert_all_equal([_as_numpy(words.divmod_unsigned(
        TORCH, torch.from_numpy(A), torch.from_numpy(B))),
        ref_words.divmod_unsigned(np, A, B)])


# -- step_batch --------------------------------------------------------------


def _runs(code):
    ref_run = ref_fastset.extract_run(
        ref_preanalysis.get_code_summary(RefDisassembly(code)), 0,
        lambda name: False, lambda name: False)
    run = fastset.extract_run(
        preanalysis.get_code_summary(Disassembly(code)), 0,
        lambda name: False, lambda name: False)
    return ref_run, run


@functools.lru_cache(maxsize=None)
def _program_cases(count=12):
    rng = random.Random(0xCAFE)
    cases = []
    while len(cases) < count:
        code, init_stack = frontier_program(rng, edge_bias=0.3)
        ref_run, run = _runs(code)
        if ref_run is None:
            assert run is None
            continue
        states = [ref_make_state(code, init_stack, bytes(
            rng.randrange(256) for _ in range(rng.choice((0, 17, 64)))))]
        for _ in range(rng.randrange(2, 6)):
            states.append(ref_make_state(code, [
                rng.choice(EDGE_WORDS) if rng.random() < 0.3
                else rng.getrandbits(256) for _ in init_stack]))
        if not all(ref_dense.state_encodable(s, ref_run) for s in states):
            continue
        frame = ref_dense.encode_frontier(
            states, ref_run, pad_to=ref_kernel.pad_slots(len(states) + 1))
        frame.gas_limit[1] = frame.min_gas[1] + 2  # bails within the run
        cases.append((code, ref_run, run, frame))
    return cases


@pytest.mark.parametrize("case", range(12))
def test_step_batch_equals_the_reference_jax_step(case):
    code, ref_run, run, ref_frame = _program_cases()[case]
    assert [(op.kind, op.arg, op.gas_min, op.gas_max, op.name)
            for op in run.ops] == [
        (op.kind, op.arg, op.gas_min, op.gas_max, op.name)
        for op in ref_run.ops]
    for field in ("start_pc", "end_pc", "touch", "out_len", "capacity",
                  "max_height", "window", "consumed_windows",
                  "out_sources"):
        assert getattr(run, field) == getattr(ref_run, field), field
    want = ref_kernel.step_batch(ref_run, port_frame(ref_frame),
                                 backend="jax")
    got_numpy = kernel.step_batch(run, port_frame(ref_frame),
                                  backend="numpy")
    got_torch = kernel.step_batch(run, port_frame(ref_frame),
                                  backend="torch", device=CPU)
    for got in (got_numpy, got_torch):
        for index in range(7):
            np.testing.assert_array_equal(
                np.asarray(got[index]), np.asarray(want[index]),
                err_msg=f"output {index} of {code.hex()}")
        for name, got_list, want_list in (("mem_log", got[7], want[7]),
                                          ("fork_out", got[8], want[8])):
            assert len(got_list) == len(want_list), name
            for got_item, want_item in zip(got_list, want_list):
                for x, y in zip(got_item if name == "mem_log"
                                else (got_item,),
                                want_item if name == "mem_log"
                                else (want_item,)):
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y),
                                                  err_msg=name)
    # the starved row really bailed, and a live row really completed
    assert not want[6][1] and want[6][0]
