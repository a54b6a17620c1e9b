"""The per-query circuit-SLS round of the bucketed path: a CUDA kernel for
Hopper and its plain PyTorch version.

Replaces mythril_tpu/tpu/circuit.py `run_round_circuit` (:460, with
`_simulate` :398 and `_walk` :415), vmapped over a leading query axis by
`run_round_circuit_batch` (:507). That is an XLA program, not a Pallas
kernel. It computes what the XLA round computes, on the same operands (the
TENSOR_KEYS tables of each query's cone, zero-padded to one bucket shape
by PackedCircuit.padded_to, with a leading query axis), except for its
randomness: the port draws no threefry bits. The violated root a lane
walks from and the walk's coin come from K1's counter hash
(ragged_kernel._hash32), keyed by (seed, query slot, restart lane, step,
walk depth), with K1's tie rule (the lowest violated root of maximal key).
The kernel and its plain version therefore agree bit for bit.

Per step and restart lane (the reference's semantics, kept exactly):
x[:, 0] = 0; simulate level by level (a cell whose out_idx is 0 is
padding and writes 0 into var 0); check the roots, found is sticky; walk
back from the picked violated root with want = 1 ^ root_neg for at most
walk_depth gates; flip the walk's end to want unless the lane has found a
model (found lanes keep their value). A final simulate makes the returned
x gate-consistent. Query slots whose roots are all masked (the query
axis's padding) report found at step 0.

  run_round_circuit_kernel  the wrapper: checks its operands and, for CUDA
                  tensors, launches csrc/circuit_round.cu (built with nvcc
                  at first use into mythril_tpu_torch/_build/) on the
                  batch's circuit_layout. For CPU tensors, and only for
                  those, it runs
  run_round_circuit_plain   the same round written with torch tensor ops.
  circuit_layout  the kernel's side input, built on the device once per
                  batch: a record per variable and the real-gate stream
                  (see its note); it raises on a batch the kernel would
                  not compute exactly.
  launch_shape    the kernel's tier and lanes a word for a V1 and stream.
  launch_arguments  the kernel's arguments in its order, as the wrapper
                  passes them (the CPU tests read them back the way the
                  kernel does).
  slot_quads      a stream slot's encoding, which K2's layout
                  (xla_kernel.xla_layout) shares.

Operands: `tensors` holds every TENSOR_KEYS table with a leading query
axis, int32 and contiguous on x's device: out_idx, a_var, a_neg, b_var,
b_neg [Q, L, W]; ga_var, ga_neg, gb_var, gb_neg, is_gate [Q, V1];
root_var, root_neg, root_mask [Q, NR]. x is [Q, R, V1] int32 in {0, 1}.
A level's gates read only variables of lower levels (PackedCircuit
levelizes so).
"""

import ctypes
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from mythril_tpu_torch.gpu.circuit import TENSOR_KEYS
from mythril_tpu_torch.gpu.ragged_kernel import (
    _C_COIN,
    _C_CONE,
    _C_DEPTH,
    _C_LANE,
    _C_ROOT,
    _C_STEP,
    _hash32,
    _mul32,
    nvcc_library,
)
from mythril_tpu_torch.observe import transfers

LEVEL_KEYS = ("out_idx", "a_var", "a_neg", "b_var", "b_neg")
VAR_KEYS = ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate")
ROOT_KEYS = ("root_var", "root_neg", "root_mask")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "circuit_round.cu")

# The kernel's launch, mirrored in csrc/circuit_round.cu: a block of
# THREADS threads (its 16 warps pack x in and out, warp 0 runs the round)
# serves one query and one group of restart lanes, bit-sliced into a word
# per variable. A stream slot is a whole gate of two levels' step (32
# bytes); a stream that does not fit shared memory beside x and the
# records streams through RING chunks of CHUNK_BYTES.
THREADS = 512
SMEM_CAP = 224 * 1024
CHUNK_BYTES = 8192
RING = 4
STEP_GATES = 32        # a stream step: one gate a thread of the warp
ENTRY_BYTES = 32       # a slot: the gate and its first-level children
CHUNK_STEPS = CHUNK_BYTES // (STEP_GATES * ENTRY_BYTES)
NARROW_V1 = 1 << 15    # 16-bit literals: records in shared memory
SHARED32_V1 = 1 << 14  # x and the records at 32 lanes a word fit
TIERS = ("shared32", "shared16", "xshared", "global")
# the kernel's arguments, in order: the layout's tables, x in and out,
# found, the global tier's x words, the sizes, the seed (an unsigned int),
# the launch shape, then the cudaStream_t
ARG_ORDER = ("records", "stream_table", "stream_steps", "roots", "x_in",
             "x_out", "found", "x_work", "queries", "lanes", "v1", "v1p",
             "stride", "nr", "steps", "walk_depth", "seed", "tier",
             "lanes_per_word", "resident", "smem_bytes", "stream")

# kernel launches since the last reset (the plain version never counts)
launches = 0


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


class LaunchShape(NamedTuple):
    tier: str             # one of TIERS
    lanes_per_word: int   # restart lanes bit-sliced into one x word
    resident: bool        # the whole stream in shared memory (else a ring)
    smem_bytes: int       # dynamic shared memory of a block


def launch_shape(v1: int, stream_steps: int) -> LaunchShape:
    """The kernel's tier for a batch of V1 variables whose longest query
    stream has `stream_steps` steps (a multiple of CHUNK_STEPS):

      shared32  V1 <= 16,384: 32 lanes a word; x and the 16-bit records
                in shared memory (8 bytes a variable);
      shared16  V1 <= 32,768: 16 lanes a word (6 bytes a variable);
      xshared   wider: x alone in shared memory at the widest of 32, 16 or
                8 lanes a word that fits beside the ring (V1 up to 49,152,
                98,304 and 196,608), the records in global memory;
      global    wider still: x's words in global memory.

    The stream is resident when it fits beside them, else it streams
    through the ring (RING x CHUNK_BYTES). The result never depends on
    the tier: every lane is independent."""
    v1p = _align(max(v1, 1), 4)
    ring = RING * CHUNK_BYTES
    stream = stream_steps * STEP_GATES * ENTRY_BYTES
    if v1 <= NARROW_V1:
        tier, lanes = ("shared32", 32) if v1 <= SHARED32_V1 \
            else ("shared16", 16)
        fixed = 4 * v1p + _align(v1p * lanes // 8, 16)
    else:
        tier, lanes, fixed = "global", 32, 0
        for width in (32, 16, 8):
            x_bytes = _align(v1p * width // 8, 16)
            if x_bytes + ring <= SMEM_CAP:
                tier, lanes, fixed = "xshared", width, x_bytes
                break
    resident = fixed + stream <= SMEM_CAP
    return LaunchShape(tier, lanes, resident,
                       fixed + (stream if resident else ring))


def stack_padded(pcs, shape=None, slots=None) -> dict:
    """numpy [slots, ...] batch of PackedCircuits padded to one shape
    (default: the largest of each dimension), query slots past len(pcs)
    all zeros (no live root: found at step 0). `shape` is (num_levels,
    max_width, v1, num_roots) as PackedCircuit.padded_to takes it."""
    if shape is None:
        shape = (max(pc.num_levels for pc in pcs),
                 max(pc.max_width for pc in pcs),
                 max(pc.v1 for pc in pcs),
                 max(pc.num_roots for pc in pcs))
    slots = max(slots or len(pcs), len(pcs))
    padded = [pc.padded_to(*shape) for pc in pcs]
    out = {}
    for key in TENSOR_KEYS:
        rows = [entry[key] for entry in padded]
        rows += [np.zeros_like(rows[0])] * (slots - len(rows))
        out[key] = np.stack(rows)
    return out


def device_batch(arrays: dict, device) -> dict:
    """A numpy batch as contiguous int32 tensors on `device`."""
    return {key: torch.as_tensor(np.ascontiguousarray(arrays[key]),
                                 dtype=torch.int32).to(device)
            for key in TENSOR_KEYS}


def level_rows(tensors: dict) -> torch.Tensor:
    """[Q, L] int32: one past the last live cell (out_idx > 0) of each
    level, 0 for a level of padding alone. The plain version sweeps only
    these cells; the cells past them write nothing (padding), so the
    bound changes no result."""
    live = tensors["out_idx"] > 0
    width = live.shape[2]
    col = torch.arange(1, width + 1, device=live.device, dtype=torch.int32)
    return torch.where(live, col, 0).amax(dim=2).to(torch.int32) \
        .contiguous() if width else torch.zeros(
            live.shape[:2], dtype=torch.int32, device=live.device)


# -- the kernel's layout ------------------------------------------------------


class CircuitLayout(NamedTuple):
    """circuit_layout's tables, on the batch's device."""
    records: torch.Tensor       # narrow int32 [Q, V1p]; wide int32 [Q, V1, 2]
    stream: torch.Tensor        # int32 [Q, S, 2, 32, 4]
    stream_steps: torch.Tensor  # int32 [Q]: each query's steps
    roots: torch.Tensor         # int32 [Q, NR]
    v1: int
    stride: int                 # S: the longest stream, in whole chunks


def _signed(values: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 bit patterns in [0, 2^bits) as the signed values of a
    `bits`-wide integer, so they convert without overflow."""
    return values - ((values >> (bits - 1)) & 1) * (1 << bits)


def _require(checks, layout: str = "circuit_layout") -> None:
    """Raise ValueError on the first of (message, bool tensor) pairs whose
    tensor is not all true, naming `layout`; one device sync for all of
    them."""
    ok = transfers.to_list(
        torch.stack([cond.all() for _message, cond in checks]),
        "circuit.check")
    for good, (message, _cond) in zip(ok, checks):
        if not good:
            raise ValueError(f"{layout}: {message}")


def slot_quads(word_bytes, out, a, b, a_operands, b_operands, second):
    """Each cell's stream slot as the kernel reads it: the quads (out |
    flags, a0, a1, a) and (masks, b0, b1, b) as int64 bit patterns, the
    variables out, a0, a1, b0 and b1 as byte offsets of their word in x
    (`word_bytes` a word), the operands' negations as bytes 0xFF in masks,
    flag bit 31 on a second-level cell; a and b are the children's
    literals."""
    (a0, a1), (b0, b1) = a_operands, b_operands
    masks = sum(((lit & 1) * 0xFF) << (8 * k)
                for k, lit in enumerate((a0, a1, b0, b1)))
    return (torch.stack((word_bytes * out | second << 31,
                         word_bytes * (a0 >> 1), word_bytes * (a1 >> 1), a),
                        1),
            torch.stack((masks, word_bytes * (b0 >> 1),
                         word_bytes * (b1 >> 1), b), 1))


def circuit_layout(tensors: dict) -> CircuitLayout:
    """The kernel's tables of a batch, built on its device. Per query:

      records  a record per variable for the walk: its two child literals
               (var << 1 | neg), 16-bit each packed in an int32 when V1 <=
               NARROW_V1 (narrow: in shared memory; padded to V1p, a
               multiple of 4), int32 pairs past it (wide). A variable whose
               is_gate is not 1 points at itself (literal 2v), which the
               walk reads as "not a gate": is_gate is folded in.
      stream   the real-gate stream for the simulate, two levels a step:
               the query's levels that hold a live cell (out_idx > 0),
               paired in order, each pair's live cells (the first level's,
               then the second's) in steps of STEP_GATES slots, a pair
               taking ceil(cells / 32) steps. A slot is the whole gate in
               two int32 quads, (out | flags, a0, a1, a) and (masks, b0,
               b1, b): a and b are the children's literals, and the AND of
               the literals a0 and a1 is a's variable's value: on a
               second-level cell whose child lies on the pair's first
               level, that child's own two inputs (its record), so a step
               reads only what earlier steps wrote; else the child's
               variable twice. out, a0, a1, b0 and b1 are byte offsets of
               the variable's word in x (V1's tier sets the word: 4, 2 or
               1 bytes), and masks holds the negations of a0, a1, b0, b1
               as bytes 0xFF. flags: bit 30 on the pair's last step, bit
               31 on a second-level cell. The spare slots are zero (var 0
               := var 0 & var 0); queries are padded with empty steps to
               `stride`, a whole number of CHUNK_STEPS.
      roots    var << 2 | neg << 1 | live, 0 for a masked root.

    The simulate reads the cells and the walk the records, so the layout
    holds the batch to agreeing on both, and raises ValueError where it
    fails: every variable index in [0, V1) and every negation 0 or 1; a
    live cell's out variable is a gate whose record equals the cell; each
    out variable has one live cell; a cell reads only variables of lower
    levels (a step reads only what earlier steps wrote); a gate's first
    child is not itself."""
    out_idx = tensors["out_idx"]
    device = out_idx.device
    q_count, levels, _width = out_idx.shape
    v1 = tensors["is_gate"].shape[1]
    if v1 > 1 << 27:
        raise ValueError(f"circuit_layout: V1 {v1} is past 2^27 (the "
                         f"stream's byte offsets)")
    wide = v1 > NARROW_V1
    qi, li, wi = (out_idx > 0).nonzero(as_tuple=True)
    qi, li = qi.long(), li.long()
    cell = {key: tensors[key][qi, li, wi].long() for key in LEVEL_KEYS}
    o, a, b = cell["out_idx"], cell["a_var"], cell["b_var"]
    an, bn = cell["a_neg"], cell["b_neg"]
    is_gate = tensors["is_gate"] == 1
    ga, gb = tensors["ga_var"].long(), tensors["gb_var"].long()
    gan, gbn = tensors["ga_neg"].long(), tensors["gb_neg"].long()
    root_live = tensors["root_mask"] == 1
    root_var = tensors["root_var"].long()
    root_neg = tensors["root_neg"].long()

    def in_range(t):
        return (t >= 0) & (t < v1)

    def is_bit(t):
        return (t == 0) | (t == 1)

    # the ranges first: the gathers below index with these values
    _require([
        ("a live cell's variables lie in [0, V1)",
         in_range(o) & in_range(a) & in_range(b)),
        ("a live cell's negations are 0 or 1", is_bit(an) & is_bit(bn)),
        ("a gate's children lie in [0, V1), its negations are 0 or 1",
         ~is_gate | (in_range(ga) & in_range(gb) & is_bit(gan)
                     & is_bit(gbn))),
        ("a live root's variable lies in [0, V1), its negation is 0 or 1",
         ~root_live | (in_range(root_var) & is_bit(root_neg))),
    ])
    flat = qi * v1 + o

    def of_out(table):
        return table.reshape(-1)[flat]

    level_of = torch.full((q_count * v1,), -1, dtype=torch.long,
                          device=device)
    level_of[flat] = li
    var_ids = torch.arange(v1, device=device)
    _require([
        ("a live cell's out variable is a gate (is_gate 1)", of_out(is_gate)),
        ("a live cell's children equal its out variable's gate record",
         (of_out(ga) == a) & (of_out(gan) == an) & (of_out(gb) == b)
         & (of_out(gbn) == bn)),
        ("an out variable has one live cell",
         torch.bincount(flat, minlength=q_count * v1) <= 1),
        ("a cell reads only variables of lower levels",
         (level_of[qi * v1 + a] < li) & (level_of[qi * v1 + b] < li)),
        ("a gate's first child is not itself", ~is_gate | (ga != var_ids)),
    ])

    # the records: a gate's two literals, a non-gate pointing at itself
    self_lit = 2 * var_ids
    lit_a = torch.where(is_gate, 2 * ga + gan, self_lit)
    lit_b = torch.where(is_gate, 2 * gb + gbn, self_lit)

    # the stream: the query's levels with a live cell paired in order,
    # (0, 1), (2, 3), ...; a cell's rank within its pair -> (step, slot)
    has = torch.zeros((q_count, levels), dtype=torch.bool, device=device)
    has[qi, li] = True
    real = torch.cumsum(has.long(), 1) - 1  # rank among the live levels
    own = real[qi, li]
    pair, second = own // 2, own % 2
    group = qi * levels + pair  # nonzero's order: by query, level, cell
    counts = torch.bincount(group, minlength=q_count * levels)
    rank = torch.arange(len(group), device=device) \
        - (torch.cumsum(counts, 0) - counts)[group]
    per_pair = ((counts + STEP_GATES - 1) // STEP_GATES).reshape(
        q_count, levels)
    ends = torch.cumsum(per_pair, 1)
    stream_steps = ends[:, -1]
    step = (ends - per_pair).reshape(-1)[group] + rank // STEP_GATES
    slot = rank % STEP_GATES

    def operand(child):
        """The two literals whose AND is the child's variable's value: its
        gate's own inputs where the child lies on the first level of this
        second-level cell's pair, else the child's variable twice."""
        at = level_of[qi * v1 + child]
        first = (second == 1) & (at >= 0) \
            & (real[qi, at.clamp(min=0)] == own - 1)
        return (torch.where(first, lit_a[qi, child], 2 * child),
                torch.where(first, lit_b[qi, child], 2 * child))

    most_steps = transfers.to_int(stream_steps.max(), "circuit.stride")
    stride = max(_align(most_steps, CHUNK_STEPS), CHUNK_STEPS)
    stream = torch.zeros((q_count, stride, 2, STEP_GATES, 4),
                         dtype=torch.long, device=device)
    stream[qi, step, 0, slot], stream[qi, step, 1, slot] = slot_quads(
        launch_shape(v1, 0).lanes_per_word // 8, o, 2 * a + an, 2 * b + bn,
        operand(a), operand(b), second)
    has = per_pair > 0
    stream[torch.arange(q_count, device=device)[:, None]
           .expand(q_count, levels)[has], (ends - 1)[has], 0, :, 0] |= 1 << 30
    stream = _signed(stream, 32).to(torch.int32)

    if wide:
        records = torch.stack((lit_a, lit_b), 2).to(torch.int32)
    else:
        v1p = _align(v1, 4)
        pad = 2 * torch.arange(v1, v1p, device=device)
        lit_a = torch.cat((lit_a, pad.expand(q_count, -1)), 1)
        lit_b = torch.cat((lit_b, pad.expand(q_count, -1)), 1)
        records = _signed(lit_a | (lit_b << 16), 32).to(torch.int32)
    roots = torch.where(root_live, (root_var << 2) | (root_neg << 1) | 1,
                        torch.zeros_like(root_var)).to(torch.int32)
    return CircuitLayout(records.contiguous(), stream.contiguous(),
                         stream_steps.to(torch.int32).contiguous(),
                         roots.contiguous(), v1, stride)


# -- the plain PyTorch version ----------------------------------------------


def run_round_circuit_plain(tensors: dict, x: torch.Tensor, seed: int,
                            steps: int, walk_depth: int, walks=None):
    """The round written with torch tensor ops on x's device, over the
    query axis: `steps` iterations of simulate, root check and pick,
    justification walk and one flip per (query, lane); then a final
    simulate and check. Returns (x [Q, R, V1] int32, found [Q, R] bool).

    `walks`, when a list, gets one (gates descended [Q, R] int64, walked
    [Q, R] bool) pair a step: the length of each lane's walk, and whether
    the lane walked (it had not found a model). Nothing else changes."""
    q_count, lanes, v1 = x.shape
    device = x.device
    rows = (transfers.to_list(level_rows(tensors).amax(dim=0),
                              "circuit.rows") if q_count else [])
    # (a, an, b, bn, out, live) of each level's cells up to its last live
    # one, the indices expanded over the lanes once for every step
    levels = []
    for level, width in enumerate(rows):
        if width:  # a level of padding alone writes 0 into var 0: no-op
            cells = {key: tensors[key][:, level, :width]
                     for key in LEVEL_KEYS}
            shape = (q_count, lanes, width)
            levels.append((
                cells["a_var"].long()[:, None, :].expand(shape),
                cells["a_neg"][:, None, :],
                cells["b_var"].long()[:, None, :].expand(shape),
                cells["b_neg"][:, None, :],
                cells["out_idx"].long()[:, None, :].expand(shape),
                (cells["out_idx"] > 0).to(torch.int32)[:, None, :]))
    ga_var, gb_var = tensors["ga_var"].long(), tensors["gb_var"].long()
    ga_neg, gb_neg = tensors["ga_neg"], tensors["gb_neg"]
    is_gate = tensors["is_gate"]
    root_var = tensors["root_var"].long()
    root_neg = tensors["root_neg"]
    root_mask = tensors["root_mask"]
    roots = root_var.shape[1]
    lane_q_salt = (
        _mul32(torch.arange(q_count, device=device, dtype=torch.int64),
               _C_CONE)[:, None]
        ^ _mul32(torch.arange(lanes, device=device, dtype=torch.int64),
                 _C_LANE)[None, :])                             # [Q, R]
    root_salt = _mul32(torch.arange(roots, device=device,
                                    dtype=torch.int64), _C_ROOT)  # [NR]
    seed32 = int(seed) & 0x7FFFFFFF

    def simulate(x):
        x[:, :, 0] = 0
        for a, an, b, bn, out, live in levels:
            value = (x.gather(2, a) ^ an) & (x.gather(2, b) ^ bn)
            x.scatter_(2, out, value * live)

    def violated(x):
        vals = x.gather(2, root_var[:, None, :].expand(-1, lanes, -1))
        return ((vals ^ root_neg[:, None, :]) == 0) \
            & (root_mask[:, None, :] == 1)

    def at(table, index):
        """table [Q, V1] at index [Q, R] -> [Q, R]."""
        return table.gather(1, index)

    x = x.clone()
    found = torch.zeros((q_count, lanes), dtype=torch.bool, device=device)
    for step in range(steps):
        simulate(x)
        viol = violated(x)
        found |= ~viol.any(dim=2)
        step_key = _hash32(seed32 ^ _mul32(step, _C_STEP))
        keys = _hash32(step_key ^ lane_q_salt[:, :, None] ^ root_salt)
        keyed = torch.where(viol, keys >> 1, torch.full_like(keys, -1))
        choice = keyed.argmax(dim=2, keepdim=True)  # first max: lowest root
        cur = root_var[:, None, :].expand(-1, lanes, -1).gather(
            2, choice)[..., 0]
        want = 1 ^ root_neg[:, None, :].expand(-1, lanes, -1).gather(
            2, choice)[..., 0]
        # a lane that has found a model flips nothing: its walk is moot
        done = found.clone()
        length = torch.zeros_like(cur)
        coin_base = (step_key ^ _C_COIN) ^ lane_q_salt
        for depth in range(walk_depth):
            is_g = (at(is_gate, cur) == 1) & ~done
            av_i, bv_i = at(ga_var, cur), at(gb_var, cur)
            an, bn = at(ga_neg, cur), at(gb_neg, cur)
            av = x.gather(2, av_i[..., None])[..., 0] ^ an
            bv = x.gather(2, bv_i[..., None])[..., 0] ^ bn
            justified = (av & bv) == want
            coin = (_hash32(coin_base ^ _mul32(depth, _C_DEPTH)) & 1) == 1
            choose_b1 = ((av == 1) & (bv == 0)) | ((av == 0) & (bv == 0)
                                                   & coin)
            choose_b0 = ((av == 0) & (bv == 1)) | ((av == 1) & (bv == 1)
                                                   & coin)
            choose_b = torch.where(want == 1, choose_b1, choose_b0)
            active = is_g & ~justified
            length += active
            cur = torch.where(active, torch.where(choose_b, bv_i, av_i), cur)
            want = torch.where(active,
                               want ^ torch.where(choose_b, bn, an), want)
            done = done | ~is_g | justified
            # every walk has ended: later depths change nothing
            if depth % 8 == 7 and bool(done.all()):
                break
        if walks is not None:
            walks.append((length, ~found))
        new_val = torch.where(found, x.gather(2, cur[..., None])[..., 0],
                              want)
        x.scatter_(2, cur[..., None], new_val[..., None])
    simulate(x)
    found |= ~violated(x).any(dim=2)
    return x, found


# -- the CUDA kernel ----------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_kernel() -> dict:
    """Compile csrc/circuit_round.cu with nvcc into _build/ (skipped when
    the library is newer than its source) and load it. Returns
    {"seconds": build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        so_path, ptxas = nvcc_library(KERNEL_SOURCE, "circuit_round")
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            ptr = ctypes.c_void_p
            lib.circuit_round_launch.restype = ctypes.c_int
            lib.circuit_round_launch.argtypes = (
                [ptr] * 8 + [ctypes.c_int] * 8 + [ctypes.c_uint]
                + [ctypes.c_int] * 4 + [ptr])
            lib.circuit_round_error_string.restype = ctypes.c_char_p
            lib.circuit_round_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_operands(tensors: dict, x: torch.Tensor, layout):
    if x.dtype != torch.int32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int32 [Q, R, V1] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    q_count, lanes, v1 = x.shape
    if not q_count or not lanes or not v1:
        raise ValueError(f"x of shape {tuple(x.shape)} is empty")
    levels, width = tensors["out_idx"].shape[1:]
    roots = tensors["root_var"].shape[1]
    shapes = {key: (q_count, levels, width) for key in LEVEL_KEYS}
    shapes.update({key: (q_count, v1) for key in VAR_KEYS})
    shapes.update({key: (q_count, roots) for key in ROOT_KEYS})
    for key in TENSOR_KEYS:
        array = tensors.get(key)
        if not isinstance(array, torch.Tensor) or array.device != x.device \
                or array.dtype != torch.int32 or not array.is_contiguous() \
                or tuple(array.shape) != shapes[key]:
            raise ValueError(
                f"{key} must be a contiguous int32 {shapes[key]} tensor on "
                f"{x.device} (device_batch)")
    if not levels or not width or not roots:
        raise ValueError(f"empty tables: levels {levels}, width {width}, "
                         f"roots {roots}")
    for count, name in ((x.numel(), "x"),
                        (tensors["out_idx"].numel(), "out_idx")):
        if count >= 1 << 31:
            raise ValueError(f"{name} of {count} cells is too large")
    if layout is not None and (
            not isinstance(layout, CircuitLayout) or layout.v1 != v1
            or layout.records.device != x.device
            or tuple(layout.roots.shape) != (q_count, roots)):
        raise ValueError(f"layout must be the circuit_layout of these "
                         f"tables ({q_count} queries, V1 {v1}, {roots} "
                         f"roots) on {x.device}")


def launch_arguments(layout: CircuitLayout, x: torch.Tensor,
                     x_out: torch.Tensor, found: torch.Tensor, x_work,
                     seed: int, steps: int, walk_depth: int,
                     stream=None) -> dict:
    """The kernel's arguments by name, in ARG_ORDER: data pointers (x_work
    None: not the global tier), the sizes the kernel indexes with (a
    query's records are v1p words or v1 pairs, its stream `stride` steps,
    its roots `nr`), the seed, the launch shape (launch_shape of V1 and
    the stride) and the CUDA stream (None: the default stream)."""
    q_count, lanes, v1 = x.shape
    shape = launch_shape(v1, layout.stride)
    return {"records": layout.records.data_ptr(),
            "stream_table": layout.stream.data_ptr(),
            "stream_steps": layout.stream_steps.data_ptr(),
            "roots": layout.roots.data_ptr(), "x_in": x.data_ptr(),
            "x_out": x_out.data_ptr(), "found": found.data_ptr(),
            "x_work": None if x_work is None else x_work.data_ptr(),
            "queries": q_count, "lanes": lanes, "v1": v1,
            "v1p": _align(v1, 4), "stride": layout.stride,
            "nr": layout.roots.shape[1], "steps": max(int(steps), 0),
            "walk_depth": max(int(walk_depth), 0),
            "seed": int(seed) & 0x7FFFFFFF,
            "tier": TIERS.index(shape.tier),
            "lanes_per_word": shape.lanes_per_word,
            "resident": int(shape.resident),
            "smem_bytes": shape.smem_bytes, "stream": stream}


def run_round_circuit_kernel(tensors: dict, x: torch.Tensor, seed: int,
                             steps: int, walk_depth: int, layout=None):
    """Advance the restart lanes of a batch of padded cones by `steps`
    sim+flip iterations. Returns (x [Q, R, V1] int32, found [Q, R] bool).
    `layout` is circuit_layout(tensors), built here when None (the backend
    passes it once per batch).

    CPU tensors run run_round_circuit_plain; CUDA tensors launch the CUDA
    kernel on the current stream, and a kernel that fails to build or to
    launch raises."""
    global launches
    _check_operands(tensors, x, layout)
    if x.device.type == "cpu":
        return run_round_circuit_plain(tensors, x, seed, steps, walk_depth)
    if x.device.type != "cuda":
        raise ValueError(f"no circuit round for device {x.device}")
    if _lib is None:
        build_kernel()
    if layout is None:
        layout = circuit_layout(tensors)
    q_count, lanes, v1 = x.shape
    shape = launch_shape(v1, layout.stride)
    v1p = _align(v1, 4)
    x_out = torch.empty_like(x)
    found = torch.empty((q_count, lanes), dtype=torch.bool, device=x.device)
    x_work = None
    if shape.tier == "global":
        x_work = torch.empty(
            (q_count, -(-lanes // shape.lanes_per_word), v1p),
            dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.circuit_round_launch(*launch_arguments(
            layout, x, x_out, found, x_work, seed, steps, walk_depth,
            stream).values())
    if status != 0:
        raise RuntimeError("circuit_round launch failed: "
                           + _lib.circuit_round_error_string(status).decode())
    launches += 1
    return x_out, found


def reset_launches() -> None:
    global launches
    launches = 0
