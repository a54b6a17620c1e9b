"""The ragged circuit-SLS round: a CUDA kernel for Hopper and its plain
PyTorch version.

Replaces mythril_tpu/tpu/pallas_kernel.py `_round_fn` (the one Pallas
kernel of the JAX package) and computes what it computes, bit for bit:
the same counter hash, the same RNG keys (global restart lane, global cone
slot, root index, walk depth), the same tie rule (the lowest violated root
of maximal key) and the same merge rule for the returned x (columns owned
by a cone get the evolved values, every other column the input's).

Host side (numpy, as in the JAX package):
  flatten_stream  strips the RaggedStream level tensors' padding, orders
                  the real gates level-major into one stream with a
                  level_start offset table and pads every table to the
                  fixed capacities (KernelCaps), plus the var -> cone
                  ownership map the merge rule needs; and
  cone_layout     the kernel's per-cone view of the same stream: each
                  cone's gates in level order with cone-local 16-bit
                  indices, cut into the warp's steps (two levels each), a
                  record per local variable and its roots, one
                  16-byte-aligned section per cone that a block copies
                  into shared memory (or, for a cone too large for that, a
                  table of the cone's passes over the flat stream).

Device side:
  run_round_ragged_kernel  the wrapper: checks its operands and, for CUDA
                  tensors, launches csrc/ragged_round.cu (built with nvcc
                  at first use into mythril_tpu_torch/_build/). For CPU
                  tensors — and only for those — it runs
  run_round_ragged_plain   the same round written with torch tensor ops.

The kernel knob: kernel_mode() resolves MYTHRIL_GPU_KERNEL (pallas | xla |
auto) once per process. "pallas" runs this round (K1) with K2 as the
fallback for a stream past a capacity; "xla" runs every stream on K2
(gpu/xla_kernel.py), which has no capacities. "auto" is "pallas" on every
device: the card stands where the TPU stood.

Env summary (same defaults as MYTHRIL_TPU_PALLAS_*):
  MYTHRIL_GPU_RAGGED_VAR_CAP    combined-variable (and gate-stream)
                                capacity (default 65536)
  MYTHRIL_GPU_RAGGED_CONE_CAP   cone-slot capacity (default 128)
  MYTHRIL_GPU_RAGGED_ROOT_CAP   per-cone root-table capacity (default 256)
  MYTHRIL_GPU_RAGGED_LANE_TILE  restart lanes are padded to a multiple of
                                this (default 8)
KernelCaps' cone_tile and block are constants here (CONE_TILE, BLOCK),
kept for layout parity with the Pallas caps: nothing in the CUDA kernel
or the plain version depends on them.
"""

import ctypes
import glob
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.observe import transfers
from mythril_tpu_torch.support.env import env_int, env_str

log = logging.getLogger(__name__)

LEVEL_CAP = 4096  # mirror of circuit.MAX_LEVELS
KERNEL_MODES = ("pallas", "xla")

# operand order shared by flatten_stream and the kernel call
GATE_KEYS = ("g_out", "g_a", "g_an", "g_b", "g_bn")
VAR_KEYS = ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate")
ROOT_KEYS = ("root_var", "root_neg", "root_mask")
ARRAY_ORDER = GATE_KEYS + ("level_start",) + VAR_KEYS + ("var_cone",) \
    + ROOT_KEYS
# the flat tables the kernel's global-table path reads, in its argument order
GLOBAL_PATH_KEYS = GATE_KEYS + VAR_KEYS + ROOT_KEYS

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "ragged_round.cu")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the last reset (the plain version never counts)
launches = 0
_MODE = None


def kernel_mode() -> str:
    """The resolved MYTHRIL_GPU_KERNEL: "pallas" (K1, falling back to K2
    past a capacity) or "xla" (K2 for every stream). "auto", the default,
    is "pallas" on every device (mythril_tpu resolves it to its XLA round
    off a TPU); an unknown value warns and means auto. Cached per process;
    reset_kernel_mode() drops the cache."""
    global _MODE
    if _MODE is None:
        raw = (env_str("MYTHRIL_GPU_KERNEL", None) or "auto").strip().lower()
        if raw in KERNEL_MODES:
            _MODE = raw
        else:
            if raw not in ("", "auto"):
                log.warning("unknown MYTHRIL_GPU_KERNEL=%r; using auto", raw)
            _MODE = "pallas"
    return _MODE


def reset_kernel_mode() -> None:
    """Drop the cached kernel_mode() resolution (tests)."""
    global _MODE
    _MODE = None


class KernelCaps(NamedTuple):
    """Fixed capacities of the kernel's operands. Window shapes never
    appear here: they ride runtime arguments."""

    var_cap: int    # combined variable space (gate stream shares it:
                    # every gate output is a distinct variable)
    cone_cap: int   # cone slots
    root_cap: int   # roots per cone page
    lane_tile: int  # restart lanes pad to a multiple of this
    cone_tile: int  # the Pallas grid's cone tile (layout parity only)
    block: int      # gates per block-aligned cell count


CONE_TILE = 64  # the Pallas grid's cone tile; the CUDA kernel has no tiles
BLOCK = 256     # gates per block-aligned cell (the cells_stepped unit)


def _cap(name: str, default: int) -> int:
    """A capacity knob (env > cli > default); non-positive means default."""
    value = env_int(name, default)
    return value if value > 0 else default


def kernel_caps() -> KernelCaps:
    """Resolve the kernel capacities from the MYTHRIL_GPU_RAGGED_* knobs."""
    cone_cap = _cap("MYTHRIL_GPU_RAGGED_CONE_CAP", 128)
    return KernelCaps(
        var_cap=_cap("MYTHRIL_GPU_RAGGED_VAR_CAP", 1 << 16),
        cone_cap=cone_cap,
        root_cap=_cap("MYTHRIL_GPU_RAGGED_ROOT_CAP", 256),
        lane_tile=_cap("MYTHRIL_GPU_RAGGED_LANE_TILE", 8),
        cone_tile=min(CONE_TILE, cone_cap),
        block=BLOCK,
    )


# -- the kernel's per-cone layout ----------------------------------------------
#
# One block of the kernel serves one cone and LANES_PER_BLOCK restart lanes
# (a warp each). A cone takes the shared-memory path when its section plus
# one x page (a byte per local variable) per lane fits SMEM_CAP; else the
# global-table path, where the block's lanes share one page as bit slices
# (a byte per local variable, bit w for warp w's lane). The constants are
# mirrored in csrc/ragged_round.cu.
#
# On the shared-memory path a warp simulates the cone in steps of at most 32
# gates, two levels per step: a gate of the second level of a pair reads a
# first-level child's two inputs in its place (it "inlines" the child), so
# every gate of a step reads only values of earlier steps and the chain of
# dependent steps is about half the cone's depth.

LANES_PER_BLOCK = 4
SMEM_CAP = 224 * 1024  # of a block's 227 KB; the rest holds the mbarrier
GLOBAL_PASS = 512      # gates per pass of the global-table path (4 a thread)
GLOBAL_RING = 4        # passes of gate descriptors a global-path block holds
# bytes of a ring stage: the passes' five gate fields, then its bounds
GLOBAL_STAGE_BYTES = (len(GATE_KEYS) * GLOBAL_PASS + 4) * 4
HEADER_WORDS = 16      # int32 per cone in ConeLayout.header
GATE_PAD = 32          # zero gates after each shared-path gate list
# header columns
(H_BASE, H_SIZE, H_LEVELS, H_PATH, H_SECTION, H_SECTION_BYTES, H_STEP_OFF,
 H_GATE_OFF, H_ROOT_OFF, H_PAGE_BYTES, H_STEPS) = range(11)
PATH_SHARED, PATH_GLOBAL = 0, 1
# bits of a shared-path gate's third word above the b1 index
GATE_NA0, GATE_NA1, GATE_NB0, GATE_NB1, GATE_AN, GATE_BN = range(16, 22)


class ConeLayout(NamedTuple):
    """The per-cone sections of one stream (numpy arrays, or torch tensors
    after device_flat).

    header  int32 [num_cones, HEADER_WORDS]: page base (combined index of
            local var 1) and size, the cone's levels, its path, and its
            section's byte offset and size in `blob`.

            A shared-path section holds, at the H_*_OFF byte offsets: a
            uint32 pair per local variable 0..size {a | b << 16,
            an | bn << 1 | is_gate << 2} (the walk's records); uint16 step
            offsets [H_STEPS + 1] into the gate list; the gates in level
            order as uint32 quads {out | a0 << 16, a1 | b0 << 16, b1 | bits,
            0}, out = ((x[a0] ^ na0) & (x[a1] ^ na1) ^ an) & ((x[b0] ^ nb0)
            & (x[b1] ^ nb1) ^ bn) with the GATE_* bits (a child read
            directly has a0 = a1 and no negations; an inlined child's inputs
            stand in a0, a1), followed by GATE_PAD zero quads (a warp reads
            the next step's gates before it knows how many there are); and
            a uint32 per root column {local << 2 | neg << 1 | live}. The
            lane pages follow the section in shared memory, H_PAGE_BYTES
            each.

            A global-path section is int32 [H_STEPS + 1, 2]: the
            [begin, end) of each pass of the warp over the flat stream, at
            most GLOBAL_PASS of the cone's gates of one level, in level
            order, then [0, 0]. A block holds in shared memory one page
            of H_PAGE_BYTES, a byte per local variable with a bit per lane,
            then a ring of GLOBAL_RING passes of gate descriptors.
    blob    uint8: the sections, each 16-byte aligned and sized.
    """

    header: object
    blob: object
    v1: int               # first column past the last page (all unowned)
    smem_bytes: int       # dynamic shared memory a block of the launch gets
    global_cones: tuple   # cones on the global-table path


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def _split_by(values, counts):
    """Split `values` into consecutive runs of the given lengths."""
    return np.split(values, np.cumsum(counts)[:-1])


def _steps(gate_cone, gate_level, num_cones):
    """The warp's steps over each cone's level-ordered gates (their cones
    and combined levels, grouped by cone): each pair of levels is one
    step, split into runs of at most 32 gates. Returns per cone the step
    offsets into its gates, [steps + 1]."""
    counts = np.bincount(gate_cone, minlength=num_cones)
    key = gate_cone * (LEVEL_CAP + 1) + gate_level // 2
    run_start = np.flatnonzero(np.diff(key, prepend=-1))
    run_len = np.diff(np.append(run_start, len(key)))
    chunks = -(-run_len // 32)
    first = np.repeat(run_start, chunks) + 32 * (
        np.arange(chunks.sum()) - np.repeat(np.cumsum(chunks) - chunks,
                                            chunks))
    cone_start = np.cumsum(counts) - counts
    per_cone = _split_by(first, np.bincount(
        gate_cone[first], minlength=num_cones) if len(first) else counts)
    return [np.append(steps - cone_start[ci], counts[ci])
            for ci, steps in enumerate(per_cone)]


def _passes(segments):
    """Cut each level's [begin, end) run into passes whose span from the
    begin rounded down to a multiple of 4 (the kernel copies 16-byte
    chunks) holds at most GLOBAL_PASS gates; then the closing [0, 0]."""
    segments = segments.astype(np.int64)
    aligned = segments[:, 0] & ~3
    counts = -(-(segments[:, 1] - aligned) // GLOBAL_PASS)
    index = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    cut = np.repeat(aligned, counts) + GLOBAL_PASS * index
    begin = np.maximum(cut, np.repeat(segments[:, 0], counts))
    end = np.minimum(cut + GLOBAL_PASS, np.repeat(segments[:, 1], counts))
    return np.concatenate((np.stack((begin, end), axis=1),
                           np.zeros((1, 2), np.int64))).astype(np.int32)


def cone_layout(arrays: dict, pages, num_gates: int, num_levels: int,
                num_roots: int) -> ConeLayout:
    """Build the kernel's per-cone sections from flatten_stream's arrays
    (numpy) and the stream's pages [(base, size)]. Raises ValueError when
    the arrays break an invariant the kernel relies on: every gate and
    root of a cone stays in its page (or var 0), and each gate's inputs in
    the stream equal its variable's record."""
    num_cones = len(pages)
    var_cone = arrays["var_cone"]
    g_out = arrays["g_out"][:num_gates].astype(np.int64)
    gate_cone = var_cone[g_out].astype(np.int64)
    if num_gates and (g_out.min() <= 0 or gate_cone.min() < 0):
        raise ValueError("a gate writes var 0 or a column no cone owns")
    for key, var_key in (("g_a", "ga_var"), ("g_an", "ga_neg"),
                         ("g_b", "gb_var"), ("g_bn", "gb_neg")):
        if not np.array_equal(arrays[key][:num_gates],
                              arrays[var_key][g_out]):
            raise ValueError(f"{key} disagrees with {var_key}[g_out]")
    if not (arrays["is_gate"][g_out] == 1).all():
        raise ValueError("a gate output is not marked is_gate")
    for key in ("g_an", "g_bn", "ga_neg", "gb_neg", "is_gate", "root_neg",
                "root_mask"):
        if arrays[key].min(initial=0) < 0 or arrays[key].max(initial=0) > 1:
            raise ValueError(f"{key} holds a value other than 0 and 1")
    bases = np.array([base for base, _size in pages] or [1], dtype=np.int64)
    sizes = np.array([size for _base, size in pages] or [0], dtype=np.int64)
    v1 = int((bases + sizes).max())
    owner = var_cone[1:v1].astype(np.int64)
    if (owner < 0).any():
        raise ValueError("a column below the last page has no cone")

    # per-variable records, cone-local: row v is combined variable v
    shift = np.zeros((v1,), dtype=np.int64)  # combined = local + shift
    shift[1:] = bases[owner] - 1
    local = {}
    for key in ("ga_var", "gb_var"):
        child = arrays[key][:v1].astype(np.int64)
        if not ((child[1:] == 0) | (var_cone[child[1:]] == owner)).all():
            raise ValueError(f"{key} leaves a cone's page")
        local[key] = np.where(child > 0, child - shift, 0)
    records = np.zeros((v1, 2), dtype=np.int64)
    records[1:, 0] = local["ga_var"][1:] | (local["gb_var"][1:] << 16)
    records[1:, 1] = (arrays["ga_neg"][1:v1] | (arrays["gb_neg"][1:v1] << 1)
                      | (arrays["is_gate"][1:v1] << 2))

    # every gate as a quad (see ConeLayout), grouped by cone
    gate_level = np.repeat(np.arange(num_levels),
                           np.diff(arrays["level_start"][:num_levels + 1]))
    order = np.argsort(gate_cone, kind="stable")  # by cone, level order
    out, levels = g_out[order], gate_level[order]
    level_of = np.full((v1,), -1, dtype=np.int64)
    level_of[out] = levels
    odd = levels % 2 == 1
    bits = (((records[out, 1] & 1) << GATE_AN)
            | (((records[out, 1] >> 1) & 1) << GATE_BN))
    inputs = []
    for key, neg_bit in (("ga_var", GATE_NA0), ("gb_var", GATE_NB0)):
        child = arrays[key][out].astype(np.int64)
        inline = odd & (level_of[child] == levels - 1)
        rec = records[child]  # the child's own inputs, cone-local
        direct = local[key][out]
        inputs.append((np.where(inline, rec[:, 0] & 0xFFFF, direct),
                       np.where(inline, rec[:, 0] >> 16, direct)))
        bits |= ((np.where(inline, rec[:, 1] & 1, 0) << neg_bit)
                 | (np.where(inline, (rec[:, 1] >> 1) & 1, 0) << neg_bit + 1))
    (a0, a1), (b0, b1) = inputs
    quads = np.zeros((num_gates, 4), dtype=np.uint32)
    quads[:, 0] = (out - shift[out]) | (a0 << 16)
    quads[:, 1] = a1 | (b0 << 16)
    quads[:, 2] = b1 | bits
    counts = np.bincount(gate_cone, minlength=num_cones)
    cone_quads = _split_by(quads, counts)
    cone_pos = _split_by(order, counts)
    cone_steps = _steps(gate_cone[order], levels, num_cones)

    root_var = arrays["root_var"][:num_cones, :num_roots].astype(np.int64)
    cone_ids = np.arange(num_cones)[:, None]
    if not ((root_var == 0) | (var_cone[root_var] == cone_ids)).all():
        raise ValueError("a root leaves its cone's page")
    roots = ((np.where(root_var > 0, root_var - bases[:num_cones, None] + 1,
                       0) << 2)
             | (arrays["root_neg"][:num_cones, :num_roots] << 1)
             | (arrays["root_mask"][:num_cones, :num_roots] == 1)
             ).astype(np.uint32)
    records = records.astype(np.uint32)

    header = np.zeros((num_cones, HEADER_WORDS), dtype=np.int32)
    parts, offset, smem_bytes, global_cones = [], 0, 0, []
    root_bytes = _align16(4 * num_roots)
    for ci, (base, size) in enumerate(pages):
        pos, steps = cone_pos[ci], cone_steps[ci]
        levels = int(gate_level[pos[-1]]) + 1 if len(pos) else 0
        record_bytes = _align16(8 * (size + 1))
        step_bytes = _align16(2 * len(steps))
        gate_bytes = _align16(16 * (len(pos) + GATE_PAD))
        section_bytes = record_bytes + step_bytes + gate_bytes + root_bytes
        page_bytes = _align16(size + 1)
        need = section_bytes + LANES_PER_BLOCK * page_bytes
        row = header[ci]
        row[H_BASE], row[H_SIZE], row[H_LEVELS] = base, size, levels
        row[H_SECTION] = offset
        if need <= SMEM_CAP and size < 1 << 16:
            pieces = ((np.concatenate((np.zeros((1, 2), np.uint32),
                                       records[base: base + size])),
                       record_bytes),
                      (steps.astype(np.uint16), step_bytes),
                      (cone_quads[ci], gate_bytes), (roots[ci], root_bytes))
            row[H_PATH] = PATH_SHARED
            row[H_STEPS] = len(steps) - 1
            row[H_STEP_OFF] = record_bytes
            row[H_GATE_OFF] = record_bytes + step_bytes
            row[H_ROOT_OFF] = record_bytes + step_bytes + gate_bytes
        else:
            # the cone's gates of one level are one contiguous run of that
            # level's segment of the flat stream (RaggedStream places
            # cones in order within a level)
            segments = np.zeros((levels, 2), dtype=np.int32)
            if levels:
                level_off = np.searchsorted(gate_level[pos],
                                            np.arange(levels + 1))
                begin, end = level_off[:-1], level_off[1:]
                filled = end > begin
                segments[filled, 0] = pos[begin[filled]]
                segments[filled, 1] = pos[end[filled] - 1] + 1
                if not np.array_equal(segments[:, 1] - segments[:, 0],
                                      end - begin):
                    raise ValueError(f"cone {ci}: gates of a level are "
                                     "not contiguous in the stream")
            passes = _passes(segments)
            section_bytes = _align16(passes.nbytes)
            pieces = ((passes, section_bytes),)
            page_bytes = _align16(size + 1)
            need = page_bytes + GLOBAL_RING * GLOBAL_STAGE_BYTES
            row[H_PATH] = PATH_GLOBAL
            row[H_STEPS] = len(passes) - 1
            global_cones.append(ci)
        row[H_PAGE_BYTES] = page_bytes
        row[H_SECTION_BYTES] = section_bytes
        smem_bytes = max(smem_bytes, need)
        for piece, nbytes in pieces:
            raw = piece.view(np.uint8).reshape(-1)
            parts += [raw, np.zeros((nbytes - raw.size,), dtype=np.uint8)]
        offset += section_bytes
    blob = np.concatenate(parts) if parts else np.zeros((16,), np.uint8)
    return ConeLayout(header=header, blob=blob, v1=v1,
                      smem_bytes=int(smem_bytes),
                      global_cones=tuple(global_cones))


# -- host-side flattening -------------------------------------------------


class FlatStream(NamedTuple):
    """One RaggedStream flattened into the kernel's fixed-capacity paged
    layout (numpy arrays or torch tensors in `arrays`, ARRAY_ORDER), with
    the kernel's per-cone view of it in `cones`."""

    arrays: dict
    num_cones: int
    num_gates: int
    num_levels: int
    padded_cells: int  # block-aligned gate cells one simulate pass touches
    num_roots: int     # root-table columns any cone uses (<= root_cap)
    cones: ConeLayout


def flatten_stream(stream, caps: KernelCaps) -> Optional[FlatStream]:
    """Flatten one assembled RaggedStream into the kernel layout. Returns
    None when the window exceeds a capacity."""
    tensors = stream.tensors
    live = tensors["out_idx"] > 0
    counts = live.sum(axis=1).astype(np.int64)
    num_gates = int(counts.sum())
    num_levels = int(np.nonzero(counts)[0].max() + 1) if num_gates else 0
    v1 = int(stream.v1)
    cone_slots, max_roots = tensors["root_var"].shape
    if (v1 > caps.var_cap or num_gates >= caps.var_cap
            or cone_slots > caps.cone_cap or max_roots > caps.root_cap
            or num_levels > LEVEL_CAP):
        return None

    arrays = {}
    gate_src = {"g_out": "out_idx", "g_a": "a_var", "g_an": "a_neg",
                "g_b": "b_var", "g_bn": "b_neg"}
    for key in GATE_KEYS:
        # row-major boolean indexing == level-major stream order; the
        # trailing capacity slots stay zero (a var-0 no-op gate)
        flat = np.zeros((caps.var_cap,), dtype=np.int32)
        flat[:num_gates] = tensors[gate_src[key]][live]
        arrays[key] = flat
    level_start = np.full((LEVEL_CAP + 1,), num_gates, dtype=np.int32)
    level_start[0] = 0
    if num_levels:
        level_start[1:num_levels + 1] = np.cumsum(counts[:num_levels])
    arrays["level_start"] = level_start
    for key in VAR_KEYS:
        padded = np.zeros((caps.var_cap,), dtype=np.int32)
        padded[:v1] = tensors[key]
        arrays[key] = padded
    var_cone = np.full((caps.var_cap,), -1, dtype=np.int32)
    for ci, (base, size) in enumerate(stream.pages):
        var_cone[base: base + size] = ci
    arrays["var_cone"] = var_cone
    for key in ROOT_KEYS:
        padded = np.zeros((caps.cone_cap, caps.root_cap), dtype=np.int32)
        padded[:cone_slots, :max_roots] = tensors[key]
        arrays[key] = padded
    if num_levels:
        blocks = -(-counts[:num_levels] // caps.block)
        padded_cells = int((blocks * caps.block).sum())
    else:
        padded_cells = 0
    cones = cone_layout(arrays, stream.pages, num_gates, num_levels,
                        max(int(max_roots), 1))
    return FlatStream(arrays=arrays, num_cones=int(stream.num_cones),
                      num_gates=num_gates, num_levels=num_levels,
                      padded_cells=padded_cells, num_roots=int(max_roots),
                      cones=cones)


def device_flat(flat: FlatStream, device) -> FlatStream:
    """Upload a flattened stream once; rounds then reuse the resident
    tables."""
    cones = flat.cones._replace(
        header=torch.as_tensor(flat.cones.header,
                               dtype=torch.int32).to(device),
        blob=torch.as_tensor(flat.cones.blob, dtype=torch.uint8).to(device))
    return flat._replace(arrays={
        k: torch.as_tensor(v, dtype=torch.int32).to(device)
        for k, v in flat.arrays.items()}, cones=cones)


def pad_lanes(num_restarts: int, caps: KernelCaps) -> int:
    """Restart lanes padded up to a whole number of lane tiles (extra
    lanes are ordinary extra restarts, never masked)."""
    return -(-num_restarts // caps.lane_tile) * caps.lane_tile


# -- the counter hash ------------------------------------------------------
#
# xorshift-multiply finalizer over uint32, as in the Pallas kernel. torch
# has no uint32 shifts on the CPU, so the tensor form works in int64 masked
# to 32 bits, splitting each multiply so no product leaves int64.

_MASK32 = 0xFFFFFFFF
_C_STEP, _C_LANE, _C_CONE = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_C_ROOT, _C_COIN, _C_DEPTH = 0x27D4EB2F, 0x94D049BB, 0x165667B1


def _mul32(value, const: int):
    """(value * const) mod 2^32 for a python int or an int64 tensor in
    [0, 2^32)."""
    low = value * (const & 0xFFFF)
    high = ((value * (const >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK32


def _hash32(value):
    value = _mul32(value ^ (value >> 16), 0x7FEB352D)
    value = _mul32(value ^ (value >> 15), 0x846CA68B)
    return value ^ (value >> 16)


# -- the plain PyTorch version ----------------------------------------------


def run_round_ragged_plain(flat: FlatStream, x: torch.Tensor, seed: int,
                           steps: int, walk_depth: int, caps: KernelCaps):
    """The round written with torch tensor ops on x's device: `steps`
    iterations of simulate, per-cone violated-root pick and justification
    walk, one flip per (lane, cone); then a final simulate and check.
    Returns (x [lanes, var_cap] int32, found [lanes, cone_cap] bool)."""
    arrays = flat.arrays
    lanes = x.shape[0]
    cones, roots = caps.cone_cap, max(flat.num_roots, 1)
    device = x.device
    level_start = transfers.to_list(
        arrays["level_start"][: flat.num_levels + 1], "ragged.levels")
    levels = []
    for start, end in zip(level_start[:-1], level_start[1:]):
        if end > start:
            levels.append((arrays["g_out"][start:end].long(),
                           arrays["g_a"][start:end].long(),
                           arrays["g_an"][start:end],
                           arrays["g_b"][start:end].long(),
                           arrays["g_bn"][start:end]))
    ga_var, gb_var = arrays["ga_var"].long(), arrays["gb_var"].long()
    ga_neg, gb_neg = arrays["ga_neg"], arrays["gb_neg"]
    is_gate = arrays["is_gate"]
    root_var = arrays["root_var"][:, :roots].long()
    root_neg = arrays["root_neg"][:, :roots]
    root_mask = arrays["root_mask"][:, :roots]
    lane_cone_salt = (
        _mul32(torch.arange(lanes, device=device, dtype=torch.int64),
               _C_LANE)[:, None]
        ^ _mul32(torch.arange(cones, device=device, dtype=torch.int64),
                 _C_CONE)[None, :])                              # [L, C]
    root_salt = _mul32(torch.arange(roots, device=device,
                                    dtype=torch.int64), _C_ROOT)  # [R]
    seed32 = int(seed) & 0x7FFFFFFF

    def simulate(x):
        x[:, 0] = 0
        for out, a, an, b, bn in levels:
            x[:, out] = (x[:, a] ^ an) & (x[:, b] ^ bn)

    def violated(x):
        vals = x[:, root_var.reshape(-1)].reshape(lanes, cones, roots)
        return ((vals ^ root_neg) == 0) & (root_mask == 1)

    x_in = x
    x = x.clone()
    found = torch.zeros((lanes, cones), dtype=torch.bool, device=device)
    for step in range(steps):
        simulate(x)
        viol = violated(x)
        found |= ~viol.any(dim=2)
        step_key = _hash32(seed32 ^ _mul32(step, _C_STEP))
        keys = _hash32(step_key ^ lane_cone_salt[:, :, None] ^ root_salt)
        keyed = torch.where(viol, keys >> 1, torch.full_like(keys, -1))
        choice = keyed.argmax(dim=2, keepdim=True)  # first max: lowest root
        start_var = root_var.expand(lanes, -1, -1).gather(2, choice)[..., 0]
        start_neg = root_neg.expand(lanes, -1, -1).gather(2, choice)[..., 0]
        # satisfied cones park their walk on var 0 (not a gate)
        cur = torch.where(found, torch.zeros_like(start_var), start_var)
        want = 1 ^ start_neg
        done = torch.zeros_like(found)
        coin_base = (step_key ^ _C_COIN) ^ lane_cone_salt
        for depth in range(walk_depth):
            is_g = (is_gate[cur] == 1) & ~done
            av_i, bv_i = ga_var[cur], gb_var[cur]
            an, bn = ga_neg[cur], gb_neg[cur]
            av = x.gather(1, av_i) ^ an
            bv = x.gather(1, bv_i) ^ bn
            justified = (av & bv) == want
            coin = (_hash32(coin_base ^ _mul32(depth, _C_DEPTH)) & 1) == 1
            choose_b1 = ((av == 1) & (bv == 0)) | ((av == 0) & (bv == 0)
                                                   & coin)
            choose_b0 = ((av == 0) & (bv == 1)) | ((av == 1) & (bv == 1)
                                                   & coin)
            choose_b = torch.where(want == 1, choose_b1, choose_b0)
            active = is_g & ~justified
            cur = torch.where(active, torch.where(choose_b, bv_i, av_i), cur)
            want = torch.where(active,
                               want ^ torch.where(choose_b, bn, an), want)
            done = done | ~is_g | justified
            # every walk has ended: later depths change nothing
            if depth % 8 == 7 and bool(done.all()):
                break
        new_val = torch.where(found, x.gather(1, cur), want)
        x.scatter_(1, cur, new_val)
    simulate(x)
    found |= ~violated(x).any(dim=2)
    own = (arrays["var_cone"] >= 0)[None, :]
    return torch.where(own, x, x_in), found


# -- the CUDA kernel ----------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def nvcc_library(source: str, stem: str):
    """Compile `source` with nvcc into _build/lib<stem>.so, skipped when
    the library is newer than its source and the headers beside it.
    Returns (the library's path, the compiler's resource report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{stem}.so")
    log_path = os.path.join(BUILD_DIR, f"{stem}.ptxas.txt")
    # the source and the headers beside it (csrc/*.cuh) it may include
    newest = max(os.path.getmtime(path) for path in [source] + glob.glob(
        os.path.join(os.path.dirname(source), "*.cuh")))
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < newest:
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR,
                                         delete=False) as tmp:
            tmp_path = tmp.name
        try:
            done = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp_path, source],
                capture_output=True, text=True, timeout=600)
            if done.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({done.returncode}):\n{done.stderr}")
            with open(log_path, "w") as fd:
                fd.write(done.stderr)
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    ptxas = ""
    if os.path.exists(log_path):
        with open(log_path) as fd:
            ptxas = fd.read()
    return so_path, ptxas


def build_kernel() -> dict:
    """Compile csrc/ragged_round.cu with nvcc into _build/ (skipped when
    the library is newer than its source) and load it. Returns
    {"seconds": build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        so_path, ptxas = nvcc_library(KERNEL_SOURCE, "ragged_round")
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            ptr = ctypes.c_void_p
            lib.ragged_round_launch.restype = ctypes.c_int
            lib.ragged_round_launch.argtypes = (
                [ptr] * len(GLOBAL_PATH_KEYS) + [ptr] * 5
                + [ctypes.c_int] * 9 + [ctypes.c_uint]
                + [ctypes.c_int] + [ptr])
            lib.ragged_round_error_string.restype = ctypes.c_char_p
            lib.ragged_round_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_operands(flat: FlatStream, x: torch.Tensor, caps: KernelCaps):
    if x.dtype != torch.int32 or x.dim() != 2 \
            or x.shape[1] != caps.var_cap or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous int32 [lanes, {caps.var_cap}] tensor, "
            f"got {x.dtype} {tuple(x.shape)}")
    if x.numel() >= 1 << 31:  # the kernel indexes x with 32-bit ints
        raise ValueError(f"x of {x.numel()} cells is too large")
    if not x.shape[0] or x.shape[0] % caps.lane_tile:
        raise ValueError(f"lanes ({x.shape[0]}) must be a multiple of "
                         f"lane_tile ({caps.lane_tile}); see pad_lanes")
    shapes = {key: (caps.var_cap,) for key in GATE_KEYS + VAR_KEYS}
    shapes.update(level_start=(LEVEL_CAP + 1,), var_cone=(caps.var_cap,))
    shapes.update({key: (caps.cone_cap, caps.root_cap) for key in ROOT_KEYS})
    for key in ARRAY_ORDER:
        array = flat.arrays[key]
        if not isinstance(array, torch.Tensor) or array.device != x.device \
                or array.dtype != torch.int32 or not array.is_contiguous() \
                or tuple(array.shape) != shapes[key] \
                or array.data_ptr() % 16:
            raise ValueError(
                f"{key} must be a contiguous, 16-byte aligned int32 "
                f"{shapes[key]} tensor on {x.device} (device_flat)")
    cones = flat.cones
    for name, array, dtype, shape in (
            ("cones.header", cones.header, torch.int32,
             (flat.num_cones, HEADER_WORDS)),
            ("cones.blob", cones.blob, torch.uint8, None)):
        if not isinstance(array, torch.Tensor) or array.device != x.device \
                or array.dtype != dtype or not array.is_contiguous() \
                or (shape is not None and tuple(array.shape) != shape) \
                or array.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} tensor on {x.device} (device_flat)")
    if not 0 <= cones.smem_bytes <= SMEM_CAP:
        raise ValueError(f"a layout of {cones.smem_bytes} shared bytes")


def run_round_ragged_kernel(flat: FlatStream, x: torch.Tensor, seed: int,
                            steps: int, walk_depth: int, caps: KernelCaps):
    """Advance the restart lanes of one flattened stream by `steps`
    sim+flip iterations. x is [lanes, var_cap] int32 in {0, 1} with lanes
    a multiple of caps.lane_tile (pad_lanes); returns (x, found
    [lanes, cone_cap] bool) — slice found[:, :num_cones].

    CPU tensors run run_round_ragged_plain; CUDA tensors launch the CUDA
    kernel on the current stream, and a kernel that fails to build or to
    launch raises."""
    global launches
    _check_operands(flat, x, caps)
    if x.device.type == "cpu":
        return run_round_ragged_plain(flat, x, seed, steps, walk_depth, caps)
    if x.device.type != "cuda":
        raise ValueError(f"no ragged round for device {x.device}")
    if _lib is None:
        build_kernel()
    lanes = x.shape[0]
    x_out = torch.empty_like(x)
    found = torch.empty((lanes, caps.cone_cap), dtype=torch.bool,
                        device=x.device)
    cones = flat.cones
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.ragged_round_launch(
            *(flat.arrays[key].data_ptr() for key in GLOBAL_PATH_KEYS),
            cones.header.data_ptr(), cones.blob.data_ptr(),
            x.data_ptr(), x_out.data_ptr(), found.data_ptr(),
            lanes, caps.var_cap, caps.cone_cap, caps.root_cap,
            flat.num_cones, max(flat.num_roots, 1), cones.v1,
            int(steps), int(walk_depth), int(seed) & 0x7FFFFFFF,
            cones.smem_bytes, stream)
    if status != 0:
        raise RuntimeError("ragged_round launch failed: "
                           + _lib.ragged_round_error_string(status).decode())
    launches += 1
    return x_out, found


def reset_launches() -> None:
    global launches
    launches = 0
