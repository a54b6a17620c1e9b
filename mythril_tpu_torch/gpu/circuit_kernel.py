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
                  at first use into mythril_tpu_torch/_build/). For CPU
                  tensors, and only for those, it runs
  run_round_circuit_plain   the same round written with torch tensor ops.

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

LEVEL_KEYS = ("out_idx", "a_var", "a_neg", "b_var", "b_neg")
VAR_KEYS = ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate")
ROOT_KEYS = ("root_var", "root_neg", "root_mask")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "circuit_round.cu")

# The kernel's launch shape, mirrored in csrc/circuit_round.cu: a block of
# THREADS threads serves one query and up to LANES_MAX restart lanes (a
# warp each for the root check and the walk). A lane's x row lives in
# shared memory as a byte per variable while lanes x align16(V1) bytes fit
# SMEM_X_CAP (three lanes at V1 = 65,536); a query whose single row does
# not fit (V1 > 229,376) keeps x in global memory, in x_out itself.
THREADS = 256
LANES_MAX = THREADS // 32
SMEM_X_CAP = 224 * 1024
SM_COUNT = 132  # an H100 SXM's SMs; sizes the lane groups of a launch

# kernel launches since the last reset (the plain version never counts)
launches = 0


def _align16(n: int) -> int:
    return (n + 15) & ~15


def launch_shape(queries: int, lanes: int, v1: int):
    """(lanes per block, shared-memory path?) of one launch. Fewer lanes a
    block when the batch is small, so the grid still spans the card; the
    result never depends on it (every lane is independent)."""
    fit = SMEM_X_CAP // _align16(max(v1, 1))
    if fit == 0:
        return min(LANES_MAX, lanes), False
    spread = -(-queries * lanes // (2 * SM_COUNT))
    return max(1, min(LANES_MAX, fit, lanes, spread)), True


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
    level, 0 for a level of padding alone. The kernel sweeps only these
    cells; the cells past them write nothing (padding), so the bound
    changes no result."""
    live = tensors["out_idx"] > 0
    width = live.shape[2]
    col = torch.arange(1, width + 1, device=live.device, dtype=torch.int32)
    return (live.to(torch.int32) * col).amax(dim=2).to(torch.int32) \
        .contiguous() if width else torch.zeros(
            live.shape[:2], dtype=torch.int32, device=live.device)


# -- the plain PyTorch version ----------------------------------------------


def run_round_circuit_plain(tensors: dict, x: torch.Tensor, seed: int,
                            steps: int, walk_depth: int):
    """The round written with torch tensor ops on x's device, over the
    query axis: `steps` iterations of simulate, root check and pick,
    justification walk and one flip per (query, lane); then a final
    simulate and check. Returns (x [Q, R, V1] int32, found [Q, R] bool)."""
    q_count, lanes, v1 = x.shape
    device = x.device
    rows = level_rows(tensors).amax(dim=0).tolist() if q_count else []
    # (a, an, b, bn, out) of each level's cells up to its last live one
    levels = []
    for level, width in enumerate(rows):
        if width:  # a level of padding alone writes 0 into var 0: no-op
            cells = {key: tensors[key][:, level, :width]
                     for key in LEVEL_KEYS}
            levels.append((cells["a_var"].long(), cells["a_neg"],
                           cells["b_var"].long(), cells["b_neg"],
                           cells["out_idx"].long()))
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
        for a, an, b, bn, out in levels:
            width = out.shape[1]
            shape = (q_count, lanes, width)
            va = x.gather(2, a[:, None, :].expand(shape)) ^ an[:, None, :]
            vb = x.gather(2, b[:, None, :].expand(shape)) ^ bn[:, None, :]
            value = (va & vb) * (out > 0).to(torch.int32)[:, None, :]
            x.scatter_(2, out[:, None, :].expand(shape), value)

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
            cur = torch.where(active, torch.where(choose_b, bv_i, av_i), cur)
            want = torch.where(active,
                               want ^ torch.where(choose_b, bn, an), want)
            done = done | ~is_g | justified
            # every walk has ended: later depths change nothing
            if depth % 8 == 7 and bool(done.all()):
                break
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
                [ptr] * (len(TENSOR_KEYS) + 4) + [ctypes.c_int] * 8
                + [ctypes.c_uint] + [ctypes.c_int] * 2 + [ptr])
            lib.circuit_round_error_string.restype = ctypes.c_char_p
            lib.circuit_round_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_operands(tensors: dict, x: torch.Tensor, rows):
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
    if rows is not None and (
            not isinstance(rows, torch.Tensor) or rows.device != x.device
            or rows.dtype != torch.int32 or not rows.is_contiguous()
            or tuple(rows.shape) != (q_count, levels)):
        raise ValueError(f"rows must be a contiguous int32 "
                         f"({q_count}, {levels}) tensor (level_rows)")


def run_round_circuit_kernel(tensors: dict, x: torch.Tensor, seed: int,
                             steps: int, walk_depth: int, rows=None):
    """Advance the restart lanes of a batch of padded cones by `steps`
    sim+flip iterations. Returns (x [Q, R, V1] int32, found [Q, R] bool).
    `rows` is level_rows(tensors), computed here when None (the backend
    passes it once per batch).

    CPU tensors run run_round_circuit_plain; CUDA tensors launch the CUDA
    kernel on the current stream, and a kernel that fails to build or to
    launch raises."""
    global launches
    _check_operands(tensors, x, rows)
    if x.device.type == "cpu":
        return run_round_circuit_plain(tensors, x, seed, steps, walk_depth)
    if x.device.type != "cuda":
        raise ValueError(f"no circuit round for device {x.device}")
    if _lib is None:
        build_kernel()
    if rows is None:
        rows = level_rows(tensors)
    q_count, lanes, v1 = x.shape
    levels, width = tensors["out_idx"].shape[1:]
    per_block, in_smem = launch_shape(q_count, lanes, v1)
    x_out = torch.empty_like(x)
    found = torch.empty((q_count, lanes), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.circuit_round_launch(
            *(tensors[key].data_ptr() for key in TENSOR_KEYS),
            rows.data_ptr(), x.data_ptr(), x_out.data_ptr(),
            found.data_ptr(), q_count, lanes, levels, width, v1,
            tensors["root_var"].shape[1], int(steps), int(walk_depth),
            int(seed) & 0x7FFFFFFF, per_block, int(in_smem), stream)
    if status != 0:
        raise RuntimeError("circuit_round launch failed: "
                           + _lib.circuit_round_error_string(status).decode())
    launches += 1
    return x_out, found


def reset_launches() -> None:
    global launches
    launches = 0
