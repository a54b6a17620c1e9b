"""K2, the XLA-semantics ragged round: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces mythril_tpu/tpu/circuit.py `run_round_ragged` (:557, with
`_walk_ragged` :517 and `_simulate` :398). That is an XLA program, not a
Pallas kernel: the JAX package's round over a window's cones in one
RaggedStream padded to its 1.5x shape bucket, which it runs by default off
a TPU and falls back to past the Pallas round's capacities. Here it is the
round of the xla kernel mode (MYTHRIL_GPU_KERNEL=xla) and the fallback of
the pallas mode for a stream past one of K1's capacities. K2 has no
capacities: any V1, cone slots, roots per cone, levels (up to MAX_LEVELS)
and row width.

Operands (XlaStream, built once per stream by device_stream): the
RaggedStream's tensors, int32 and contiguous on x's device: out_idx,
a_var, a_neg, b_var, b_neg [L, W]; ga_var, ga_neg, gb_var, gb_neg,
is_gate [V1]; root_var, root_neg, root_mask [C, R]; plus level_rows [L],
the columns of each level up to its last real gate (0 for a level of
padding alone). x is [lanes, V1] int32 in {0, 1}.

Per step and restart lane, the reference's semantics: x[:, 0] = 0;
simulate level by level (a cell whose out_idx is 0 is padding, which
writes 0 into var 0: skipped); per cone, found |= no violated root
(sticky); pick one violated root; a found cone parks its walk on var 0;
walk back from the root with want = 1 ^ root_neg for at most walk_depth
gates; then one flip per (lane, cone), written only after every walk of
the lane has read x. A final reset, simulate and check make the returned
x gate-consistent. Returns (x [lanes, V1] int32, found [lanes, C] bool).

Randomness: the reference's categorical pick and bernoulli coins are
threefry draws the port cannot reproduce. Both come from K1's counter hash
(ragged_kernel._hash32 and its salts) instead: the pick is the violated
root of maximal hashed key (seed, step, lane, cone, root), the lowest on
ties, which is uniform over the violated roots; the coin at a depth is
the low bit of the hash of (seed, step, lane, cone, depth). The kernel and
its plain version therefore agree bit for bit; models may differ from the
reference's.

  run_round_xla_kernel  the wrapper: checks its operands and, for CUDA
                  tensors, launches csrc/xla_round.cu (built with nvcc at
                  first use into mythril_tpu_torch/_build/). For CPU
                  tensors, and only for those, it runs
  run_round_xla_plain   the same round written with torch tensor ops.
  launch_arguments      the kernel's arguments in its order, as the
                  wrapper passes them (the CPU tests read them back the
                  way the kernel does).
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

LEVEL_KEYS = ("out_idx", "a_var", "a_neg", "b_var", "b_neg")
VAR_KEYS = ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate")
ROOT_KEYS = ("root_var", "root_neg", "root_mask")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "xla_round.cu")

# the kernel's launch, mirrored in csrc/xla_round.cu: a block of THREADS
# threads a restart lane
THREADS = 256
# the kernel's arguments, in order: the stream's tables and level_rows,
# x in and out, found, the flip scratch, then the sizes
POINTER_ARGS = LEVEL_KEYS + ("level_rows",) + VAR_KEYS + ROOT_KEYS + (
    "x_in", "x_out", "found", "flips")
INT_ARGS = ("lanes", "v1", "levels", "width", "cones", "roots", "steps",
            "walk_depth")
# seed (an unsigned int), then the cudaStream_t
ARG_ORDER = POINTER_ARGS + INT_ARGS + ("seed", "stream")

# kernel launches since the last reset (the plain version never counts)
launches = 0


class XlaStream(NamedTuple):
    """One RaggedStream's tensors on a device, as K2 reads them."""

    tensors: dict             # circuit.TENSOR_KEYS
    level_rows: torch.Tensor  # int32 [L]
    num_cones: int            # live cones (the rest of C is padding slots)

    @property
    def nbytes(self) -> int:
        """Bytes of the stream's tables on the device."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.tensors.values())
                   + self.level_rows.numel() * 4)


def level_rows(out_idx: np.ndarray) -> np.ndarray:
    """Per level, the columns up to and including its last real gate
    (out_idx > 0); 0 for a level of padding alone."""
    live = np.asarray(out_idx) > 0
    width = live.shape[1]
    last = width - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


def device_stream(stream, device) -> XlaStream:
    """Upload one assembled RaggedStream once; rounds then reuse the
    resident tables."""
    tensors = {key: torch.as_tensor(np.ascontiguousarray(
        stream.tensors[key], dtype=np.int32)).to(device)
        for key in TENSOR_KEYS}
    rows = torch.as_tensor(level_rows(stream.tensors["out_idx"])).to(device)
    return XlaStream(tensors=tensors, level_rows=rows,
                     num_cones=int(stream.num_cones))


# -- the plain PyTorch version ----------------------------------------------


def run_round_xla_plain(xs: XlaStream, x: torch.Tensor, seed: int,
                        steps: int, walk_depth: int):
    """The round written with torch tensor ops on x's device: `steps`
    iterations of simulate, per-cone check and pick, justification walk
    and one flip per (lane, cone); then a final simulate and check.
    Returns (x [lanes, V1] int32, found [lanes, C] bool)."""
    tensors = xs.tensors
    lanes = x.shape[0]
    device = x.device
    levels = []
    for level, rows in enumerate(xs.level_rows.tolist()):
        if not rows:
            continue
        live = tensors["out_idx"][level, :rows] > 0
        cells = {key: tensors[key][level, :rows][live] for key in LEVEL_KEYS}
        levels.append((cells["out_idx"].long(), cells["a_var"].long(),
                       cells["a_neg"], cells["b_var"].long(),
                       cells["b_neg"]))
    ga_var, gb_var = tensors["ga_var"].long(), tensors["gb_var"].long()
    ga_neg, gb_neg = tensors["ga_neg"], tensors["gb_neg"]
    is_gate = tensors["is_gate"]
    root_var = tensors["root_var"].long()
    root_neg = tensors["root_neg"]
    root_mask = tensors["root_mask"]
    cones, roots = root_var.shape
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
        # found cones park their walk on var 0 (not a gate)
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
        # every walk read x before any flip; a flip of var 0 is reset
        # before anything reads it
        new_val = torch.where(found, x.gather(1, cur), want)
        x.scatter_(1, cur, new_val)
    simulate(x)
    found |= ~violated(x).any(dim=2)
    return x, found


# -- the CUDA kernel ----------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_kernel() -> dict:
    """Compile csrc/xla_round.cu with nvcc into _build/ (skipped when the
    library is newer than its source) and load it. Returns {"seconds":
    build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        so_path, ptxas = nvcc_library(KERNEL_SOURCE, "xla_round")
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            ptr = ctypes.c_void_p
            lib.xla_round_launch.restype = ctypes.c_int
            lib.xla_round_launch.argtypes = (
                [ptr] * len(POINTER_ARGS) + [ctypes.c_int] * len(INT_ARGS)
                + [ctypes.c_uint, ptr])
            lib.xla_round_error_string.restype = ctypes.c_char_p
            lib.xla_round_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_operands(xs: XlaStream, x: torch.Tensor):
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int32 [lanes, V1] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    lanes, v1 = x.shape
    if not lanes or v1 < 2:
        raise ValueError(f"x of shape {tuple(x.shape)} holds no variable")
    if v1 >= 1 << 30:
        raise ValueError(f"V1 of {v1} variables is too large")
    levels, width = xs.tensors["out_idx"].shape
    cones, roots = xs.tensors["root_var"].shape
    shapes = {key: (levels, width) for key in LEVEL_KEYS}
    shapes.update({key: (v1,) for key in VAR_KEYS})
    shapes.update({key: (cones, roots) for key in ROOT_KEYS})
    arrays = dict(xs.tensors, level_rows=xs.level_rows)
    shapes["level_rows"] = (levels,)
    for key, shape in shapes.items():
        array = arrays.get(key)
        if not isinstance(array, torch.Tensor) or array.device != x.device \
                or array.dtype != torch.int32 or not array.is_contiguous() \
                or tuple(array.shape) != shape:
            raise ValueError(
                f"{key} must be a contiguous int32 {shape} tensor on "
                f"{x.device} (device_stream)")
    if not levels or not width or not cones or not roots:
        raise ValueError(f"empty tables: levels {levels}, width {width}, "
                         f"cones {cones}, roots {roots}")
    if not 0 <= xs.num_cones <= cones:
        raise ValueError(f"{xs.num_cones} live cones of {cones} slots")


def launch_arguments(xs: XlaStream, x: torch.Tensor, x_out: torch.Tensor,
                     found: torch.Tensor, flips: torch.Tensor, seed: int,
                     steps: int, walk_depth: int, stream=None) -> dict:
    """The kernel's arguments by name, in ARG_ORDER: data pointers, then
    the sizes the kernel indexes with (x's row stride is `v1`, a level's
    is `width`, a cone's root row's `roots`, a lane's found and flip rows'
    `cones`; the kernel widens each product to 64 bits), the seed and the
    CUDA stream (None: the default stream)."""
    levels, width = xs.tensors["out_idx"].shape
    cones, roots = xs.tensors["root_var"].shape
    pointers = dict(xs.tensors, level_rows=xs.level_rows, x_in=x,
                    x_out=x_out, found=found, flips=flips)
    args = {key: pointers[key].data_ptr() for key in POINTER_ARGS}
    args.update(lanes=x.shape[0], v1=x.shape[1], levels=levels,
                width=width, cones=cones, roots=roots,
                steps=max(int(steps), 0), walk_depth=max(int(walk_depth), 0),
                seed=int(seed) & 0x7FFFFFFF, stream=stream)
    return {key: args[key] for key in ARG_ORDER}


def run_round_xla_kernel(xs: XlaStream, x: torch.Tensor, seed: int,
                         steps: int, walk_depth: int):
    """Advance the restart lanes of one uploaded stream by `steps`
    sim+flip iterations. Returns (x [lanes, V1] int32, found [lanes, C]
    bool): slice found[:, :num_cones].

    CPU tensors run run_round_xla_plain; CUDA tensors launch the CUDA
    kernel on the current stream, and a kernel that fails to build or to
    launch raises."""
    global launches
    _check_operands(xs, x)
    if x.device.type == "cpu":
        return run_round_xla_plain(xs, x, seed, steps, walk_depth)
    if x.device.type != "cuda":
        raise ValueError(f"no xla round for device {x.device}")
    if _lib is None:
        build_kernel()
    lanes = x.shape[0]
    cones = xs.tensors["root_var"].shape[0]
    x_out = torch.empty_like(x)
    found = torch.empty((lanes, cones), dtype=torch.bool, device=x.device)
    flips = torch.empty((lanes, cones, 2), dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.xla_round_launch(*launch_arguments(
            xs, x, x_out, found, flips, seed, steps, walk_depth,
            stream).values())
    if status != 0:
        raise RuntimeError("xla_round launch failed: "
                           + _lib.xla_round_error_string(status).decode())
    launches += 1
    return x_out, found


def reset_launches() -> None:
    global launches
    launches = 0
