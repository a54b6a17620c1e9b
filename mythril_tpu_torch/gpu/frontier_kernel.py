"""The batched frontier step (K6, with K7's division inside): a CUDA kernel
for Hopper behind one wrapper, the packed step that feeds it, and the
program encoding it reads.

Replaces mythril_tpu/laser/frontier/kernel.py `_build_jax_step` (the XLA
program jit(vmap(_exec))) and mythril_tpu/laser/frontier/words.py
`_divmod_bitserial`, and computes what laser/frontier/kernel.py's `_exec`
computes, bit for bit. The plain version is
laser/frontier/kernel.step_plain (the same `_exec` on torch tensors).

  encode_program   a Run as device data: an int32 op table of (kind,
                   arg, gas_min, gas_max) and a pool of PUSH/PC constant
                   words (8 x u32 each, least significant first), cached
                   per (run.key, device), at most PROGRAM_CACHE_MAX;
  block_rows       the rows a block works (8 lanes a row): MAX_BLOCK_ROWS,
                   fewer when that many rows' stacks (the run's capacity,
                   32 bytes a slot) do not fit the block's shared memory;
  pack_frame       a DenseFrontier's arrays written into this thread's
                   step buffers for a device (StepWorkspace, laid out by
                   StepLayout): the host side of a step, on any device;
  step_frame       the stepper's step on a card: pack_frame, then one
                   copy to the device, one launch, one copy back and one
                   synchronisation, all in one call of the library; the
                   outputs are numpy views of the pinned buffer;
  run_step_kernel  the wrapper on tensors: checks the frame's tensors and,
                   for CUDA tensors, launches csrc/frontier_step.cu on the
                   current stream (built with nvcc at first use into
                   mythril_tpu_torch/_build/). For CPU tensors — and only
                   for those — it runs step_plain;
  prepare_launch   the tensor wrapper's outputs allocated and a launch that
                   can be repeated into them (chip_smoke.py times the
                   kernel alone with it); CUDA tensors only.

The kernel updates `mem` and `written` in place, as the plain version's
scatter does.
"""

import ctypes
import math
import os
import threading
import time

import numpy as np
import torch

from mythril_tpu_torch.gpu.ragged_kernel import nvcc_library
from mythril_tpu_torch.laser.frontier import words
from mythril_tpu_torch.observe import transfers

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "frontier_step.cu")

# micro-op kinds and binary ops in the order of csrc/frontier_step.cu's
# Kind and BinOp enums
KINDS = ("push", "dup", "swap", "pop", "bin", "not", "iszero", "byte", "shl",
         "shr", "sar", "signextend", "mload", "mstore", "mstore8", "jumpi",
         "return", "stop", "calldataload", "msize", "pc", "nop")
BIN_OPS = ("add", "sub", "mul", "div", "mod", "sdiv", "smod", "and", "or",
           "xor", "lt", "gt", "slt", "sgt", "eq")
_KIND_CODE = {kind: code for code, kind in enumerate(KINDS)}
_BIN_CODE = {name: code for code, name in enumerate(BIN_OPS)}

PROGRAM_CACHE_MAX = 512
# rows a block works, 8 lanes each (csrc/frontier_step.cu kMaxBlockRows),
# and the shared memory a block may take on an H100 (227 KB)
MAX_BLOCK_ROWS = 8
SHARED_MEMORY_BYTES = 232448
SLOT_BYTES = 32
# field offsets in the packed buffers (16 is what the kernel's int4
# accesses need)
ALIGN = 256
MIN_WORKSPACE = 1 << 16

# kernel launches since the last reset (the plain version never counts)
launches = 0

_programs = {}
_lib = None
_lib_lock = threading.Lock()
_workspaces = threading.local()


def _word_u32(value: int) -> list:
    """256-bit int -> 8 u32 words, least significant first, as int32 bits."""
    return [int(np.uint32((value >> (32 * k)) & 0xFFFFFFFF).view(np.int32))
            for k in range(8)]


def encode_program(run) -> tuple:
    """(ops int32 [n_ops, 4], consts int32 [max(n, 1), 8]) as numpy arrays:
    the run's micro-ops with their constant words pooled."""
    ops, consts = [], []
    for op in run.ops:
        arg = 0
        if op.kind == "push":
            arg = len(consts)
            consts.append(_word_u32(words.int_from_limbs(op.arg)))
        elif op.kind == "pc":
            arg = len(consts)
            consts.append(_word_u32(op.arg))
        elif op.kind in ("dup", "swap"):
            arg = op.arg
        elif op.kind == "bin":
            arg = _BIN_CODE[op.arg]
        ops.append((_KIND_CODE[op.kind], arg, op.gas_min, op.gas_max))
    ops_array = np.array(ops, dtype=np.int32).reshape(len(ops), 4)
    consts_array = np.array(consts or [[0] * 8], dtype=np.int32)
    return ops_array, consts_array


def program_tensors(run, device) -> tuple:
    """encode_program's arrays on `device`, encoded once per run."""
    key = (run.key, str(device))
    cached = _programs.get(key)
    if cached is None:
        if len(_programs) >= PROGRAM_CACHE_MAX:
            _programs.clear()
        ops, consts = encode_program(run)
        cached = (torch.from_numpy(ops).to(device),
                  torch.from_numpy(consts).to(device))
        _programs[key] = cached
    return cached


def clear_programs() -> None:
    _programs.clear()


def log_stores(run) -> int:
    return sum(1 for op in run.ops if op.kind in ("mstore", "mstore8"))


def fork_words(run) -> int:
    """2 when the run ends in a batched JUMPI or a RETURN, else 0."""
    if run.fork is not None or (run.halt is not None
                                and run.halt.kind == "return"):
        return 2
    return 0


def stack_pitch(capacity: int) -> int:
    """Stack slots a row takes in shared memory: the capacity rounded up to
    odd, so the 4 rows of a warp fall on different banks."""
    return max(capacity, 1) | 1


def block_rows(capacity: int) -> int:
    """Rows a block works for a run of `capacity` stack slots (0: a row's
    stack does not fit the block's shared memory)."""
    row_bytes = stack_pitch(capacity) * SLOT_BYTES
    return min(MAX_BLOCK_ROWS, SHARED_MEMORY_BYTES // row_bytes)


# -- the packed step ----------------------------------------------------------

# (name, dtype) in buffer order: the inputs, mem and written (updated in
# place, so both uploaded and downloaded), then the outputs
INPUT_FIELDS = (("stack", np.int32), ("msize", np.int32),
                ("min_gas", np.int32), ("max_gas", np.int32),
                ("gas_limit", np.int32), ("live", np.bool_))
IN_PLACE_FIELDS = (("mem", np.int32), ("written", np.bool_))
OUTPUT_FIELDS = (("stack_out", np.int32), ("msize_out", np.int32),
                 ("min_gas_out", np.int32), ("max_gas_out", np.int32),
                 ("ok", np.bool_), ("log_off", np.int32),
                 ("log_val", np.int32), ("fork_out", np.int32))
FIELDS = INPUT_FIELDS + IN_PLACE_FIELDS + OUTPUT_FIELDS
# step_plain's operands, in order
FRAME_FIELDS = ("stack", "mem", "written", "msize", "min_gas", "max_gas",
                "gas_limit", "live")
# run_step_kernel's results, in order
RESULT_FIELDS = ("stack_out", "mem", "written", "msize_out", "min_gas_out",
                 "max_gas_out", "ok", "log_off", "log_val", "fork_out")
_TORCH_DTYPES = {np.int32: torch.int32, np.bool_: torch.bool}


def _aligned(offset: int) -> int:
    return -(-offset // ALIGN) * ALIGN


class StepLayout:
    """Where each field of one step lies in the packed buffers.

    `fields` maps a name to (byte offset, numpy dtype, shape), each offset
    a multiple of ALIGN. The upload copies [0, upload_end): the inputs and
    mem/written. The download copies [download_start, total): mem/written
    and the outputs when the run stores to memory, the outputs alone
    otherwise (the window then comes back as it went)."""

    __slots__ = ("key", "fields", "total", "upload_end", "download_start")

    def __init__(self, rows: int, touch: int, out_len: int, window: int,
                 n_log: int, n_fork: int):
        self.key = (rows, touch, out_len, window, n_log, n_fork)
        shapes = {
            "stack": (rows, touch, words.LIMBS), "msize": (rows,),
            "min_gas": (rows,), "max_gas": (rows,), "gas_limit": (rows,),
            "live": (rows,), "mem": (rows, window),
            "written": (rows, window),
            "stack_out": (rows, out_len, words.LIMBS), "msize_out": (rows,),
            "min_gas_out": (rows,), "max_gas_out": (rows,), "ok": (rows,),
            "log_off": (rows, n_log), "log_val": (rows, n_log, words.LIMBS),
            "fork_out": (rows, n_fork, words.LIMBS)}
        self.fields = {}
        offset = 0
        for name, dtype in FIELDS:
            shape = shapes[name]
            self.fields[name] = (offset, dtype, shape)
            offset = _aligned(offset + math.prod(shape)
                              * np.dtype(dtype).itemsize)
            if name == "written":
                self.upload_end = offset
        self.total = offset
        self.download_start = self.fields[
            "mem" if n_log else "stack_out"][0]

    def numpy_views(self, buffer: np.ndarray) -> dict:
        """The fields as numpy views of a uint8 buffer."""
        views = {}
        for name in self.fields:
            offset, dtype, shape = self.fields[name]
            nbytes = math.prod(shape) * np.dtype(dtype).itemsize
            views[name] = buffer[offset:offset + nbytes].view(
                dtype).reshape(shape)
        return views

    def tensor_views(self, buffer: torch.Tensor, names=None,
                     base: int = 0) -> dict:
        """The fields as views of a uint8 tensor that starts at byte
        `base` of the layout."""
        views = {}
        for name in names or self.fields:
            offset, dtype, shape = self.fields[name]
            nbytes = math.prod(shape) * np.dtype(dtype).itemsize
            views[name] = buffer[offset - base:offset - base + nbytes].view(
                _TORCH_DTYPES[dtype]).view(shape)
        return views


def step_layout(run, rows: int, window: int) -> StepLayout:
    return StepLayout(rows, run.touch, run.out_len, window, log_stores(run),
                      fork_words(run))


class _Frame(ctypes.Structure):
    """csrc/frontier_step.cu's Frame, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "ops", "consts", "stack_in", "msize_in", "min_gas_in", "max_gas_in",
        "gas_limit", "live", "mem", "written", "stack_out", "msize_out",
        "min_gas_out", "max_gas_out", "ok_out", "log_off", "log_val",
        "fork_out")]
        + [(name, ctypes.c_int) for name in (
            "n_ops", "touch", "out_len", "pitch", "window", "n_log",
            "n_fork", "rows", "block_rows")])


class _StepArgs(ctypes.Structure):
    """csrc/frontier_step.cu's StepArgs: the frame and the copies around
    the launch (sizes 0: no copy; a download also synchronises)."""
    _fields_ = [("frame", _Frame), ("upload_src", ctypes.c_void_p),
                ("upload_dst", ctypes.c_void_p),
                ("download_src", ctypes.c_void_p),
                ("download_dst", ctypes.c_void_p),
                ("upload_bytes", ctypes.c_longlong),
                ("download_bytes", ctypes.c_longlong)]


# _Frame's pointer fields and the layout fields they point at
_FRAME_POINTERS = (
    ("stack_in", "stack"), ("msize_in", "msize"), ("min_gas_in", "min_gas"),
    ("max_gas_in", "max_gas"), ("gas_limit", "gas_limit"), ("live", "live"),
    ("mem", "mem"), ("written", "written"), ("stack_out", "stack_out"),
    ("msize_out", "msize_out"), ("min_gas_out", "min_gas_out"),
    ("max_gas_out", "max_gas_out"), ("ok_out", "ok"),
    ("log_off", "log_off"), ("log_val", "log_val"),
    ("fork_out", "fork_out"))


def frame_args(run, layout: StepLayout, pointers: dict, device) -> tuple:
    """A _StepArgs for `run` over the fields at `pointers` (name -> device
    address), with no copies, and the program tensors it points at."""
    ops, consts = program_tensors(run, device)
    rows, window = layout.key[0], layout.key[3]
    frame = _Frame(
        ops=ops.data_ptr(), consts=consts.data_ptr(),
        n_ops=len(run.ops), touch=run.touch, out_len=run.out_len,
        pitch=stack_pitch(run.capacity), window=window,
        n_log=layout.key[4], n_fork=layout.key[5], rows=rows,
        block_rows=block_rows(run.capacity))
    for field, name in _FRAME_POINTERS:
        setattr(frame, field, pointers[name])
    return _StepArgs(frame=frame), (ops, consts)


class StepWorkspace:
    """One device's step buffers for one thread: a host buffer (pinned for
    a CUDA device) and a device buffer, each laid out by a StepLayout.
    They grow geometrically and are reused, so a step allocates nothing;
    `allocations` counts the growths. The numpy views and the launch
    arguments of each layout are kept until the buffers grow; the launch
    arguments hold the program tensors they point at."""

    def __init__(self, device):
        self.device = device
        self.capacity = 0
        self.allocations = 0
        self.host = self.dev = self.host_np = None
        self._views = {}
        self._launches = {}

    def reserve(self, nbytes: int) -> None:
        if nbytes <= self.capacity:
            return
        capacity = max(nbytes, 2 * self.capacity, MIN_WORKSPACE)
        self.host = torch.empty(capacity, dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
        self.dev = torch.empty(capacity, dtype=torch.uint8,
                               device=self.device)
        self.host_np = self.host.numpy()
        self.capacity = capacity
        self.allocations += 1
        self._views.clear()
        self._launches.clear()

    def views(self, layout: StepLayout) -> dict:
        """Every field as a numpy view of the host buffer."""
        views = self._views.get(layout.key)
        if views is None:
            views = self._views[layout.key] = layout.numpy_views(
                self.host_np)
        return views

    def launch_args(self, run, layout: StepLayout) -> _StepArgs:
        """The _StepArgs of one step of `run` through these buffers: the
        upload, the frame in the device buffer and the download."""
        key = (run.key, layout.key)
        cached = self._launches.get(key)
        if cached is None:
            if len(self._launches) >= PROGRAM_CACHE_MAX:
                self._launches.clear()
            host, dev = self.host.data_ptr(), self.dev.data_ptr()
            pointers = {name: dev + offset
                        for name, (offset, _dtype, _shape)
                        in layout.fields.items()}
            args, alive = frame_args(run, layout, pointers, self.device)
            args.upload_src, args.upload_dst = host, dev
            args.upload_bytes = layout.upload_end
            args.download_src = dev + layout.download_start
            args.download_dst = host + layout.download_start
            args.download_bytes = layout.total - layout.download_start
            cached = self._launches[key] = (args, alive)
        return cached[0]


def workspace(device) -> StepWorkspace:
    """This thread's StepWorkspace for `device`."""
    by_device = getattr(_workspaces, "by_device", None)
    if by_device is None:
        by_device = _workspaces.by_device = {}
    key = str(device)
    found = by_device.get(key)
    if found is None:
        found = by_device[key] = StepWorkspace(torch.device(device))
    return found


def pack_frame(run, dense, device) -> tuple:
    """(workspace, layout, views): the frame's arrays written into this
    thread's host buffer for `device`, laid out for one step of `run`."""
    rows, window = dense.stack.shape[0], dense.mem.shape[1]
    _check_run(run, window)
    layout = step_layout(run, rows, window)
    space = workspace(device)
    space.reserve(layout.total)
    views = space.views(layout)
    for name, array in zip(FRAME_FIELDS, (
            dense.stack, dense.mem, dense.mem_written, dense.msize,
            dense.min_gas, dense.max_gas, dense.gas_limit, dense.live)):
        view = views[name]
        if array.shape != view.shape or array.dtype != view.dtype:
            raise ValueError(f"{name} must be {view.dtype} {view.shape}, "
                             f"got {array.dtype} {array.shape}")
        view[...] = array
    return space, layout, views


def step_frame(run, dense, device):
    """One step of `run` over a DenseFrontier on a CUDA `device`
    (step_batch's nine results: stack_out, mem, written, msize, min_gas,
    max_gas, ok, mem_log, fork_out).

    pack_frame, then one library call uploads the pinned buffer, launches
    the kernel on the current stream, downloads the outputs and
    synchronises, and raises on any error. The results are views of the
    host buffer, valid until this thread's next step on `device`: copy
    what must outlive it."""
    global launches
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no frontier step kernel for device {device}")
    space, layout, views = pack_frame(run, dense, device)
    if _lib is None:
        build_kernel()
    args = space.launch_args(run, layout)
    _launch(args, space.device)
    launches += 1
    transfers.downloaded("frontier.step", args.download_bytes)
    mem_log = [(views["log_off"][:, k], views["log_val"][:, k])
               for k in range(layout.key[4])]
    fork_out = [views["fork_out"][:, k] for k in range(layout.key[5])]
    return (views["stack_out"], views["mem"], views["written"],
            views["msize_out"], views["min_gas_out"], views["max_gas_out"],
            views["ok"], mem_log, fork_out)


def _launch(args: _StepArgs, device) -> None:
    """frontier_step on the device's current stream; raises on an error."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            _launch(args, device)
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    status = _lib.frontier_step(ctypes.byref(args), stream)
    if status != 0:
        raise RuntimeError("frontier_step failed: "
                           + _lib.frontier_step_error_string(status).decode())


# -- the CUDA kernel ----------------------------------------------------------


def build_kernel() -> dict:
    """Compile csrc/frontier_step.cu with nvcc into _build/ (skipped when
    the library is newer than its source) and load it. Returns
    {"seconds": build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        so_path, ptxas = nvcc_library(KERNEL_SOURCE, "frontier_step")
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            lib.frontier_step_args_size.restype = ctypes.c_int
            lib.frontier_step_args_size.argtypes = []
            if lib.frontier_step_args_size() != ctypes.sizeof(_StepArgs):
                raise RuntimeError(
                    f"frontier_step's StepArgs is "
                    f"{lib.frontier_step_args_size()} bytes, _StepArgs "
                    f"{ctypes.sizeof(_StepArgs)}")
            lib.frontier_step.restype = ctypes.c_int
            lib.frontier_step.argtypes = [ctypes.POINTER(_StepArgs),
                                          ctypes.c_void_p]
            lib.frontier_step_error_string.restype = ctypes.c_char_p
            lib.frontier_step_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_run(run, window: int) -> None:
    """What the kernel cannot take, whatever the frame's device."""
    if run.has_mem and window < 32:
        raise ValueError(f"a memory run needs a window of 32 bytes or more, "
                         f"got {window}")
    if block_rows(run.capacity) < 1:
        raise ValueError(
            f"a run of {run.capacity} stack slots does not fit a block's "
            f"{SHARED_MEMORY_BYTES} bytes of shared memory")


def _check_frame(run, stack, mem, written, msize, min_gas, max_gas,
                 gas_limit, live):
    rows = stack.shape[0] if stack.dim() == 3 else -1
    window = mem.shape[1] if mem.dim() == 2 else -1
    want = (("stack", stack, torch.int32, (rows, run.touch, words.LIMBS)),
            ("mem", mem, torch.int32, (rows, window)),
            ("written", written, torch.bool, (rows, window)),
            ("msize", msize, torch.int32, (rows,)),
            ("min_gas", min_gas, torch.int32, (rows,)),
            ("max_gas", max_gas, torch.int32, (rows,)),
            ("gas_limit", gas_limit, torch.int32, (rows,)),
            ("live", live, torch.bool, (rows,)))
    for name, tensor, dtype, shape in want:
        if (not isinstance(tensor, torch.Tensor) or tensor.dtype != dtype
                or tuple(tensor.shape) != shape
                or tensor.device != stack.device
                or not tensor.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} {shape} tensor on "
                f"{stack.device}")
    if rows < 0 or window < 1:
        raise ValueError("an empty frame")
    if stack.data_ptr() % 16:
        raise ValueError("stack must start on a 16-byte boundary (the "
                         "kernel reads a word's limbs 16 bytes a lane)")
    _check_run(run, window)


def run_step_kernel(run, stack, mem, written, msize, min_gas, max_gas,
                    gas_limit, live):
    """One step of `run` over the frame's tensors (step_plain's operands).
    Returns (stack_out, mem, written, msize, min_gas, max_gas, ok,
    log_off, log_val, fork_out) as tensors on the frame's device.

    CPU tensors run laser/frontier/kernel.step_plain; CUDA tensors launch
    the CUDA kernel on the current stream, and a kernel that fails to
    build or to launch raises."""
    global launches
    _check_frame(run, stack, mem, written, msize, min_gas, max_gas,
                 gas_limit, live)
    if stack.device.type == "cpu":
        from mythril_tpu_torch.laser.frontier.kernel import step_plain

        return step_plain(run, stack, mem, written, msize, min_gas, max_gas,
                          gas_limit, live)
    outputs, launch = prepare_launch(run, stack, mem, written, msize,
                                     min_gas, max_gas, gas_limit, live)
    launch()
    launches += 1
    return outputs


def prepare_launch(run, stack, mem, written, msize, min_gas, max_gas,
                   gas_limit, live):
    """The outputs of one step, allocated in one buffer, and a function
    that launches the kernel into them (uncounted; raises on a launch
    error). The launch may be repeated: it rewrites the same outputs, and
    mem and written in place with the same stores. CUDA tensors only:
    CPU tensors have no kernel to launch."""
    _check_frame(run, stack, mem, written, msize, min_gas, max_gas,
                 gas_limit, live)
    device = stack.device
    if device.type != "cuda":
        raise ValueError(f"no frontier step kernel for device {device}")
    layout = step_layout(run, stack.shape[0], mem.shape[1])
    base = layout.fields["stack_out"][0]
    out_names = [name for name, _dtype in OUTPUT_FIELDS]
    buffer = torch.empty(max(layout.total - base, 1), dtype=torch.uint8,
                         device=device)
    fields = layout.tensor_views(buffer, out_names, base)
    fields.update(stack=stack, mem=mem, written=written, msize=msize,
                  min_gas=min_gas, max_gas=max_gas, gas_limit=gas_limit,
                  live=live)
    outputs = tuple(fields[name] for name in RESULT_FIELDS)
    if _lib is None:
        build_kernel()
    args, alive = frame_args(
        run, layout, {name: tensor.data_ptr()
                      for name, tensor in fields.items()}, device)

    def launch(_alive=(alive, fields)):  # held while it is reused
        _launch(args, device)

    return outputs, launch


def reset_launches() -> None:
    global launches
    launches = 0
