"""The batched frontier step (K6, with K7's division inside): a CUDA kernel
for Hopper behind one wrapper, and the program encoding it reads.

Replaces mythril_tpu/laser/frontier/kernel.py `_build_jax_step` (the XLA
program jit(vmap(_exec))) and mythril_tpu/laser/frontier/words.py
`_divmod_bitserial`, and computes what laser/frontier/kernel.py's `_exec`
computes, bit for bit. The plain version is
laser/frontier/kernel.step_plain (the same `_exec` on torch tensors).

  encode_program   a Run as device data: an int32 op table of (kind,
                   arg, gas_min, gas_max) and a pool of PUSH/PC constant
                   words (8 x u32 each, least significant first), cached
                   per (run.key, device), at most PROGRAM_CACHE_MAX;
  run_step_kernel  the wrapper: checks the frame's tensors and, for CUDA
                   tensors, launches csrc/frontier_step.cu on the current
                   stream (built with nvcc at first use into
                   mythril_tpu_torch/_build/). For CPU tensors — and only
                   for those — it runs step_plain;
  prepare_launch   the CUDA half of the wrapper: the outputs allocated and
                   a launch that can be repeated into them (chip_smoke.py
                   times the kernel alone with it).

The kernel updates `mem` and `written` in place, as the plain version's
scatter does; every other output is allocated here.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from mythril_tpu_torch.laser.frontier import words

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "frontier_step.cu")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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

# kernel launches since the last reset (the plain version never counts)
launches = 0

_programs = {}
_lib = None
_lib_lock = threading.Lock()


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


# -- the CUDA kernel ----------------------------------------------------------


def build_kernel() -> dict:
    """Compile csrc/frontier_step.cu with nvcc into _build/ (skipped when
    the library is newer than its source) and load it. Returns
    {"seconds": build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR, "libfrontier_step.so")
        log_path = os.path.join(BUILD_DIR, "frontier_step.ptxas.txt")
        if (not os.path.exists(so_path) or os.path.getmtime(so_path)
                < os.path.getmtime(KERNEL_SOURCE)):
            nvcc = shutil.which("nvcc") or os.path.join(
                os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
            with tempfile.NamedTemporaryFile(suffix=".so", dir=BUILD_DIR,
                                             delete=False) as tmp:
                tmp_path = tmp.name
            try:
                done = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", tmp_path, KERNEL_SOURCE],
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
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            ptr = ctypes.c_void_p
            lib.frontier_step_launch.restype = ctypes.c_int
            lib.frontier_step_launch.argtypes = (
                [ptr] * 19 + [ctypes.c_int] * 8 + [ptr])
            lib.frontier_step_error_string.restype = ctypes.c_char_p
            lib.frontier_step_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        ptxas = ""
        if os.path.exists(log_path):
            with open(log_path) as fd:
                ptxas = fd.read()
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


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
    if run.has_mem and window < 32:
        raise ValueError(f"a memory run needs a window of 32 bytes or more, "
                         f"got {window}")
    if rows * max(run.capacity, 1) * 8 >= 1 << 31:
        raise ValueError(f"{rows} rows of {run.capacity} slots are too many")


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
    if stack.device.type != "cuda":
        raise ValueError(f"no frontier step for device {stack.device}")
    outputs, launch = prepare_launch(run, stack, mem, written, msize,
                                     min_gas, max_gas, gas_limit, live)
    launch()
    launches += 1
    return outputs


def prepare_launch(run, stack, mem, written, msize, min_gas, max_gas,
                   gas_limit, live):
    """The outputs of one CUDA step, allocated, and a function that
    launches the kernel into them (uncounted; raises on a launch error).
    The launch may be repeated: it rewrites the same outputs, and mem and
    written in place with the same stores."""
    if _lib is None:
        build_kernel()
    device = stack.device
    rows = stack.shape[0]
    n_log, n_fork = log_stores(run), fork_words(run)
    ops, consts = program_tensors(run, device)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    stack_out = empty(rows, run.out_len, words.LIMBS)
    scratch = empty(max(run.capacity, 1), 8, rows)
    msize_out, min_gas_out, max_gas_out = (empty(rows), empty(rows),
                                           empty(rows))
    ok = empty(rows, dtype=torch.bool)
    log_off = empty(rows, n_log)
    log_val = empty(rows, n_log, words.LIMBS)
    fork_out = empty(rows, n_fork, words.LIMBS)
    pointers = (
        ops.data_ptr(), consts.data_ptr(), stack.data_ptr(),
        stack_out.data_ptr(), scratch.data_ptr(), mem.data_ptr(),
        written.data_ptr(), msize.data_ptr(), min_gas.data_ptr(),
        max_gas.data_ptr(), gas_limit.data_ptr(), live.data_ptr(),
        msize_out.data_ptr(), min_gas_out.data_ptr(),
        max_gas_out.data_ptr(), ok.data_ptr(), log_off.data_ptr(),
        log_val.data_ptr(), fork_out.data_ptr(), len(run.ops),
        run.touch, run.out_len, max(run.capacity, 1), mem.shape[1],
        n_log, n_fork, rows)

    def launch(_alive=(ops, consts, scratch)):  # held while it is reused
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            status = _lib.frontier_step_launch(*pointers, stream)
        if status != 0:
            raise RuntimeError(
                "frontier_step launch failed: "
                + _lib.frontier_step_error_string(status).decode())

    return (stack_out, mem, written, msize_out, min_gas_out, max_gas_out,
            ok, log_off, log_val, fork_out), launch


def reset_launches() -> None:
    global launches
    launches = 0
