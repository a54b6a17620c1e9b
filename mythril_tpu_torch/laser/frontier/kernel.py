"""Batched straight-line step.

One Run executes over a whole DenseFrontier in a single step. The
micro-op interpreter `_exec` is written once against axis-agnostic word
ops (frontier/words.py) plus a tiny backend shim for the two operations
whose indexing differs per backend (dynamic memory gather/scatter). Three
backends, chosen by resolve_backend():

  numpy   eager, batch axis explicit — every stack slot is (N, 32), the
          memory window (N, W). The host step, used when the analysis
          runs on the host.
  torch   the same `_exec` on torch tensors, batch axis explicit, on
          whatever device the frame is uploaded to: the plain version of
          the CUDA step (step_plain), which the tests and chip_smoke.py
          hold it against.
  cuda    K6, one hand-written CUDA kernel per step
          (gpu/frontier_kernel.py, csrc/frontier_step.cu): a micro-op
          interpreter that reads the run's encoded program from device
          memory, 8 lanes a row with the run's stack in shared memory,
          with K7's division inside. The program is data, so nothing is
          compiled per run or per shape, and batches are not padded. A
          step is one packed copy each way around the launch
          (frontier_kernel.step_frame); its arrays are views of a pinned
          buffer that the next step reuses.

Because sibling states share their pc, the whole batch executes the SAME
opcode sequence; the only per-state control flow is the `ok` mask: a
state whose dynamic behavior leaves the fast path (memory access outside
the dense window, gas exhaustion) has its row frozen out and replays,
untouched, on the per-state interpreter. Stack shape is static per
program point, so the working stack of `_exec` is a python list of
per-slot arrays — the padded dense array exists only at the
encode/decode boundary.

Backend choice: MYTHRIL_GPU_FRONTIER_BACKEND=auto|numpy|torch|cuda
(default auto = cuda when the analysis resolves a CUDA device, which the
default --solver-backend gpu does; numpy when the caller asked for the
host with --solver-backend cpu or --torch-device cpu). cuda never steps
on the host: with no card it raises NoDeviceError.
"""

import os
from typing import Optional

import numpy as np

from mythril_tpu_torch.laser.frontier import words
from mythril_tpu_torch.laser.frontier.dense import DenseFrontier
from mythril_tpu_torch.laser.frontier.fastset import Run
from mythril_tpu_torch.observe import transfers

BACKENDS = ("numpy", "torch", "cuda")

# observer of the cuda step: called with (run, frame) before each launch
# (chip_smoke.py keeps the largest batch an analysis stepped); None: off
on_cuda_step = None


def resolve_backend() -> str:
    """The step backend of an analysis (see the module note). With the
    default device backend and no card and no device named, this raises
    NoDeviceError, as every device entry point of the port does."""
    choice = os.environ.get("MYTHRIL_GPU_FRONTIER_BACKEND", "auto").lower()
    if choice in BACKENDS:
        return choice
    from mythril_tpu_torch.support.args import args

    if args.solver_backend != "gpu":
        return "numpy"
    from mythril_tpu_torch.gpu.device import resolve_device

    if resolve_device(args.torch_device).type != "cuda":
        return "numpy"
    return "cuda"


def backend_device(backend: str):
    """The torch device a backend steps on: for cuda the card the
    analysis names (--torch-device cuda:N) or the current one, never the
    host; for torch the named device or the CPU; None for numpy."""
    if backend == "numpy":
        return None
    import torch

    from mythril_tpu_torch.gpu.device import resolve_device
    from mythril_tpu_torch.support.args import args

    named = args.torch_device
    if backend == "cuda":
        if named is not None and torch.device(named).type == "cuda":
            return torch.device(named)
        return resolve_device(None)
    return torch.device(named if named is not None else "cpu")


# -- binary op table ---------------------------------------------------------


def _lt(xp, a, b):
    return words.mask_to_word(xp, words.ult_mask(xp, a, b))


def _gt(xp, a, b):
    return words.mask_to_word(xp, words.ult_mask(xp, b, a))


def _slt(xp, a, b):
    return words.mask_to_word(xp, words.slt_mask(xp, a, b))


def _sgt(xp, a, b):
    return words.mask_to_word(xp, words.slt_mask(xp, b, a))


def _eq(xp, a, b):
    return words.mask_to_word(xp, words.eq_mask(xp, a, b))


_BIN_FNS = {
    "add": words.add, "sub": words.sub, "mul": words.mul,
    "div": words.div, "mod": words.mod,
    "sdiv": words.sdiv, "smod": words.smod,
    "and": words.bit_and, "or": words.bit_or, "xor": words.bit_xor,
    "lt": _lt, "gt": _gt, "slt": _slt, "sgt": _sgt, "eq": _eq,
}


# -- backends ----------------------------------------------------------------


class _NumpyBackend:
    def __init__(self, batch: int):
        self.xp = np
        self.batch = batch
        self._offsets32 = np.arange(32)

    def const_word(self, limbs):
        return np.broadcast_to(
            np.array(limbs, dtype=np.int32), (self.batch, words.LIMBS))

    def gather_word(self, mem, off):
        idx = off[:, None] + self._offsets32
        return np.take_along_axis(mem, idx, axis=1)

    def scatter(self, mem, written, off, value, ok, size):
        idx = off[:, None] + np.arange(size)
        value = np.broadcast_to(value, idx.shape)
        current = np.take_along_axis(mem, idx, axis=1)
        np.put_along_axis(
            mem, idx, np.where(ok[:, None], value, current), axis=1)
        current_w = np.take_along_axis(written, idx, axis=1)
        np.put_along_axis(written, idx, current_w | ok[:, None], axis=1)
        return mem, written


class _TorchBackend:
    """_NumpyBackend's batch-explicit semantics on torch tensors of one
    device. scatter updates `mem` and `written` in place, as
    np.put_along_axis does: the frame's tensors are uploaded per step."""

    def __init__(self, batch: int, device):
        import torch

        self._torch = torch
        self.xp = words.torch_namespace(device)
        self.batch = batch
        self.device = device
        self._offsets32 = torch.arange(32, device=device)

    def const_word(self, limbs):
        return self._torch.tensor(
            limbs, dtype=self._torch.int32,
            device=self.device).expand(self.batch, words.LIMBS)

    def gather_word(self, mem, off):
        idx = off[:, None].long() + self._offsets32
        return self._torch.gather(mem, 1, idx)

    def scatter(self, mem, written, off, value, ok, size):
        torch = self._torch
        idx = off[:, None].long() + torch.arange(size, device=self.device)
        value = value.expand(idx.shape)
        current = torch.gather(mem, 1, idx)
        mem.scatter_(1, idx, torch.where(ok[:, None], value, current))
        current_w = torch.gather(written, 1, idx)
        written.scatter_(1, idx, current_w | ok[:, None])
        return mem, written


# -- the micro-op interpreter ------------------------------------------------


def _mem_extend(xp, off, size, msize, min_gas, max_gas, gas_limit, ok):
    """Bit-exact mirror of MachineState.mem_extend for concrete offsets:
    word-aligned growth + the yellow-paper quadratic fee + check_gas."""
    from mythril_tpu_torch.laser.state.machine_state import memory_expansion_fee

    end = off + size
    needed = ((end + 31) // 32) * 32
    new_words = needed // 32
    old_words = msize // 32
    extend = (msize <= end) & (new_words > old_words)
    # quadratic terms only evaluated on the extending lane (a dead lane's
    # msize may sit anywhere below the int32 encode cap — its square must
    # never be computed)
    ow = xp.where(extend, old_words, 0)
    nw = xp.where(extend, new_words, 0)
    fee = memory_expansion_fee(nw) - memory_expansion_fee(ow)
    min_gas = min_gas + fee
    max_gas = max_gas + fee
    ok = ok & (min_gas <= gas_limit)
    msize = xp.where(extend, needed, msize)
    return msize, min_gas, max_gas, ok


def _exec(bk, run: Run, slots, mem, written, msize, min_gas, max_gas,
          gas_limit, ok):
    # (offset, value-word) per MSTORE/MSTORE8 in run order: decode
    # replays these through Memory.write_word_at/write_byte so the SMT
    # store chain is built in EXECUTION order with the exact values —
    # byte-identical to the per-state interpreter's chain (a later
    # symbolic-index read over the chain sees the same term structure)
    mem_log = []
    # [dest-word, condition-word] when the run terminates in a batched
    # JUMPI fork (fastset Run.fork), [offset-word, length-word] when it
    # terminates in a RETURN halt (Run.halt), else empty
    fork_out = []
    xp = bk.xp
    for op in run.ops:
        kind = op.kind
        if kind == "push":
            slots.append(bk.const_word(op.arg))
        elif kind == "dup":
            slots.append(slots[-op.arg])
        elif kind == "swap":
            n = op.arg
            slots[-1], slots[-n - 1] = slots[-n - 1], slots[-1]
        elif kind == "pop":
            slots.pop()
        elif kind == "bin":
            a = slots.pop()
            b = slots.pop()
            slots.append(_BIN_FNS[op.arg](xp, a, b))
        elif kind == "not":
            slots.append(words.bit_not(xp, slots.pop()))
        elif kind == "iszero":
            slots.append(
                words.mask_to_word(xp, words.is_zero_mask(xp, slots.pop())))
        elif kind == "byte":
            index = slots.pop()
            value = slots.pop()
            slots.append(words.byte_op(xp, index, value))
        elif kind in ("shl", "shr", "sar"):
            shift = slots.pop()
            value = slots.pop()
            slots.append(getattr(words, kind)(xp, shift, value))
        elif kind == "signextend":
            position = slots.pop()
            value = slots.pop()
            slots.append(words.signextend(xp, position, value))
        elif kind == "mload":
            off, oob = words.mem_offset(
                xp, slots.pop(), 32, run.window)
            ok = ok & ~oob
            msize, min_gas, max_gas, ok = _mem_extend(
                xp, off, 32, msize, min_gas, max_gas, gas_limit, ok)
            slots.append(bk.gather_word(mem, off))
        elif kind == "mstore":
            off, oob = words.mem_offset(
                xp, slots.pop(), 32, run.window)
            value = slots.pop()
            ok = ok & ~oob
            msize, min_gas, max_gas, ok = _mem_extend(
                xp, off, 32, msize, min_gas, max_gas, gas_limit, ok)
            mem, written = bk.scatter(mem, written, off, value, ok, 32)
            mem_log.append((off, value))
        elif kind == "mstore8":
            off, oob = words.mem_offset(
                xp, slots.pop(), 1, run.window)
            value = slots.pop()
            ok = ok & ~oob
            msize, min_gas, max_gas, ok = _mem_extend(
                xp, off, 1, msize, min_gas, max_gas, gas_limit, ok)
            mem, written = bk.scatter(
                mem, written, off, value[..., 31:], ok, 1)
            mem_log.append((off, value))
        elif kind == "jumpi":
            # terminal fork op: pop destination then condition (the
            # interpreter's pop order) and surface both words to the
            # host — the stepper's fork epilogue needs the per-row
            # concrete destination, and the condition word when the
            # condition slot was kernel-computed. Neither operand is
            # a "consumed" window slot: a passthrough-symbolic slot's
            # limbs are encode-time zeros and the decode side uses the
            # ORIGINAL BitVec object instead (fastset provenance).
            fork_out.append(slots.pop())
            fork_out.append(slots.pop())
        elif kind == "return":
            # terminal halt op: pop offset then length (the
            # interpreter's pop order) and surface both words — the
            # stepper's halt epilogue needs per-row concrete operands
            # for kernel-computed sources (opaque operands bail the
            # row before decode per the symbolic lane's tag sim)
            fork_out.append(slots.pop())
            fork_out.append(slots.pop())
        elif kind == "stop":
            pass  # terminal halt op: no operands, host-side epilogue
        elif kind == "calldataload":
            # symbolic-lane op: pop the offset and push a placeholder
            # word. The pushed value is a TERM HANDLE by construction —
            # every row of a calldataload-bearing run decodes through
            # the lane's structural replay, which builds the canonical
            # calldata.get_word_at term host-side; these limbs are
            # never read back.
            slots.pop()
            slots.append(bk.const_word(words.word_from_int(0)))
        elif kind == "msize":
            slots.append(words.small_to_word(xp, msize))
        elif kind == "pc":
            slots.append(bk.const_word(words.word_from_int(op.arg)))
        elif kind == "nop":
            pass
        else:  # pragma: no cover - compile and execute must stay in sync
            raise AssertionError(f"unknown micro-op {kind}")
        # opcode gas accrues after the handler, as in instructions.execute
        min_gas = min_gas + op.gas_min
        max_gas = max_gas + op.gas_max
        ok = ok & (min_gas <= gas_limit)
    return (slots, mem, written, msize, min_gas, max_gas, ok, mem_log,
            fork_out)


# -- entry points ------------------------------------------------------------


def _step_numpy(run: Run, dense: DenseFrontier):
    batch = dense.batch
    bk = _NumpyBackend(batch)
    slots = [dense.stack[:, j] for j in range(run.touch)]
    slots, mem, written, msize, min_gas, max_gas, ok, mem_log, fork_out = \
        _exec(bk, run, slots, dense.mem, dense.mem_written, dense.msize,
              dense.min_gas, dense.max_gas, dense.gas_limit,
              dense.live.copy())
    if slots:
        stack_out = np.stack(
            [np.broadcast_to(s, (batch, words.LIMBS)) for s in slots],
            axis=1)
    else:
        stack_out = np.zeros((batch, 0, words.LIMBS), dtype=np.int32)
    mem_log = [
        (np.broadcast_to(off, (batch,)),
         np.broadcast_to(value, (batch, words.LIMBS)))
        for off, value in mem_log
    ]
    fork_out = [np.broadcast_to(w, (batch, words.LIMBS)) for w in fork_out]
    return (stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log,
            fork_out)


def step_plain(run: Run, stack, mem, written, msize, min_gas, max_gas,
               gas_limit, live):
    """The plain version of K6: `_exec` over torch tensors of one device,
    batch axis explicit. Takes the frame as tensors (stack int32
    [N, touch, 32], mem int32 [N, W] and written bool [N, W], updated in
    place, msize/min_gas/max_gas/gas_limit int32 [N], live bool [N]) and
    returns what gpu/frontier_kernel.run_step_kernel returns: (stack_out
    [N, out_len, 32], mem, written, msize, min_gas, max_gas, ok,
    log_off int32 [N, stores], log_val int32 [N, stores, 32], fork_out
    int32 [N, 0 or 2, 32])."""
    import torch

    batch = stack.shape[0]
    device = stack.device
    bk = _TorchBackend(batch, device)
    slots = [stack[:, j] for j in range(run.touch)]
    slots, mem, written, msize, min_gas, max_gas, ok, mem_log, fork_out = \
        _exec(bk, run, slots, mem, written, msize, min_gas, max_gas,
              gas_limit, live.clone())

    def word_rows(items):
        if not items:
            return torch.zeros((batch, 0, words.LIMBS), dtype=torch.int32,
                               device=device)
        return torch.stack([item.to(torch.int32).expand(batch, words.LIMBS)
                            for item in items], dim=1)

    if mem_log:
        log_off = torch.stack([off.to(torch.int32).expand(batch)
                               for off, _value in mem_log], dim=1)
    else:
        log_off = torch.zeros((batch, 0), dtype=torch.int32, device=device)
    return (word_rows(slots), mem, written, msize.to(torch.int32),
            min_gas.to(torch.int32), max_gas.to(torch.int32), ok,
            log_off, word_rows([value for _off, value in mem_log]),
            word_rows(fork_out))


def frame_tensors(dense: DenseFrontier, device):
    """The frame's arrays as fresh tensors on `device`, in step_plain's
    operand order (the step may update mem and written in place)."""
    import torch

    return [torch.from_numpy(np.ascontiguousarray(array)).to(device,
                                                             copy=True)
            for array in (dense.stack, dense.mem, dense.mem_written,
                          dense.msize, dense.min_gas, dense.max_gas,
                          dense.gas_limit, dense.live)]


def _download(outputs):
    """Tensor outputs -> step_batch's numpy nine (mem_log and fork_out as
    lists)."""
    (stack_out, mem, written, msize, min_gas, max_gas, ok, log_off,
     log_val, fork_out) = [transfers.to_numpy(tensor, "frontier.outputs")
                           for tensor in outputs]
    mem_log = [(log_off[:, k], log_val[:, k])
               for k in range(log_off.shape[1])]
    fork_words = [fork_out[:, k] for k in range(fork_out.shape[1])]
    return (stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log,
            fork_words)


def _step_torch(run: Run, dense: DenseFrontier, device):
    return _download(step_plain(run, *frame_tensors(dense, device)))


def _step_cuda(run: Run, dense: DenseFrontier, device):
    """K6 through the packed step on `device` (backend_device's, the
    card, when None). A device the caller names as the CPU takes the
    wrapper's rule for CPU tensors: the plain version."""
    import torch

    from mythril_tpu_torch.gpu import frontier_kernel

    device = torch.device(device if device is not None
                          else backend_device("cuda"))
    if on_cuda_step is not None:
        on_cuda_step(run, dense)
    if device.type == "cpu":
        return _download(frontier_kernel.run_step_kernel(
            run, *frame_tensors(dense, device)))
    return frontier_kernel.step_frame(run, dense, device)


def step_batch(run: Run, dense: DenseFrontier,
               backend: Optional[str] = None, device=None):
    """Execute `run` over the dense batch. Returns (stack_out, mem,
    mem_written, msize, min_gas, max_gas, ok, mem_log, fork_out) as
    numpy arrays; mem_log holds one (offset, value-word) pair per
    MSTORE/MSTORE8 of the run, in execution order, and fork_out holds
    the popped [destination-word, condition-word] when the run ends in
    a batched JUMPI fork, [offset-word, length-word] when it ends in a
    RETURN (empty otherwise). Rows with ok=False (bailed or padding)
    must be discarded by the caller. `device` is the torch device of
    the torch and cuda backends (backend_device's when None). The cuda
    backend's arrays are views of its step buffers, valid until the
    thread's next cuda step."""
    backend = backend or resolve_backend()
    if backend == "cuda":
        return _step_cuda(run, dense, device)
    if backend == "torch":
        return _step_torch(run, dense, device or backend_device("torch"))
    if backend != "numpy":
        raise ValueError(f"unknown frontier backend {backend!r}")
    return _step_numpy(run, dense)


def clear_caches() -> None:
    """Forget the CUDA step's encoded programs."""
    from mythril_tpu_torch.gpu import frontier_kernel

    frontier_kernel.clear_programs()
