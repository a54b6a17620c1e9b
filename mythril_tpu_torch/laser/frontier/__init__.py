"""Batched symbolic-execution frontier — sibling machine states stepping a
straight-line opcode run as one device step (the path-exploration
worklist executed as a batch).

LaserEVM steps one python GlobalState at a time through term-building
instruction handlers; once solving is cheap that loop IS the wall. This
package packs N sibling states (same code object, same pc — the ragged
work items) into dense padded arrays (dense.py), compiles the fork-free
straight-line run at that pc — identified by the pre-analysis CFG — into
a micro-op program over exact 256-bit limb arithmetic (fastset.py,
words.py), and executes the whole frontier slice in one batched step
(kernel.py: the hand-written CUDA step K6 on the card, eager numpy when
the analysis runs on the host). States whose dynamic behavior leaves the
fast path (symbolic operands on entry, memory access beyond the dense
window, gas exhaustion) exit the batch and replay on the existing
per-state interpreter in laser/instructions.py — the unchanged
ground-truth oracle. Storage ops stay on the oracle path too: SLOAD/SSTORE
carry detector and pruner hooks in every shipped configuration, so a
dense storage fast path would never fire (see fastset.py).

Gating: `--no-vmap-frontier` CLI flag, MYTHRIL_GPU_VMAP_FRONTIER=0|1 env
override, on top of the preanalysis master switch (the run extractor
consumes the pre-analysis CFG). Off by default for direct engine
embedders; SymExecWrapper turns it on for analysis runs that do not
require a full per-instruction statespace.
"""

import os

from mythril_tpu_torch.laser.frontier.stepper import FrontierStepper  # noqa: F401


def enabled() -> bool:
    """Env override first, then the --no-vmap-frontier flag, on top of
    the preanalysis master switch (mirrors aig_opt.enabled())."""
    env = os.environ.get("MYTHRIL_GPU_VMAP_FRONTIER", "")
    if env in ("0", "off", "false"):
        return False
    from mythril_tpu_torch import preanalysis

    if not preanalysis.enabled():
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_vmap_frontier", False)


def fork_enabled() -> bool:
    """Device-side branching: fork symbolic JUMPI batch-wise inside the
    dense representation. MYTHRIL_GPU_FRONTIER_FORK env override first,
    then the --no-frontier-fork flag, on top of the vmap-frontier
    switch (a fork run IS a frontier run)."""
    env = os.environ.get("MYTHRIL_GPU_FRONTIER_FORK", "")
    if env in ("0", "off", "false"):
        return False
    if not enabled():
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_frontier_fork", False)


def symlane_enabled() -> bool:
    """Symbolic-value lanes in the dense representation
    (laser/frontier/symlane.py): stack slots may carry opaque
    term-handles instead of concrete limbs, CALLDATALOAD promotes
    in-batch, and RETURN/STOP become terminal micro-ops.
    MYTHRIL_GPU_FRONTIER_SYMLANE (default on), on top of the
    vmap-frontier switch."""
    if not enabled():
        return False
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_GPU_FRONTIER_SYMLANE", 1) != 0


def multipc_width() -> int:
    """Cross-fork re-batching width (MYTHRIL_GPU_FRONTIER_MULTIPC):
    how many fork-cohort groups — distinct (code-hash, pc) keys of one
    fork step's successor set — may chain through their next dense run
    without re-entering the worklist. 0 disables re-batching (every
    cohort pays the one-iteration worklist stall); default 2 covers
    both sides of a fork."""
    from mythril_tpu_torch.support.env import env_int

    return max(env_int("MYTHRIL_GPU_FRONTIER_MULTIPC", 2), 0)


def fork_depth_cap() -> int:
    """MYTHRIL_GPU_FRONTIER_FORK_DEPTH: rows at or past this state depth
    take the per-state JUMPI instead of the batched fork (an operator
    brake on fork fan-out, never a semantic change). 0 = uncapped."""
    try:
        return max(
            int(os.environ.get("MYTHRIL_GPU_FRONTIER_FORK_DEPTH", "0")
                or 0), 0)
    except ValueError:
        return 0


def clear_caches() -> None:
    from mythril_tpu_torch.laser.frontier import kernel

    kernel.clear_caches()
