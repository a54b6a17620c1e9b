"""Shared helpers of the tests that hold the PyTorch port
(mythril_tpu_torch) against the JAX package (mythril_tpu): data passes
between the two only as numpy arrays."""

import importlib
import logging
import os
import re
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

from mythril_tpu_torch.gpu.circuit import PackedCircuit as PortPacked
from mythril_tpu_torch.smt.bitblast import AIG as PortAIG


def port_aig(ref_aig, cache=None):
    """The reference AIG's gate table rebuilt as a port AIG."""
    key = id(ref_aig)
    if cache is not None and key in cache:
        return cache[key][1]
    lhs, rhs = ref_aig.gate_arrays()
    aig = PortAIG.from_gate_arrays(np.array(lhs), np.array(rhs))
    if cache is not None:
        cache[key] = (ref_aig, aig)  # pin the reference: ids stay unique
    return aig


def port_packed(ref_pc, ref_aig, roots, cache=None):
    """The port's PackedCircuit of the same cone (carry literals too)."""
    carry = tuple(var << 1 for var in ref_pc.carry_local)
    return PortPacked(port_aig(ref_aig, cache), roots, carry_lits=carry)


def assert_packed_equal(ref_pc, pc):
    assert pc.ok == ref_pc.ok
    assert list(pc.var_map) == list(ref_pc.var_map)
    for key in ("out_idx", "a_var", "a_neg", "b_var", "b_neg", "ga_var",
                "ga_neg", "gb_var", "gb_neg", "is_gate", "root_var",
                "root_neg", "root_mask", "level_rows"):
        np.testing.assert_array_equal(getattr(pc, key), getattr(ref_pc, key),
                                      err_msg=key)


# -- analyze runs of either package ------------------------------------------


class _TimeoutWatch(logging.Handler):
    """Collects the engine's "... timeout reached" lines: a run that logs
    one explored a prefix that depends on the machine's speed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.hits = []

    def emit(self, record):
        message = record.getMessage()
        if "timeout reached" in message:
            self.hits.append(message)


@contextmanager
def watch_timeouts(package: str):
    """Yields the list of timeout lines `package`'s engine logs inside."""
    logger = logging.getLogger(f"{package}.laser.svm")
    handler = _TimeoutWatch()
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield handler.hits
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def run_analyze(package: str, code_hex: str, tx_count: int, backend: str,
                execution_timeout: int, device=None, pruning_factor=None,
                modules=None, bin_runtime=False, frontier=True, flags=None):
    """One `analyze` of `code_hex` through `package`'s MythrilAnalyzer from
    fresh process state (args, solve caches, the shared blaster).
    `frontier` sets the batched frontier alike in both packages: on (their
    default) or off (--no-vmap-frontier). `flags` are further CLI fields
    by their dest (enable_summaries=True, ...), given alike to both.
    Returns the Report; asserts that the exploration completed."""
    core = importlib.import_module(f"{package}.core")
    args = importlib.import_module(f"{package}.support.args").args
    model = importlib.import_module(f"{package}.support.model")
    frontend = importlib.import_module(f"{package}.smt.solver.frontend")
    args.reset()
    model.clear_caches()
    frontend._global_blaster = None
    cmd_args = SimpleNamespace(
        execution_timeout=execution_timeout, transaction_count=tx_count,
        max_depth=128, solver_backend=backend, pruning_factor=pruning_factor,
        no_vmap_frontier=not frontier, **(flags or {}))
    if package != "mythril_tpu":
        cmd_args.torch_device = device
    disassembler = core.MythrilDisassembler()
    disassembler.load_from_bytecode(code_hex, bin_runtime=bin_runtime)
    time_handler = importlib.import_module(
        f"{package}.support.time_handler").time_handler
    try:
        with watch_timeouts(package) as timeouts:
            analyzer = core.MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                            strategy="bfs")
            report = analyzer.fire_lasers(modules=modules,
                                          transaction_count=tx_count)
    finally:
        # the JAX package's fire_lasers leaves its execution budget set:
        # once it passed, a later get_models_batch in this process (a
        # JAX-package test on the same worker) would dispatch nothing
        time_handler.start_execution(None)
    assert not timeouts, f"{package} run did not complete: {timeouts}"
    assert not report.exceptions, report.exceptions
    args.reset()
    return report


def issue_keys(report):
    """A report's findings at issue granularity: SWC id, function, address
    and title (the witness a device model picks may differ)."""
    return sorted((issue.swc_id, issue.function, issue.address, issue.title)
                  for issue in report.issues.values())


# -- frontier frames ----------------------------------------------------------


def port_frame(ref_frame):
    """The port's DenseFrontier holding a copy of the reference frame's
    numpy arrays (the symbolic lane's tags and handles too)."""
    from mythril_tpu_torch.laser.frontier.dense import DenseFrontier

    frame = DenseFrontier(0, 0, 1)
    for name in ("stack", "depth", "mem", "mem_written", "msize", "pc",
                 "min_gas", "max_gas", "gas_limit", "live"):
        setattr(frame, name, np.array(getattr(ref_frame, name), copy=True))
    if ref_frame.sym_tags is not None:
        frame.sym_tags = np.array(ref_frame.sym_tags, copy=True)
    if ref_frame.handles is not None:
        frame.handles = list(ref_frame.handles)
    return frame


def with_dead_rows(frame, slots: int):
    """The port's DenseFrontier of `frame`'s rows followed by dead ones
    (all zeros, not live) up to `slots` rows."""
    from mythril_tpu_torch.laser.frontier.dense import DenseFrontier

    padded = DenseFrontier(slots, frame.stack.shape[1], frame.mem.shape[1])
    for name in ("stack", "depth", "mem", "mem_written", "msize", "pc",
                 "min_gas", "max_gas", "gas_limit", "live"):
        getattr(padded, name)[:frame.batch] = getattr(frame, name)
    return padded


# -- the report snapshots' contracts -------------------------------------------

SNAPSHOTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "testdata", "expected_reports")


def snapshot_input(file_name: str) -> str:
    """The bytecode of a contract of tests/testdata/expected_reports/ (the
    inputs are not in the repo): its text snapshot's first transaction
    creates the contract, and that transaction's input is the code."""
    with open(os.path.join(SNAPSHOTS, file_name + ".text")) as handle:
        match = re.search(r'"input": "0x([0-9a-f]+)"', handle.read())
    return match.group(1)
