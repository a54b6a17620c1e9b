"""The analyze_corpus runner: the configuration's contracts as one batch in
one warm process, as `myth analyze` runs a corpus given on one command
line, with the configuration's --corpus-interleave.

Set-up applies the configuration's envelope (corpus_interleave among its
flags), builds and loads the kernels, and runs one uncounted warm-up batch
(which also calibrates the router). In the measured window batches run
back to back, one in flight: batch b is contracts b * batch to
(b + 1) * batch - 1 of the seeded stream (generate.ContractSource, as the
pool's), so with a batch of the configuration's size each batch holds
every contract once, in an order drawn from the seed, selectors redrawn.
Each batch loads its contracts, under their configuration names, into one
disassembler and calls MythrilAnalyzer.fire_lasers once; the batch in
flight when `seconds` have passed is finished. The rate is every contract
analyzed over the time from the window's start to the last batch's end,
so none is cut. The reference then holds each contract's findings, split
from its batch's report by contract name, against the pins
(reference/findings.py); an exception in a batch's report fails it.

myth analyze takes one -t for an invocation; each contract here keeps the
tx count its configuration pins, given at the per-contract seam
(MythrilAnalyzer._analyze_one_contract) that the sequential and the
interleaved paths both call.

The counters read are taken with getattr(stats, key, None), so a program
that lacks one still runs the cell and the metric reading it is left
out."""

import time
from typing import Optional

from port_bench import generate, trace
from port_bench.common import RunRecord, apply_envelope, cpu_seconds, \
    percentile
from port_bench.reference import findings

# the SolverStatistics counters and timers this cell's metrics read
STAT_KEYS = ("prepare_wall", "interp_wall", "settle_wall",
             "device_dispatched_queries", "xcontract_windows",
             "xcontract_cones_packed", "interleave_handoffs",
             "interleave_switch_wall", "interleave_flushes",
             "interleave_flush_origins")


def _snapshot():
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    stats = SolverStatistics()
    return {key: getattr(stats, key, None) for key in STAT_KEYS}


def _difference(before, after):
    return {key: (None if before[key] is None or after[key] is None
                  else after[key] - before[key])
            for key in STAT_KEYS}


def _analyzer(disassembler, strategy: str, tx_counts: dict):
    from mythril_tpu_torch.core import MythrilAnalyzer

    class BatchAnalyzer(MythrilAnalyzer):
        """fire_lasers over a batch whose contracts keep their own tx
        counts."""

        def _analyze_one_contract(self, contract, modules, tx_count,
                                  stats=None):
            return super()._analyze_one_contract(
                contract, modules, tx_counts[contract.name], stats=stats)

    return BatchAnalyzer(disassembler, strategy=strategy)


def _batch(tasks, envelope, control: Optional[str]):
    """One fire_lasers over the batch: (start, done, CPU seconds,
    {contract name: sorted (swc, function, address) of its findings},
    the report's exceptions)."""
    from mythril_tpu_torch.core import MythrilDisassembler

    if len({task.name for task in tasks}) < len(tasks):
        raise ValueError("a batch holds a contract twice, so its report "
                         "cannot be split by contract name")
    disassembler = MythrilDisassembler()
    for task in tasks:
        disassembler.load_from_bytecode(task.code, name=task.name)
    analyzer = _analyzer(disassembler, envelope["strategy"],
                         {task.name: task.tx_count for task in tasks})
    cpu = cpu_seconds()
    start = time.monotonic()
    report = analyzer.fire_lasers(modules=envelope["modules"])
    done = time.monotonic()
    cpu = cpu_seconds() - cpu
    found = {task.name: [] for task in tasks}
    for issue in report.issues.values():
        found.setdefault(issue.contract, []).append(
            (issue.swc_id, issue.function, int(issue.address)))
    for name in found:
        found[name].sort()
        if control == "drop" and found[name]:
            # the control: each contract's report lost a finding
            found[name] = found[name][:-1]
    return start, done, cpu, found, list(report.exceptions)


def _tasks(source, seed: int, batch: int, index: int, label: str):
    return [source.task(seed, index * batch + k, label)
            for k in range(batch)]


def run(cell, seed: int, seconds: float, traced: bool, device: Optional[str],
        control: Optional[str] = None, clock=None) -> RunRecord:
    envelope, batch = cell.config["envelope"], int(cell.mix["batch"])
    source = generate.ContractSource(cell.config)
    apply_envelope(envelope, device)
    on_card = device is None
    if on_card:
        from mythril_tpu_torch.core import build_device_kernels

        build_device_kernels()
    _batch(_tasks(source, seed, batch, 0, "warmup"), envelope, control)

    record = RunRecord(setup_s=clock() if clock else None)
    capture = recorder = None
    if traced:
        from mythril_tpu_torch.observe import get_tracer

        get_tracer().enable(None)
        get_tracer().drain_events()
        recorder = trace.K1Recorder()
        recorder.install()
        if on_card:
            capture = trace.DeviceCapture()
            capture.start()
    before = _snapshot()
    t0 = time.monotonic()
    t0_ns = time.time_ns()
    end = t0 + seconds
    batches = []
    index = 0
    while True:
        tasks = _tasks(source, seed, batch, index, "stream")
        batches.append((tasks,) + _batch(tasks, envelope, control))
        index += 1
        if batches[-1][2] >= end:
            break
    elapsed = batches[-1][2] - t0
    stop_ns = time.time_ns()
    activity = capture.stop() if capture else None
    stats = _difference(before, _snapshot())
    if recorder is not None:
        recorder.uninstall()
    spans = []
    if traced:
        from mythril_tpu_torch.observe import get_tracer

        spans = trace.program_spans(get_tracer().drain_events())
        get_tracer().reset()
    if on_card:
        import torch

        record.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # a contract fails on its own findings, and with its whole batch when
    # the batch's report raised or holds findings of no contract in it
    wrong, failed, walls, cpu_total, contracts = [], 0, [], 0.0, 0
    for tasks, start, done, cpu, found, exceptions in batches:
        walls.append(done - start)
        cpu_total += cpu
        contracts += len(tasks)
        label = "+".join(f"{task.name}#{task.index}" for task in tasks)
        problems = [(task, findings.judge(task.expected,
                                          found.pop(task.name)))
                    for task in tasks]
        stray = sorted(name for name, issues in found.items() if issues)
        if exceptions or stray:
            wrong.append(f"batch {label}: {len(exceptions)} exception(s), "
                         f"findings of {stray} outside the batch")
            failed += len(tasks)
            continue
        for task, problem in problems:
            if problem is not None:
                wrong.append(f"{task.name}#{task.index}: {problem}")
                failed += 1
    stats["cpu_s"] = cpu_total
    record.notes.append(
        f"CPU over wall {cpu_total / sum(walls):.4f}; {len(batches)} "
        f"batches of {batch}, median wall "
        f"{percentile(walls, 0.5):.3f} s; a contract's seconds: "
        + ", ".join(f"{key} {stats[key] / contracts:.4f}"
                    for key in ("cpu_s", "prepare_wall", "interp_wall",
                                "settle_wall")))
    if spans:
        # every span's seconds summed by name; the slots' spans overlap
        # (a parked slot's park spans its siblings' turns)
        totals = {}
        for name, start_ns, end_ns in spans:
            totals[name] = totals.get(name, 0) + end_ns - start_ns
        record.notes.append("span seconds: " + ", ".join(
            f"{name} {ns / 1e9:.3f}" for name, ns in
            sorted(totals.items(), key=lambda item: -item[1])[:16]))
    record.end_to_end = {"contracts_per_hour": 3600.0 * contracts / elapsed}
    record.attempted = contracts
    record.failed = failed
    record.failures = wrong[:5]
    record.checks = {"wrong_reports": (failed, "<=", 0)}
    record.correct = not failed
    record.samples = walls
    record.items_run = contracts
    record.stats = stats
    if recorder is not None:
        record.k1_launches = recorder.launches
    if activity is not None:
        record.set_device(activity, spans, t0_ns, stop_ns)
    return record
