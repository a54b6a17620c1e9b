"""The analyze_pool runner: a closed loop of warm analyze workers sharing
the card, as `myth analyze --jobs N` runs them.

Each worker is a spawned process that applies the configuration's envelope,
loads the kernels this process built, and runs one uncounted warm-up
analysis (which also calibrates its router). In the measured window each
worker calls MythrilAnalyzer.fire_lasers on the next contract of the
seeded stream as soon as its last one is done, until the window's
`seconds` have passed; the contract each worker has in hand then is
finished. The rate sums each worker's contracts over its own time up to
its last one, so every contract analyzed and all the time each worker
spent count, and none is cut. The reference then holds every report
against the pinned findings (reference/findings.py). A worker, when
stopped, reports its memory peak and the forbidden modules it holds
(common.FORBIDDEN): the result line is never printed over a worker that
loaded JAX or the JAX package (run.report)."""

import multiprocessing
import multiprocessing.connection
import time
from multiprocessing import resource_tracker
from typing import Optional

from port_bench import generate, trace
from port_bench.common import (RunRecord, apply_envelope, cpu_seconds,
                               forbidden_modules, percentile, stat_snapshot)
from port_bench.reference import findings

READY_TIMEOUT_S = 600.0   # a worker's start, warm-up included
LATE_S = 120.0            # a contract still running this long past the end


def _analyze(task, envelope, control: Optional[str]):
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(task.code)
    analyzer = MythrilAnalyzer(disassembler, strategy=envelope["strategy"])
    before = stat_snapshot()
    cpu = cpu_seconds()
    start = time.monotonic()
    report = analyzer.fire_lasers(modules=envelope["modules"],
                                  transaction_count=task.tx_count)
    done = time.monotonic()
    stats = {key: value - before[key]
             for key, value in stat_snapshot().items()}
    stats["cpu_s"] = cpu_seconds() - cpu
    found = sorted((issue.swc_id, issue.function, int(issue.address))
                   for issue in report.issues.values())
    if control == "drop" and found:
        found = found[:-1]   # the control: a report that lost a finding
    return (task.index, start, done, found, len(report.exceptions), stats)


def _worker(conn, envelope, device, warm_task, control):
    """A warm engine: set up, warm up, then analyze what the parent sends
    until it says stop; then report its memory peak and any forbidden
    module it holds."""
    apply_envelope(envelope, device)
    if device is None:
        from mythril_tpu_torch.core import build_device_kernels
        from mythril_tpu_torch.gpu.device import resolve_device

        resolve_device(None)
        build_device_kernels()   # loads what the parent built
    warm = _analyze(warm_task, envelope, control)
    conn.send(("ready", warm))
    capture = None
    while True:
        message = conn.recv()
        if message[0] == "task":
            conn.send(("done", _analyze(message[1], envelope, control)))
        elif message[0] == "trace_on":
            from mythril_tpu_torch.observe import get_tracer

            get_tracer().enable(None)
            get_tracer().drain_events()
            if device is None:
                capture = trace.DeviceCapture()
                capture.start()
            conn.send(("tracing",))
        elif message[0] == "trace_off":
            from mythril_tpu_torch.observe import get_tracer

            activity = capture.stop() if capture else None
            spans = trace.program_spans(get_tracer().drain_events())
            get_tracer().reset()
            conn.send(("trace", activity, spans))
        else:
            peak = 0
            if device is None:
                import torch

                peak = int(torch.cuda.max_memory_allocated())
            conn.send(("stopped", peak, forbidden_modules()))
            conn.close()
            return


def _expect(conn, kind: str, timeout: float):
    if not conn.poll(timeout):
        raise RuntimeError(f"a worker sent no {kind!r} in {timeout} s")
    message = conn.recv()
    if message[0] != kind:
        raise RuntimeError(f"a worker sent {message[0]!r}, not {kind!r}")
    return message


def run(cell, seed: int, seconds: float, traced: bool, device: Optional[str],
        control: Optional[str] = None, clock=None) -> RunRecord:
    envelope, mix = cell.config["envelope"], cell.mix
    source = generate.ContractSource(cell.config)
    apply_envelope(envelope, device)
    if device is None:
        # every kernel and the host CDCL built here, once, before any
        # worker starts: the workers only load them
        from mythril_tpu_torch.core import build_device_kernels
        from mythril_tpu_torch.smt.solver import sat_backend

        build_device_kernels()
        sat_backend.get_native_lib()
    context = multiprocessing.get_context("spawn")
    workers = []
    try:
        for slot in range(int(mix["workers"])):
            parent, child = context.Pipe()
            process = context.Process(
                target=_worker, name=f"port_bench-worker-{slot}",
                args=(child, envelope, device,
                      source.task(seed, slot, "warmup"), control))
            process.start()
            child.close()
            workers.append((process, parent))
        for _process, conn in workers:
            _expect(conn, "ready", READY_TIMEOUT_S)
        if traced:
            for _process, conn in workers:
                conn.send(("trace_on",))
            for _process, conn in workers:
                _expect(conn, "tracing", READY_TIMEOUT_S)
        return _window(seed, seconds, traced, device, source, workers, clock)
    finally:
        for process, conn in workers:
            if process.is_alive():
                process.terminate()
            process.join(30)
            conn.close()
        # the resource tracker that spawning started: stopped and waited
        # for here, or it outlives the run as an unreaped process
        resource_tracker._resource_tracker._stop()


def _window(seed, seconds, traced, device, source, workers, clock):
    record = RunRecord(setup_s=clock() if clock else None)
    t0 = time.monotonic()
    t0_ns = time.time_ns()
    end = t0 + seconds
    tasks, results, ran_on = {}, {}, {}
    busy = {}
    next_index = 0

    def send(conn):
        nonlocal next_index
        task = source.task(seed, next_index)
        tasks[task.index] = task
        busy[conn] = task.index
        ran_on[task.index] = conn
        conn.send(("task", task))
        next_index += 1

    for _process, conn in workers:
        send(conn)
    while busy:
        if time.monotonic() > end + LATE_S:
            break
        for conn in multiprocessing.connection.wait(list(busy), timeout=1.0):
            message = conn.recv()
            if message[0] != "done":
                raise RuntimeError(f"a worker sent {message[0]!r}")
            results[message[1][0]] = message[1]
            del busy[conn]
            if time.monotonic() < end:
                send(conn)
    stop_ns = time.time_ns()
    activity, spans = [], []
    for process, conn in workers:
        if conn in busy:       # late: left running, counted as failed
            process.terminate()
            continue
        if traced:
            conn.send(("trace_off",))
            _kind, worker_activity, worker_spans = _expect(conn, "trace",
                                                           LATE_S)
            activity.extend(worker_activity or [])
            spans.extend(worker_spans)
    peak, forbidden = 0, set()
    for process, conn in workers:
        if process.is_alive() and conn not in busy:
            conn.send(("stop",))
            _kind, worker_peak, worker_forbidden = _expect(conn, "stopped",
                                                           LATE_S)
            peak += worker_peak
            forbidden.update(worker_forbidden)
            process.join(60)

    wrong, walls, per_worker, by_name = [], [], {}, {}
    stats = {}
    for index, task in sorted(tasks.items()):
        if index not in results:
            wrong.append(f"{task.name}#{index}: no report")
            continue
        _index, start, done, found, errors, task_stats = results[index]
        for key, value in task_stats.items():
            stats[key] = stats.get(key, 0) + value
        problem = findings.judge(task.expected, found, errors)
        if problem is not None:
            wrong.append(f"{task.name}#{index}: {problem}")
        walls.append(done - start)
        by_name.setdefault(task.name, []).append((done - start,
                                                  task_stats["cpu_s"]))
        count, last = per_worker.get(ran_on[index], (0, t0))
        per_worker[ran_on[index]] = (count + 1, max(last, done))
    record.memory_peak_bytes = peak
    record.forbidden = sorted(forbidden)
    if walls:
        record.notes.append(
            f"workers' CPU over wall {stats['cpu_s'] / sum(walls):.4f}; "
            "median wall and CPU (s) by contract: " + "; ".join(
                f"{name} {len(pairs)} "
                f"{percentile([w for w, _c in pairs], 0.5):.3f} "
                f"{percentile([c for _w, c in pairs], 0.5):.3f}"
                for name, pairs in sorted(by_name.items())))
    record.end_to_end = {"contracts_per_hour": 3600.0 * sum(
        count / (last - t0) for count, last in per_worker.values())}
    record.attempted = len(tasks)
    record.failed = len(wrong)
    record.failures = wrong[:5]
    record.checks = {"wrong_reports": (len(wrong), "<=", 0)}
    record.correct = not wrong and bool(results)
    record.samples = walls
    record.items_run = len(results)
    record.stats = stats
    if traced and device is None:
        record.set_device(activity, spans, t0_ns, stop_ns)
    return record
