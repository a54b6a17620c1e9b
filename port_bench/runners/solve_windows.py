"""The solve_windows runner: coalesced windows of sibling-path queries sent
back to back, one in flight, through the port's batched solver service
(mythril_tpu_torch.service.scheduler.solve_batch), in this process.

Set-up applies the configuration's envelope, builds and loads the kernels,
and solves one window of a warm-up stream (which calibrates the router and
holds every shape of the mix), then builds the port's terms of the windows
the run will send. The measured window sends them until `seconds` have
passed; the window in flight then is finished, and the rate is every query
answered over all the time up to the last answer, so no window is cut. After
the window the program's state is dropped and the reference judges every
answer: a model must satisfy its query, an UNSAT verdict must meet the
reference's proof, and no query may go unanswered."""

import gc
import math
import time
from typing import Optional

from port_bench import generate, trace
from port_bench.common import (RunRecord, apply_envelope, cpu_seconds,
                               stat_snapshot)
from port_bench.reference import words

WARMUP_WINDOWS = 1


def _reference_answers(queries, flip_bit: int):
    """The control: the reference in the program's place, each model the
    planted witness with one bit of the selector word flipped (a broken
    guarantee: the model no longer satisfies its query)."""
    out = []
    for query in queries:
        if query.unsat:
            out.append(("unsat", None))
            continue
        model = dict(query.witness)
        model["calldata_0"] ^= 1 << flip_bit
        out.append(("sat", model))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device: Optional[str],
        control: Optional[str] = None, clock=None) -> RunRecord:
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.service.scheduler import get_scheduler
    from mythril_tpu_torch.support.model import clear_caches

    mix, envelope = cell.mix, cell.config["envelope"]
    apply_envelope(envelope, device)
    on_card = device is None
    if on_card:
        from mythril_tpu_torch.core import build_device_kernels

        build_device_kernels()

    def solve(terms):
        return get_scheduler().solve_batch(terms)

    warm_walls = []
    for index in range(WARMUP_WINDOWS):
        queries = generate.query_window(mix, seed, -1 - index)
        terms = [generate.port_terms(smt, q.atoms) for q in queries]
        start = time.monotonic()
        solve(terms)
        warm_walls.append(time.monotonic() - start)
    # the windows this run will send, built before the clock starts
    planned = min(4000, math.ceil(2 * seconds / max(warm_walls[-1], 1e-3))
                  + 3)
    windows = []
    for index in range(planned):
        queries = generate.query_window(mix, seed, index)
        windows.append((queries, [generate.port_terms(smt, q.atoms)
                                  for q in queries]))

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
    before = stat_snapshot()
    cpu = cpu_seconds()
    t0 = time.monotonic()
    t0_ns = time.time_ns()
    end = t0 + seconds
    solved, walls = [], []
    index = 0
    while True:
        if index < len(windows):
            queries, terms = windows[index]
        else:  # past the plan: built inside the window
            queries = generate.query_window(mix, seed, index)
            terms = [generate.port_terms(smt, q.atoms) for q in queries]
        start = time.monotonic()
        if control == "flip":
            outcomes = _reference_answers(queries, generate.WIDTH - 32)
        else:
            outcomes = solve(terms)
        done = time.monotonic()
        solved.append((queries, outcomes))
        walls.append(done - start)
        index += 1
        if done >= end:
            break
    elapsed = done - t0
    cpu = cpu_seconds() - cpu
    stop_ns = time.time_ns()
    activity = capture.stop() if capture else None
    stats = {key: value - before[key]
             for key, value in stat_snapshot().items()}
    if recorder is not None:
        recorder.uninstall()
    spans = []
    if traced:
        from mythril_tpu_torch.observe import get_tracer

        spans = trace.program_spans(get_tracer().drain_events())
        get_tracer().reset()
    record.memory_peak_bytes = _memory_peak(on_card)

    # the program's answers, read out; then its state goes
    answers = []
    for queries, outcomes in solved:
        for query, (status, model) in zip(queries, outcomes):
            values = None
            if model is not None:
                assignment = getattr(model, "assignment", model)
                values = {name: assignment[name]
                          for name in generate.variables(query.atoms)
                          if name in assignment}
            answers.append((query, status, values))
    del solved, windows
    clear_caches()
    gc.collect()

    wrong, answered = [], 0
    for query, status, values in answers:
        verdict = words.decide(query.atoms, query.witness)
        problem = words.judge(query.atoms, verdict, status, values)
        if problem is not None:
            wrong.append(problem)
        else:
            answered += 1
    record.end_to_end = {"queries_per_s": answered / elapsed}
    record.attempted = len(answers)
    record.failed = len(wrong)
    record.failures = wrong[:5]
    record.checks = {"wrong_answers": (len(wrong), "<=", 0)}
    record.correct = not wrong
    record.samples = walls
    record.items_run = len(walls)
    record.queries_run = len(answers)
    record.stats = stats
    record.notes.append(f"CPU over wall {cpu / elapsed:.4f}")
    if recorder is not None:
        record.k1_launches = recorder.launches
    if activity is not None:
        record.set_device(activity, spans, t0_ns, stop_ns)
    return record


def _memory_peak(on_card: bool) -> int:
    if not on_card:
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())

