"""The fork-pair members' prepare, traced: the `solver.cnf_prep` and
`solver.aig_opt` spans carry `deferred` (the query is one side of a
batched JUMPI fork pair, prepared under aig_opt's deferred-forcing sweep),
and cnf_prep's span its propagation rounds, units and literal
occurrences visited.

Run as a script, this file measures where the device path's prepare goes
with the batched frontier on, in the port and in the JAX package, on the
CPU:

    JAX_PLATFORMS=cpu python -m tests.test_torch_fork_prep

analyzes bench_inputs/corpus/xc_dispatch_a.hex at -t 1 (fork pruning on)
through each package's device path (the port's plain K1 round on the CPU,
the JAX package's device backend on its CPU platform) with the frontier
on and off, and through its host path with the frontier on, and prints
per leg the cnf_prep calls of the fork-pair members and of the other
queries: calls, clauses in, propagation rounds (the port only) and
seconds on the host clock."""

import importlib
import os
import sys
import time

import pytest

from mythril_tpu_torch import smt
from mythril_tpu_torch.observe.tracer import get_tracer
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.model import clear_caches, get_models_batch
from mythril_tpu_torch.support.workloads import fork_window


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_fork_pair_prepares_are_traced_as_deferred(monkeypatch, backend):
    """Two fork pairs through get_models_batch: on the device backend
    every side prepares under the deferred-forcing sweep and its spans
    say so; on the host backend none does. Every cnf_prep span that
    simplified its instance records the rounds and units it took and the
    literal occurrences its propagation read."""
    monkeypatch.setenv("MYTHRIL_GPU_CALIBRATE", "0")
    monkeypatch.setenv("MYTHRIL_GPU_RESTARTS", "8")
    monkeypatch.setenv("MYTHRIL_GPU_CIRCUIT_STEPS", "16")
    sets, pairs = fork_window(smt, 2, seed=7)
    args.reset()
    clear_caches()
    args.solver_backend = backend
    args.torch_device = "cpu"
    tracer = get_tracer()
    tracer.reset()
    tracer.enable(None)
    try:
        results = get_models_batch(sets, fork_pairs=pairs)
        events = tracer.events()
    finally:
        tracer.reset()
        args.reset()
        clear_caches()
    assert len(results) == len(sets)
    for name in ("solver.cnf_prep", "solver.aig_opt"):
        flags = [event["args"]["deferred"] for event in events
                 if event["name"] == name]
        assert len(flags) == len(sets), name
        assert set(flags) == {backend == "gpu"}, name
    for event in events:
        if event["name"] == "solver.cnf_prep" and "rounds" in event["args"]:
            assert event["args"]["rounds"] >= 1
            assert event["args"]["units"] >= 0
            assert event["args"]["visited"] >= event["args"]["units"]


# -- the measurement ------------------------------------------------------------

CONTRACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_inputs", "corpus", "xc_dispatch_a.hex")


def cnf_prep_calls(package, code_hex, backend, frontier):
    """(wall seconds, findings, [(deferred, clauses in, rounds or None,
    seconds)] per cnf_prep call) of one analyze through `package`."""
    from tests.torch_helpers import run_analyze

    cnf_prep = importlib.import_module(f"{package}.preanalysis.cnf_prep")
    aig_opt = importlib.import_module(f"{package}.preanalysis.aig_opt")
    preprocess = cnf_prep.preprocess_cnf
    calls = []

    def timed(num_vars, clauses, *rest, **kwargs):
        start = time.perf_counter()
        result = preprocess(num_vars, clauses, *rest, **kwargs)
        calls.append((aig_opt.defer_active(), len(clauses),
                      getattr(result, "rounds", None),
                      time.perf_counter() - start))
        return result

    device = {"device": "cpu"} if package == "mythril_tpu_torch" else {}
    cnf_prep.preprocess_cnf = timed
    try:
        start = time.perf_counter()
        report = run_analyze(package, code_hex, 1, backend, 600,
                             pruning_factor=1, frontier=frontier, **device)
        wall = time.perf_counter() - start
    finally:
        cnf_prep.preprocess_cnf = preprocess
    return wall, len(report.issues), calls


def main() -> int:
    os.environ.setdefault("MYTHRIL_GPU_CALIBRATE", "0")
    os.environ.setdefault("MYTHRIL_TPU_CALIBRATE", "0")
    with open(CONTRACT) as handle:
        code = handle.read().strip()
    legs = (("mythril_tpu", "tpu", True), ("mythril_tpu", "tpu", False),
            ("mythril_tpu", "cpu", True), ("mythril_tpu_torch", "gpu", True),
            ("mythril_tpu_torch", "gpu", False),
            ("mythril_tpu_torch", "cpu", True))
    for package, backend, frontier in legs:
        wall, findings, calls = cnf_prep_calls(package, code, backend,
                                               frontier)
        for deferred in (True, False):
            part = [call for call in calls if call[0] == deferred]
            rounds = [call[2] for call in part if call[2] is not None]
            print(f"{package} backend={backend} frontier={frontier} "
                  f"wall_s={wall:.3f} findings={findings} "
                  f"{'fork-pair members' if deferred else 'other queries'}: "
                  f"calls={len(part)} clauses={sum(c[1] for c in part)} "
                  f"rounds={sum(rounds) if rounds else 'n/a'} "
                  f"seconds={sum(c[3] for c in part):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
