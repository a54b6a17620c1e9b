"""Each cell end to end on the CPU at a tiny size (the port's kernels in
their plain versions), with its generator, its reference and its layer
readers; the measuring path refuses to report device metrics there and
the command refuses to run at all. The control and the faults each cell
can have are seen to make `correct` false."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import run, spec
from port_bench.tests import faults

DEVICE_METRICS = {"device_idle_share.pool", "device_idle_share.windows",
                  "k1_roofline"}


def _small(name, **mix):
    cell = spec.load_cell(name)
    return cell._replace(mix=dict(cell.mix, **mix))


def _measure(cell, traced=True, control=None, seconds=1.0):
    record = run.measure(cell, 2 ** 31 + 3, seconds, traced, device="cpu",
                         control=control, clock=lambda: 1.0)
    return record, run.result_line(cell, record, traced, {"platform": "cpu"})


@pytest.mark.parametrize("name", ["upstream-siblings64"])
def test_window_cell_on_the_cpu(cpu_settings, name):
    cell = _small(name, window=8)
    record, line = _measure(cell)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 8
    assert line["checks"]["wrong_answers"]["value"] == 0
    reported = set(line["metrics"])
    assert {"prepare_ms_per_query", "window_wall_p95_ms",
            "device_hit_rate"} <= reported
    assert not reported & DEVICE_METRICS   # no device trace on the CPU
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert record.k1_launches                # K1's plain round ran
    _record, plain = _measure(cell, traced=False)
    assert set(plain["metrics"]) == {"queries_per_s", "setup_s"}
    assert run.forbidden_modules() == []


def _broken_solve(monkeypatch, alter):
    from mythril_tpu_torch.service import scheduler

    original = scheduler.CoalescingScheduler.solve_batch

    def solve_batch(self, constraint_sets, crosscheck=None):
        return alter(original(self, constraint_sets, crosscheck))

    monkeypatch.setattr(scheduler.CoalescingScheduler, "solve_batch",
                        solve_batch)


def _flip_model(outcomes):
    from mythril_tpu_torch.smt.model import Model

    out = list(outcomes)
    for k, (status, model) in enumerate(out):
        if status == "sat":
            assignment = dict(model.assignment)
            assignment["calldata_0"] = assignment.get("calldata_0", 0) \
                ^ (1 << 224)
            out[k] = (status, Model(assignment))
            break
    return out


def _drop_half(outcomes):
    half = len(outcomes) // 2
    return list(outcomes[:half]) + [("unknown", None)] * (len(outcomes)
                                                          - half)


def _flip_verdict(outcomes):
    out = list(outcomes)
    k = next(k for k, (status, _m) in enumerate(out) if status == "unsat")
    out[k] = ("sat", None)
    return out


@pytest.mark.parametrize("alter", [_flip_model, _drop_half, _flip_verdict],
                         ids=["model-altered", "half-left-out",
                              "verdict-altered"])
def test_window_faults_fail(cpu_settings, monkeypatch, alter):
    _broken_solve(monkeypatch, alter)
    _record, line = _measure(_small("upstream-siblings64", window=8),
                             traced=False)
    assert line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] >= 1


def test_window_control_fails(cpu_settings):
    _record, line = _measure(_small("upstream-siblings64", window=8),
                             traced=False, control="flip")
    assert line["correct"] is False
    # every SAT answer of every window fails (7 of each 8)
    assert line["checks"]["wrong_answers"]["value"] \
        == 7 * line["attempted"] // 8


def test_pool_cell_on_the_cpu(cpu_settings):
    cell = _small("upstream-pool4", workers=1)
    record, line = _measure(cell)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"contract_wall_p95_s",
                                    "cpu_s_per_contract",
                                    "interp_s_per_contract",
                                    "prepare_s_per_contract",
                                    "cdcl_settle_s_per_contract"}
    assert record.items_run >= 1 and record.forbidden == []


def test_a_worker_that_loads_jax_prints_no_result(cpu_settings, monkeypatch,
                                                  capsys):
    from port_bench.runners import analyze_pool

    monkeypatch.setattr(analyze_pool, "_worker", faults.jax_worker)
    cell = _small("upstream-pool4", workers=1)
    record = run.measure(cell, 2 ** 31 + 5, 3.0, False, device="cpu",
                         clock=lambda: 1.0)
    assert record.correct is True and record.forbidden == ["jax"]
    assert run.forbidden_modules() == []     # this process holds none
    capsys.readouterr()
    assert run.report(cell, record, False, {"platform": "cpu"}) == 3
    out, err = capsys.readouterr()
    assert out == "" and "loaded jax" in err
    record.forbidden = []                    # the same record, clean
    assert run.report(cell, record, False, {"platform": "cpu"}) == 0
    assert json.loads(capsys.readouterr().out)["correct"] is True


def test_a_new_runner_needs_no_edit(tmp_path, monkeypatch):
    """A traffic kind added as a file of its own under runners/ is run by
    name, with no other file touched."""
    from port_bench import runners

    (tmp_path / "throwaway_echo.py").write_text(
        "from port_bench.common import RunRecord\n\n\n"
        "def run(cell, seed, seconds, traced, device, control=None,\n"
        "        clock=None):\n"
        "    record = RunRecord(setup_s=clock())\n"
        "    record.correct = True\n"
        "    record.end_to_end = {'queries_per_s': float(seed)}\n"
        "    return record\n")
    monkeypatch.setattr(runners, "__path__",
                        [*runners.__path__, str(tmp_path)])
    cell = spec.load_cell("upstream-siblings64")._replace(
        mix={"kind": "throwaway_echo"})
    try:
        _record, line = _measure(cell, traced=False)
    finally:
        sys.modules.pop("port_bench.runners.throwaway_echo", None)
    assert line["correct"] is True
    assert line["metrics"]["queries_per_s"]["value"] == 2 ** 31 + 3


@pytest.mark.parametrize("worker", [faults.altered_worker,
                                    faults.half_worker],
                         ids=["finding-altered", "half-left-out"])
def test_pool_faults_fail(cpu_settings, monkeypatch, worker):
    from port_bench.runners import analyze_pool

    monkeypatch.setattr(analyze_pool, "_worker", worker)
    _record, line = _measure(_small("upstream-pool4", workers=1),
                             traced=False, seconds=3.0)
    assert line["correct"] is False
    assert line["checks"]["wrong_reports"]["value"] >= 1


def test_pool_control_fails(cpu_settings):
    _record, line = _measure(_small("upstream-pool4", workers=1),
                             traced=False, control="drop")
    assert line["correct"] is False


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "upstream-siblings64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 2 and done.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["upstream-siblings64", "upstream-pool4"])
def test_a_short_run_on_the_card(cuda_card, name):
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("MYTHRIL_GPU_")}
    done = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", str(2 ** 33 + 1), "--seconds", "5", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900, env=env)
    assert done.returncode == 0, done.stderr[-2000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["busy_s"] > 0
