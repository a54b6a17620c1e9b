"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It measures the PyTorch and CUDA port (mythril_tpu_torch) on the card: set
up (load, build or load the kernels, warm up), measure for --seconds,
judge every answer against the plain reference, and print one JSON line
last on standard output, with the numbers it compared last on standard
error. --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics from a traced window (torch.profiler, the port's span
tracer and counters). With no card, or fewer than the cell asks for, it
exits 2 and prints no result: it never falls back to the CPU.

--control NAME puts the cell's control in the program's place (the
reference with one guarantee broken), to show that the comparison fails
it; the benchmark's own runs never pass it."""

import argparse
import json
import sys
import time

from port_bench import common, spec
from port_bench.common import forbidden_modules


def measure(cell, seed: int, seconds: float, traced: bool,
            device=None, control=None, clock=None):
    """Run the cell's runner, runners/<the mix's kind>.py; device None is
    the card (the benchmark), "cpu" the kernels' plain versions (the CPU
    tests)."""
    import importlib

    runner = importlib.import_module("port_bench.runners."
                                     + cell.mix["kind"])
    return runner.run(cell, seed, seconds, traced, device, control=control,
                      clock=clock)


def result_line(cell, record, traced: bool, device_info: dict) -> dict:
    metrics = {}
    if traced:
        for metric in cell.per_layer:
            value = spec.reader(metric["name"])(record)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    else:
        for metric in cell.end_to_end:
            value = (record.setup_s if metric["name"] == "setup_s"
                     else record.end_to_end.get(metric["name"]))
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    device = dict(device_info, memory_peak_bytes=record.memory_peak_bytes)
    line = {"correct": record.correct, "attempted": record.attempted,
            "failed": record.failed, "metrics": metrics, "device": device}
    if traced and record.device is not None:
        device["busy_s"] = record.device["busy_s"]
        device["window_s"] = record.device["window_s"]
        line["breakdown"] = {"device_ops": record.device["device_ops"],
                             "idle_gaps": record.device["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit, "rule": rule}
                      for name, (value, rule, limit) in record.checks.items()}
    return line


def main(argv=None) -> int:
    started = common.process_start()
    parser = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", choices=("flip", "drop"))
    options = parser.parse_args(argv)
    cell = spec.load_cell(options.workload)
    spec.check_manifests()

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {options.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips}
    from port_bench import trace

    card = trace.power_limit()
    if card:
        device_info["card"] = card
    state = common.PrivateState()
    try:
        record = measure(cell, options.seed, options.seconds,
                         bool(options.trace), control=options.control,
                         clock=lambda: time.monotonic() - started)
    finally:
        state.close()
    return report(cell, record, bool(options.trace), device_info)


def report(cell, record, traced: bool, device_info: dict) -> int:
    """Print the numbers compared on standard error and the result line
    last on standard output, 0; or, when this process or a worker of the
    run holds JAX or the JAX package, name what was found and print no
    result, 3."""
    found = sorted(set(forbidden_modules()) | set(record.forbidden))
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, record, traced, device_info)
    for failure in record.failures:
        print(f"port_bench: wrong: {failure}", file=sys.stderr)
    print("port_bench: item walls (s) " + " ".join(
        f"{wall:.3f}" for wall in record.samples), file=sys.stderr)
    for note in record.notes:
        print(f"port_bench: {note}", file=sys.stderr)
    if traced and "card" in device_info:
        print(f"port_bench: card {device_info['card']}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']} {check['rule']} "
              f"{check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
