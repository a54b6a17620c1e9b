#!/usr/bin/env python3
"""Run the PyTorch port's batched device solve on one CUDA card.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --forms-only   # env, build and the timing phase

Phases, one JSON line each (any failure exits non-zero before the last
line):

  env     torch / CUDA versions, the card and its power limit;
  build   nvcc for the ragged round (mythril_tpu_torch/csrc/ragged_round.cu)
          and g++ for the host CDCL (native/sat.cpp), started together,
          into mythril_tpu_torch/_build/;
  slice   get_models_batch with solver_backend="gpu" on a window of 64
          sibling-path queries at 256 bits (the coalescing window cap):
          verdicts must equal the port's own host-CDCL verdicts, every
          model must satisfy its constraints, the device must find models
          and the kernel must have been launched (counts read around this
          phase only);
  kernel  the CUDA kernel against its plain PyTorch version on the card,
          bit for bit (x and found), on: a small seeded window of random
          cones; the same kind of window with two cones asserting local
          var 0 (the constant FALSE) as an extra root wanted TRUE; at the
          default capacities (64 lanes, var_cap 65536, cone_cap 128, 64
          steps) the two kinds of stream the slice launches, a cube stream
          (the deepest UNSAT cone replicated once per cube, with pinned
          extra roots) and the largest plain stream; and a window with one
          cone too large for the kernel's shared-memory path, so that its
          global-table path runs;
  timing  CUDA-event times after warm-up: the largest plain stream in three
          forms (the full round, walk_depth 0, steps 0), the cube stream,
          the global-path window at the slice's lanes and steps, the plain
          version, and the bound (the least time the card could take for
          the same work).

--forms-only times the same three streams with the host CDCL's verdicts
and no other phase. It calls only the round's interface (flatten_stream,
device_flat, run_round_ragged_kernel), so a copy of this script placed in
a checkout of an earlier version of the port times that version's kernel.

Then the {"kernels": [...]} line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. A copy of every JSON line goes to
chiprun_out/chip_smoke.jsonl.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

# one H100 SXM: HBM rate and the non-tensor 32-bit peak (NVIDIA's data
# sheet); the ragged round's work is 32-bit integer logic, for which the
# data sheet gives no separate rate, so the CUDA-core float32 rate is used
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
WINDOW = 64        # service/scheduler.py DEFAULT_COALESCE_MAX_RAGGED
SEED = 20261016
OUT_DIR = "chiprun_out"

_lines = []


def emit(record) -> None:
    line = json.dumps(record, sort_keys=False)
    print(line, flush=True)
    _lines.append(line)


def fail(message: str) -> int:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi_line() -> str:
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return done.stdout.strip().splitlines()[0]


# -- phases ---------------------------------------------------------------


def phase_build():
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.smt.solver import sat_backend

    results, errors = {}, []

    def run(name, fn):
        try:
            start = time.monotonic()
            out = fn()
            results[name] = (time.monotonic() - start, out)
        except Exception as error:  # reported below, then the run fails
            errors.append(f"{name}: {error}")

    threads = [threading.Thread(target=run, args=(name, fn)) for name, fn in
               (("nvcc", ragged_kernel.build_kernel),
                ("g++", sat_backend.get_native_lib))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    ptxas = [line.strip() for line in results["nvcc"][1]["ptxas"].splitlines()
             if "registers" in line or "smem" in line]
    emit({"phase": "build", "nvcc_s": round(results["nvcc"][0], 3),
          "gxx_s": round(results["g++"][0], 3), "ptxas": ptxas})


def _prepared_window(queries):
    """(query index, (num_vars, clauses, aig_roots)) of each non-trivial
    query."""
    from mythril_tpu_torch.smt.solver.frontend import Solver

    problems = []
    for qi, constraints in enumerate(queries):
        solver = Solver(timeout=30)
        solver.add(constraints)
        prep = solver._prepare([])
        if prep.trivial is None:
            problems.append(
                (qi, (prep.num_vars, prep.clauses, prep.aig_roots)))
    return problems


def phase_slice(device):
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.gpu import backend as backend_mod
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import get_models_batch
    from mythril_tpu_torch.support.workloads import sibling_window

    queries = sibling_window(smt, WINDOW, seed=SEED)
    stats = SolverStatistics()
    stats.enabled = True
    # None: the entry point's default device, the CUDA card
    device_arg = None if device.type == "cuda" else device

    def run(solver_backend):
        args.solver_backend = solver_backend
        args.torch_device = device_arg
        torch_sync(device)
        start = time.monotonic()
        results = get_models_batch(queries)
        torch_sync(device)
        return results, time.monotonic() - start

    # reference verdicts: the port's own host CDCL, no device (this first
    # run also blasts every query into the shared AIG)
    host, host_cold_s = run("cpu")

    backend = backend_mod.get_device_backend(device_arg)
    before = backend.stats()
    stats.reset()
    ragged_kernel.reset_launches()
    results, wall = run("gpu")  # the main path: counts read around it
    launches = ragged_kernel.launches
    counters = stats.as_dict()
    after = backend.stats()

    verdicts = [status for status, _model in results]
    host_verdicts = [status for status, _model in host]
    if verdicts != host_verdicts:
        raise AssertionError(f"verdicts differ from the host CDCL: "
                             f"{verdicts} vs {host_verdicts}")
    for (status, model), constraints in zip(results, queries):
        if status == "sat" and not model.satisfies(constraints):
            raise AssertionError("a device-path model fails its constraints")
    if counters["device_batch_hits"] <= 0:
        raise AssertionError("the device found no model")
    if launches <= 0 or after["kernel_launches"] <= before["kernel_launches"]:
        raise AssertionError("the ragged round kernel was never launched")

    def delta(key):
        return round(after[key] - before[key], 4)

    # warm walls in turns (device, host), then one profiled device run
    _results, wall_again = run("gpu")
    _results, host_s = run("cpu")
    busy = _device_busy(lambda: run("gpu"))
    emit({"phase": "slice", "queries": len(queries),
          "sat": verdicts.count("sat"), "unsat": verdicts.count("unsat"),
          "unknown": verdicts.count("unknown"), "wall_s": wall,
          "wall_again_s": wall_again, "host_cdcl_cold_s": host_cold_s,
          "host_cdcl_s": host_s,
          "device_batch_queries": counters["device_batch_queries"],
          "device_batch_hits": counters["device_batch_hits"],
          "cdcl_settles": counters["cdcl_settles"],
          "cap_rejects": counters["cap_rejects"],
          "cubes_dispatched": counters["cubes_dispatched"],
          "chunks": delta("batch_calls"), "rounds": delta("kernel_launches"),
          "kernel_launches": launches,
          "prepare_s": counters["prepare_wall"],
          "device_route_s": counters["route_device_seconds"],
          "pack_s": delta("pack_seconds"),
          "stream_assembly_upload_s": delta("ragged_seconds"),
          "round_loop_s": delta("solve_seconds"),
          "settle_s": counters["route_host_seconds"], **busy})
    return queries, verdicts, launches


def _device_busy(run_once) -> dict:
    """Device time by kernel over one warm run of the slice, from
    torch.profiler, against that run's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _results, wall = run_once()
    device_us = kernel_us = 0.0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", 0.0)
        device_us += us
        if "ragged_round" in event.key:
            kernel_us += us
    if device_us <= 0:
        return {"profiled_wall_s": wall, "device_busy_share": "not measured"}
    return {"profiled_wall_s": wall,
            "device_busy_s": device_us / 1e6,
            "ragged_round_device_s": kernel_us / 1e6,
            "device_busy_share": device_us / 1e6 / wall}


def torch_sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, repeats: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / repeats


def _bound(flat, v1, lanes, steps, caps):
    """Least time for one round: each input read once and each output
    written once over the HBM rate, against the 32-bit logic the gate
    stream and the root checks need over the CUDA-core rate (the walks,
    whose length depends on the data, are not counted: a lower bound).
    Of the var tables only var_cone is needed past the stream's `v1`
    variables (for the merge rule): every cone's pages lie below v1."""
    live_roots = int((flat.arrays["root_mask"] == 1).sum())
    needed = (5 * flat.num_gates + (flat.num_levels + 1)
              + 5 * v1 + caps.var_cap + 3 * live_roots) * 4
    moved = needed + lanes * caps.var_cap * 4 * 2 + lanes * caps.cone_cap
    ops = lanes * (steps + 1) * (3 * flat.num_gates + 2 * live_roots)
    byte_s, op_s = moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations", moved, ops)


def _compare(flat, x, seed, steps, walk_depth, caps):
    import torch

    from mythril_tpu_torch.gpu import ragged_kernel

    got_x, got_found = ragged_kernel.run_round_ragged_kernel(
        flat, x, seed, steps, walk_depth, caps)
    want_x, want_found = ragged_kernel.run_round_ragged_plain(
        flat, x, seed, steps, walk_depth, caps)
    torch_sync(x.device)
    if not (torch.equal(got_x, want_x) and torch.equal(got_found,
                                                        want_found)):
        raise AssertionError(
            f"kernel disagrees with its plain version: "
            f"{int((got_x != want_x).sum())} x cells, "
            f"{int((got_found != want_found).sum())} found cells")
    return max(int((got_x - want_x).abs().max()),
               int((got_found.int() - want_found.int()).abs().max()))


def _global_path_stream():
    """A cone too large for the kernel's shared-memory path (about 20,000
    variables) before two small ones, so both paths run in one launch."""
    from mythril_tpu_torch.gpu import circuit
    from mythril_tpu_torch.support.workloads import big_cone, random_cones

    rng = random.Random(SEED + 5)
    return circuit.RaggedStream(
        [(pc, ()) for pc in [big_cone(rng)] + random_cones(rng, 2)])


def _slice_streams(device, queries, verdicts):
    """The two kinds of stream the slice launches, at the default
    capacities: (caps, lanes, steps, cube stream, largest plain stream).

    The cube stream is built as the cube second pass builds it: an UNSAT
    cone replicated once per cube, each replica pinning its cube's inputs
    as extra roots (the cone with the most cubes, so the most replicas and
    pins). The plain stream is the window's chunk with the most gates."""
    from mythril_tpu_torch.gpu import backend as backend_mod
    from mythril_tpu_torch.gpu import circuit, ragged_kernel

    caps = ragged_kernel.kernel_caps()
    backend = backend_mod.get_device_backend(device)
    packed = [(qi, backend.pack_cone(p[2][0], p[2][1]), ())
              for qi, p in _prepared_window(queries)]
    packed = [entry for entry in packed if entry[1].ok]
    plans = [backend.cube_entries(pc, (), backend_mod.CUBE_VARS_DEFAULT,
                                  caps, backend_mod.RAGGED_STREAM_BYTES_DEFAULT)
             for qi, pc, _e in packed if verdicts[qi] == "unsat"
             and pc.num_levels >= backend_mod.CUBE_MIN_LEVELS_DEFAULT]
    entries = max(plans, key=len, default=[])
    if not entries:
        raise AssertionError("no UNSAT cone of the slice got a cube plan")
    cube = circuit.RaggedStream(entries)
    chunks, _rejected = backend.chunk_window(
        packed, caps, backend_mod.RAGGED_STREAM_BYTES_DEFAULT)
    chunk = max(chunks, key=lambda c: sum(pc.num_gates for _i, pc, _e in c))
    plain = circuit.RaggedStream([(pc, extra) for _i, pc, extra in chunk])
    lanes = ragged_kernel.pad_lanes(backend.num_restarts, caps)
    return caps, lanes, backend.CIRCUIT_STEPS, cube, plain


def _walk_depth(stream) -> int:
    from mythril_tpu_torch.gpu import circuit

    return min(stream.num_levels + 4, circuit.MAX_LEVELS)


def _stream_fields(stream, flat) -> dict:
    return {"cones": stream.num_cones, "vars": stream.v1,
            "gates": flat.num_gates, "levels": flat.num_levels}


def phase_kernel(device, queries, verdicts):
    import torch

    from mythril_tpu_torch.gpu import circuit, ragged_kernel
    from mythril_tpu_torch.support.workloads import random_cones

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    # 1. a small seeded window of random cones, at small capacities
    small_caps = ragged_kernel.KernelCaps(var_cap=4096, cone_cap=16,
                                          root_cap=16, lane_tile=4,
                                          cone_tile=4, block=32)
    window = [(pc, ()) for pc in random_cones(random.Random(SEED), 16)]
    stream = circuit.RaggedStream(window)
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, small_caps), device)
    x = circuit.init_inputs(gen, 8, small_caps.var_cap, device)
    small_err = _compare(flat, x, 7, 32, stream.num_levels + 4, small_caps)
    emit({"phase": "kernel", "window": "random-cones", "cones": 16,
          "lanes": 8, "steps": 32, "bit_identical": True,
          "max_abs_err": small_err})

    # 2. two cones of that window assert local var 0 wanted TRUE: a root
    # violated at every step whose walk ends on var 0 at once (the flip of
    # var 0 is private to its (lane, cone) and undone by the next simulate)
    var0 = [(pc, ((0, True),) if ci in (1, 3) else ())
            for ci, (pc, _extra) in enumerate(window)]
    stream = circuit.RaggedStream(var0)
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, small_caps), device)
    x = circuit.init_inputs(gen, 8, small_caps.var_cap, device)
    x[:, 0] = 1  # column 0 is not owned: the input's comes back
    var0_err = _compare(flat, x, 9, 32, stream.num_levels + 4, small_caps)
    emit({"phase": "kernel", "window": "var0-roots", "cones": 16,
          "var0_cones": [1, 3], "lanes": 8, "steps": 32,
          "bit_identical": True, "max_abs_err": var0_err})

    # 3. and 4. the slice's two kinds of stream, default capacities
    caps, lanes, steps, cube, plain = _slice_streams(device, queries,
                                                     verdicts)
    errs = {}
    for name, stream, seed in (("cube-stream", cube, 13),
                               ("slice-stream", plain, 11)):
        flat = ragged_kernel.device_flat(
            ragged_kernel.flatten_stream(stream, caps), device)
        x = circuit.init_inputs(gen, lanes, caps.var_cap, device)
        errs[name] = _compare(flat, x, seed, steps, _walk_depth(stream),
                              caps)
        emit({"phase": "kernel", "window": name,
              **_stream_fields(stream, flat), "lanes": lanes,
              "steps": steps, "caps": list(caps),
              "blocks": stream.num_cones
              * -(-lanes // ragged_kernel.LANES_PER_BLOCK),
              "global_path_cones": list(flat.cones.global_cones),
              "bit_identical": True, "max_abs_err": errs[name]})

    # 5. one cone past the shared-memory path beside two small ones, so
    # both paths run in one launch
    stream = _global_path_stream()
    big_vars = stream.pages[0][1]
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), device)
    if flat.cones.global_cones != (0,):
        raise AssertionError(f"the big cone ({big_vars} vars) should "
                             f"take the global-table path alone, got "
                             f"{flat.cones.global_cones}")
    x = circuit.init_inputs(gen, 8, caps.var_cap, device)
    big_err = _compare(flat, x, 17, 16, _walk_depth(stream), caps)
    emit({"phase": "kernel", "window": "global-path",
          **_stream_fields(stream, flat), "big_cone_vars": big_vars,
          "lanes": 8, "steps": 16, "smem_bytes": flat.cones.smem_bytes,
          "global_path_cones": list(flat.cones.global_cones),
          "bit_identical": True, "max_abs_err": big_err})
    return max(small_err, var0_err, big_err, *errs.values())


def phase_timing(device, queries, verdicts, with_plain=True):
    """CUDA-event times of the slice's largest plain stream in three forms,
    of its cube stream and of the global-path window, at the default
    capacities and the slice's lanes and steps (and of the plain version
    when `with_plain`); launches made here are not counted."""
    import torch

    from mythril_tpu_torch.gpu import circuit, ragged_kernel

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    caps, lanes, steps, cube, plain = _slice_streams(device, queries,
                                                     verdicts)
    launches_before = ragged_kernel.launches
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(plain, caps), device)
    walk_depth = _walk_depth(plain)
    x = circuit.init_inputs(gen, lanes, caps.var_cap, device)

    def kernel_ms(stream_flat, n_steps, depth):
        return _time_ms(lambda: ragged_kernel.run_round_ragged_kernel(
            stream_flat, x, 11, n_steps, depth, caps), repeats=5)

    full_ms = kernel_ms(flat, steps, walk_depth)
    no_walk_ms = kernel_ms(flat, steps, 0)
    no_steps_ms = kernel_ms(flat, 0, walk_depth)
    full_again_ms = kernel_ms(flat, steps, walk_depth)
    plain_ms = None
    if with_plain:
        plain_ms = _time_ms(lambda: ragged_kernel.run_round_ragged_plain(
            flat, x, 11, steps, walk_depth, caps), repeats=1)
    bound_ms, bound_by, moved, ops = _bound(flat, plain.v1, lanes, steps,
                                            caps)
    emit({"phase": "timing", "window": "slice-stream",
          **_stream_fields(plain, flat), "lanes": lanes, "steps": steps,
          "walk_depth": walk_depth, "ms": full_ms,
          "ms_repeat": full_again_ms, "no_walk_ms": no_walk_ms,
          "no_steps_ms": no_steps_ms, "walk_ms": full_ms - no_walk_ms,
          "sim_check_per_step_ms": (no_walk_ms - no_steps_ms) / steps,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": moved, "ops": ops})

    cube_flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(cube, caps), device)
    cube_ms = kernel_ms(cube_flat, steps, _walk_depth(cube))
    emit({"phase": "timing", "window": "cube-stream",
          **_stream_fields(cube, cube_flat), "lanes": lanes,
          "steps": steps, "ms": cube_ms})

    big = _global_path_stream()
    big_flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(big, caps), device)
    big_ms = kernel_ms(big_flat, steps, _walk_depth(big))
    emit({"phase": "timing", "window": "global-path",
          **_stream_fields(big, big_flat), "big_cone_vars": big.pages[0][1],
          "lanes": lanes, "steps": steps, "ms": big_ms,
          "no_walk_ms": kernel_ms(big_flat, steps, 0)})
    ragged_kernel.launches = launches_before
    return {"ms": full_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _host_verdicts(device, queries):
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import get_models_batch

    args.solver_backend = "cpu"
    args.torch_device = None if device.type == "cuda" else device
    return [status for status, _model in get_models_batch(queries)]


def forms_only(device) -> int:
    """Env, build and the timing phase alone (see the module note)."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.support.workloads import sibling_window

    phase_build()
    queries = sibling_window(smt, WINDOW, seed=SEED)
    phase_timing(device, queries, _host_verdicts(device, queries),
                 with_plain=False)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError as error:
        return fail(f"no torch: {error}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: needs a CUDA card")
    try:
        import mythril_tpu_torch  # noqa: F401
    except ImportError as error:
        return fail(f"the port is not importable from here: {error}")
    os.makedirs(OUT_DIR, exist_ok=True)
    device = torch.device("cuda", 0)
    try:
        smi = nvidia_smi_line()
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "nvidia_smi": smi})
        if "--forms-only" in sys.argv[1:]:
            forms_only(device)
            print(smi, flush=True)
            return 0
        phase_build()
        queries, verdicts, launches = phase_slice(device)
        max_err = phase_kernel(device, queries, verdicts)
        timing = phase_timing(device, queries, verdicts)
    except Exception as error:
        import traceback

        traceback.print_exc()
        return fail(str(error))
    emit({"kernels": [{
        "name": "ragged_round",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/ragged_round.cu",
        "replaces": "mythril_tpu/tpu/pallas_kernel.py:268",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]})
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w") as fd:
        fd.write("\n".join(_lines) + "\n")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
