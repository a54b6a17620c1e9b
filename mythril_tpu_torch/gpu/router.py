"""Adaptive device-solver routing: the ragged path of mythril_tpu.tpu.router.

get_models_batch hands each window of prepared queries to dispatch(),
which decides per cone where it is solved and ships the device-bound ones
to the ragged round (backend.try_solve_batch_ragged):

  admission   the JAX package's rules for its Pallas round, of which K1 is
              the port: a cone at most MYTHRIL_GPU_HOST_DIRECT_LEVELS deep
              (default 24) goes straight to the host CDCL ("tiny"); one
              whose estimated stream bytes alone bust
              MYTHRIL_GPU_RAGGED_STREAM_BYTES (default 48 MiB), or that
              exceeds a kernel capacity, is a cap reject; every other cone
              rides the device. There is no per-cone cost veto.
  components  a query whose rewritten AIG splits into variable-disjoint
              components (preanalysis/aig_partition.py) dispatches each
              component as its own unit; trivial components settle inline,
              tiny ones on the host CDCL in-router, and a recomposed model
              is returned only after it passes the whole query's clause
              check.
  fork lane   the two sides of one batched JUMPI fork whose root sets
              differ by exactly a literal and its negation pack ONE shared
              cone; each side pins the fork literal as an extra root.
  chunking    admitted units (level-bucket order) chunk greedily into
              streams: a chunk closes when the next cone would bust the
              stream's byte budget, the kernel's variable space or cone
              slots, or push the estimated round past the chunk budget
              (0.8 x min(round budget, dispatch deadline)). The estimate
              charges the calibrated kernel rate over the bucketed
              combined rectangle.
  calibration once per process (persisted under solve_cache "disk"): K1
              on a two-cone calibration stream, timed with CUDA events
              over CAL_STEPS after one warm-up launch (perf_counter for
              the plain round on the CPU) — kernel_cells_s; plus pack,
              stream assembly + upload and host-CDCL settle rates.
              MYTHRIL_GPU_CALIBRATE=0 skips it.
  breaker     zero-hit device seconds charge a waste budget
              (MYTHRIL_GPU_DEVICE_MAX_WASTE; 20 s on a card, 8 s on the
              CPU); past it the device path is off until a cooldown admits
              one re-probe (resilience/breaker.py).
  deadline    each dispatch gets min(MYTHRIL_GPU_DEVICE_DEADLINE — 6 s on
              a card, 2.5 s on the CPU — 0.6 x the query timeout); the
              round loop checks it between rounds. Each stream's backend
              call runs on the deadline runner (resilience/deadline.py)
              behind the device.dispatch fault site, and is abandoned at
              its remaining budget plus MYTHRIL_GPU_STAGE_GRACE (default
              max(round budget, 2 s)): a call that never returns becomes
              the recorded DeviceFault below, not a hang.
  evidence    on device "cpu" the plain round serializes on the host, so
              the router runs the JAX package's evidence profile: 8
              restart lanes, 32-step rounds, cube width 3 and at most
              MYTHRIL_GPU_RAGGED_WINDOW_CAP (default 4) streams per
              process.

Differences from the JAX package, on purpose: an exception from the
kernel, its build or the device, an injected fault at device.dispatch or
device.calibrate, and a dispatch past its hard deadline propagate to the
caller as a recorded DeviceFault (no host fallback; the breaker sees only
zero-hit waste). Dispatch is always ragged: the bucketed path (its
admission, try_solve_batch_circuit and the switch between the two) waits
for K3.
"""

import contextlib
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.gpu import circuit, ragged_kernel
from mythril_tpu_torch.gpu.backend import (
    CUBE_MIN_LEVELS_DEFAULT,
    CUBE_VARS_DEFAULT,
    RAGGED_STREAM_BYTES_DEFAULT,
    DeviceSolverBackend,
    get_device_backend,
    shape_bucket,
)
from mythril_tpu_torch.gpu.device import clear_fault, record_fault
from mythril_tpu_torch.observe.tracer import span as trace_span
from mythril_tpu_torch.preanalysis import aig_partition
from mythril_tpu_torch.resilience import maybe_inject, run_with_deadline
from mythril_tpu_torch.resilience import breaker as breaker_mod
from mythril_tpu_torch.resilience.breaker import StageBreaker
from mythril_tpu_torch.support.env import env_float

log = logging.getLogger(__name__)

# the cone class the routing layer guarantees admission for (the measured
# production analyze cones: 513-540 levels, ~530k cells); a cap reject
# inside it is counted apart (cap_rejects_floor must stay 0)
LEVEL_CAP_FLOOR = 640
CELL_FLOOR = 1 << 20
CAL_STEPS = 8  # micro-calibration round length (tiny on purpose)
ROUND_BUDGET_S = 4.0  # device seconds one stream's round may plan for


class _Unit:
    """One device-dispatch unit: a whole monolithic query, one projected
    component of a partitioned query, or one SIDE of a fork pair (shared
    base cone + the fork literal pinned via extra roots)."""

    __slots__ = ("qi", "component", "pc", "problem", "comp_dense",
                 "resolved", "extra", "fork", "origin")

    def __init__(self, qi, component, pc, problem, comp_dense=None,
                 extra=(), fork=False, origin=None):
        self.qi = qi
        self.component = component  # AIGComponent or None (monolith)
        self.pc = pc
        self.problem = problem      # (num_vars, clauses, aig_roots)
        self.comp_dense = comp_dense
        self.resolved = False
        self.extra = tuple(extra)   # RaggedStream extra assumption roots
        self.fork = fork            # fork-side feasibility cone
        self.origin = origin        # contract tag (cross-contract windows)


class _SplitState:
    """Merge state of one partitioned query: trivial components write
    their literals directly, device/host-solved components merge their
    sub-models, and the recomposed assignment only stands after passing
    the full-query clause check."""

    __slots__ = ("merged", "units", "host")

    def __init__(self, num_vars: int):
        self.merged = [False] * (num_vars + 1)
        self.units: List[_Unit] = []   # non-trivial components
        self.host: List[_Unit] = []    # settle on the host CDCL in-router


class QueryRouter:
    """Process-global routing state over one DeviceSolverBackend."""

    # evidence-mode work profile for the CPU: restart lanes serialize on
    # the host core, so the plain round runs 8 lanes x 32 steps
    CPU_PROFILE_RESTARTS = 8
    CPU_PROFILE_STEPS = 32

    def __init__(self, backend: DeviceSolverBackend):
        self.backend = backend
        # measured rates (kernel_cells_s plus the stage rates); empty
        # until calibrated or when calibration is off
        self._rates = {}
        self.calibration_seconds = 0.0
        self._calibrated = False
        self._breaker = StageBreaker("device.dispatch")
        self.round_budget_s = ROUND_BUDGET_S
        self.max_waste_s = env_float("MYTHRIL_GPU_DEVICE_MAX_WASTE", -1.0)
        self.host_direct_levels = int(
            env_float("MYTHRIL_GPU_HOST_DIRECT_LEVELS", 24))
        self.ragged_stream_budget = int(env_float(
            "MYTHRIL_GPU_RAGGED_STREAM_BYTES", RAGGED_STREAM_BYTES_DEFAULT))
        # evidence-mode streams per process (a chunked window spends one
        # per stream: the launch sequence is the serialized wall)
        self.ragged_window_cap = int(
            env_float("MYTHRIL_GPU_RAGGED_WINDOW_CAP", 4))
        self.ragged_windows = 0
        self.cube_min_levels = int(env_float("MYTHRIL_GPU_CUBE_MIN_LEVELS",
                                             CUBE_MIN_LEVELS_DEFAULT))

    def _evidence_mode(self) -> bool:
        """True where the plain round serializes on the host (device
        "cpu"): the device path still fires, under the evidence profile
        and the per-process stream cap."""
        return self.backend.device.type == "cpu"

    def _platform(self) -> str:
        """The calibration cache's platform key: the device type, and the
        card's name on CUDA."""
        device = self.backend.device
        if device.type == "cuda":
            return "cuda:" + torch.cuda.get_device_name(device)
        return device.type

    def _waste_budget(self) -> float:
        if self.max_waste_s >= 0:
            # an EXPLICIT 0 means zero tolerance: the breaker treats a 0.0
            # budget as unbudgeted, so map it to an epsilon
            return self.max_waste_s or 1e-9
        return 8.0 if self._evidence_mode() else 20.0

    def dispatch_deadline(self) -> float:
        """Device seconds one dispatch may burn (checked between rounds)."""
        default = 2.5 if self._evidence_mode() else 6.0
        return env_float("MYTHRIL_GPU_DEVICE_DEADLINE", default)

    def deadline_grace(self) -> float:
        """Slack past the dispatch budget before the hard deadline fires:
        the round loop honours the budget between rounds, so a healthy
        backend returns within budget plus one round; only a call that
        stopped returning reaches the hard deadline."""
        return env_float("MYTHRIL_GPU_STAGE_GRACE",
                         max(self.round_budget_s, 2.0))

    def _profile_steps(self) -> int:
        """Round length the active profile runs."""
        if self._evidence_mode():
            return self.CPU_PROFILE_STEPS
        return self.backend.CIRCUIT_STEPS

    def _profile_restarts(self) -> int:
        """Restart lanes the active profile dispatches (and calibration
        measures) with."""
        restarts = self.backend.num_restarts
        if self._evidence_mode():
            restarts = min(restarts, self.CPU_PROFILE_RESTARTS)
        return restarts

    def cube_vars(self) -> int:
        """Cube-and-conquer split width k (2^k cubes per hard cone)."""
        return int(env_float("MYTHRIL_GPU_CUBE_VARS",
                             3 if self._evidence_mode()
                             else CUBE_VARS_DEFAULT))

    # -- calibration ----------------------------------------------------------

    def _calibrate(self) -> None:
        """Measure the rates once per process, or load the persisted entry
        (service/calibration.py). A kernel, build or device error raises:
        the measurement times K1 itself."""
        if self._calibrated:
            return
        self._calibrated = True
        if os.environ.get("MYTHRIL_GPU_CALIBRATE", "") == "0":
            return
        from mythril_tpu_torch.service.calibration import (
            STAGE_RATE_KEYS,
            load_profile,
            save_profile,
        )

        platform = self._platform()
        restarts, steps = self._profile_restarts(), self._profile_steps()
        cached = load_profile(platform, restarts, steps)
        if cached is not None:
            self._rates = cached
            if any(key not in cached for key in STAGE_RATE_KEYS):
                # an entry with K1's rate but not every stage ceiling
                # would leave those stages without a ceiling for good
                # (entries never expire): measure the stage rates alone,
                # without a kernel round, and re-save
                with trace_span("router.calibrate", cat="router"):
                    rates, _flat = self._measure_stage_rates()
                self._rates = {**cached, **rates}
                save_profile(platform, restarts, steps, self._rates)
            return
        start = time.monotonic()
        with trace_span("router.calibrate", cat="router"):
            maybe_inject("device.calibrate")
            self._rates = self._measure_rates()
        self.calibration_seconds = time.monotonic() - start
        log.info("device micro-calibration: %s (%.2fs)", self._rates,
                 self.calibration_seconds)
        save_profile(platform, restarts, steps, self._rates)

    def _measure_rates(self) -> dict:
        """The stage rates and K1's rate on their calibration stream."""
        rates, flat = self._measure_stage_rates()
        if flat is not None:
            rates["kernel_cells_s"] = self._measure_kernel_rate(*flat)
        return rates

    def _measure_stage_rates(self):
        """(rates, calibration stream) on a small blasted comparison cone
        (the production query shape at 1/4 width, two entries paged onto
        disjoint variable ranges like a window): pack bytes/s (the timed
        levelization), ragged bytes/s (assembly + upload) and settle
        clauses/s (repeated cold CDCL solves of the same CNF). The stream
        is (flat on the device, stream), or None when it exceeds the
        kernel's capacities."""
        from mythril_tpu_torch.smt import symbol_factory
        from mythril_tpu_torch.smt.solver.frontend import Solver

        device = self.backend.device
        a = symbol_factory.BitVecSym("!cal!a", 64)
        b = symbol_factory.BitVecSym("!cal!b", 64)
        solver = Solver()
        solver.add(a + b == 12345, a > 17, b > 23)
        prep = solver._prepare([])
        pack_start = time.perf_counter()
        pc = circuit.PackedCircuit(prep.aig_roots[0], prep.aig_roots[1])
        pack_elapsed = time.perf_counter() - pack_start
        if not pc.ok:
            raise RuntimeError("calibration circuit failed to pack")
        rates = {}
        if pack_elapsed > 0 and pc.nbytes:
            rates["pack_bytes_s"] = pc.nbytes / pack_elapsed
        rates.update(self._settle_rate(prep))

        caps = ragged_kernel.kernel_caps()
        ragged_start = time.perf_counter()
        stream = circuit.RaggedStream([(pc, ()), (pc, ())])
        flat = ragged_kernel.flatten_stream(stream, caps)
        if flat is None:
            # capacities set below the calibration stream: the cost model
            # keeps its constant
            log.warning("calibration stream exceeds the kernel capacities "
                        "%s; kernel rate not measured", caps)
            return rates, None
        flat = ragged_kernel.device_flat(flat, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ragged_elapsed = time.perf_counter() - ragged_start
        if ragged_elapsed > 0 and stream.nbytes:
            rates["ragged_bytes_s"] = stream.nbytes / ragged_elapsed
        return rates, (flat, stream)

    def _measure_kernel_rate(self, flat, stream) -> float:
        """K1's cells per second on the calibration stream, timed with
        CUDA events over CAL_STEPS after one warm-up launch (perf_counter
        for the plain round on the CPU)."""
        device = self.backend.device
        caps = ragged_kernel.kernel_caps()
        lanes = ragged_kernel.pad_lanes(self._profile_restarts(), caps)
        generator = torch.Generator(device=device)
        generator.manual_seed(2)
        x = circuit.init_inputs(generator, lanes, caps.var_cap, device)
        walk = stream.num_levels + 4

        def launch(seed):
            return ragged_kernel.run_round_ragged_kernel(
                flat, x, seed=seed, steps=CAL_STEPS, walk_depth=walk,
                caps=caps)

        launch(1)  # warm-up: the first launch pays the build and setup
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            launch(2)
            end.record()
            end.synchronize()
            kernel_s = begin.elapsed_time(end) / 1e3
        else:
            kernel_start = time.perf_counter()
            launch(2)
            kernel_s = time.perf_counter() - kernel_start
        # the kernel's cell unit: block-aligned real gates, sim + walk
        return CAL_STEPS * 2 * flat.padded_cells / max(kernel_s, 1e-9)

    @staticmethod
    def _settle_rate(prep) -> dict:
        """Host-CDCL clauses/s over repeated cold solves of the
        calibration CNF (the raw entry point: no settle is counted)."""
        from mythril_tpu_torch.smt.solver import sat_backend

        lib = sat_backend.get_native_lib()
        num_clauses = len(prep.clauses)
        if num_clauses:
            reps = 0
            settle_start = time.perf_counter()
            # repeat until the measurement carries signal (the calibration
            # instance solves in microseconds), hard-capped
            while reps < 64 and (reps < 4 or time.perf_counter()
                                 - settle_start < 0.05):
                sat_backend._solve_native(lib, prep.num_vars, prep.clauses,
                                          [], 1.0, 0)
                reps += 1
            return {"settle_clauses_s": reps * num_clauses
                    / (time.perf_counter() - settle_start)}
        return {}

    def attainable_rates(self) -> dict:
        """The roofline's ceilings (observe/roofline.py): the calibrated
        kernel_cells_s, pack_bytes_s, ragged_bytes_s and settle_clauses_s,
        measured this process or loaded from the persisted entry; a rate
        never measured is absent. A pure read: it never measures, launches
        or synchronizes."""
        return dict(self._rates)

    # -- cost model -------------------------------------------------------------

    def est_ragged_round_seconds(self, cells: int) -> float:
        """ONE ragged round over a stream whose bucketed combined
        rectangle is `cells`: the calibrated kernel rate (sim + walk per
        step), else a conservative platform constant."""
        rate = self._rates.get("kernel_cells_s")
        if rate:
            per_cell = 1.0 / rate
        else:
            per_cell = 1e-7 if self._evidence_mode() else 1e-9
        return per_cell * self._profile_steps() * 2 * max(cells, 1)

    def ragged_chunk_budget_s(self) -> float:
        """Round time ONE chunk may cost: inside the dispatch deadline, with
        0.8 leaving room for the walk and the upload."""
        return 0.8 * min(self.round_budget_s, self.dispatch_deadline())

    def ragged_prep_overhead_seconds(self) -> float:
        """Amortized stream assembly + upload wall per ragged stream (the
        backend's observed mean; 0 until the first one)."""
        windows = self.backend.ragged_windows
        if not windows:
            return 0.0
        return self.backend.ragged_seconds / windows

    # -- breaker ------------------------------------------------------------------

    def device_usable(self) -> bool:
        if not self._breaker.waste_budget_s:
            self._breaker.waste_budget_s = self._waste_budget()
        return self._breaker.allow()

    def record_dispatch(self, hits: int, seconds: float) -> None:
        """Feed the breaker: device wall with zero models found charges
        the waste budget; one hit forgives everything."""
        self.ragged_windows += 1
        if not self._breaker.waste_budget_s:
            self._breaker.waste_budget_s = self._waste_budget()
        if hits > 0:
            self._breaker.record_success()
        else:
            self._breaker.record_failure(wasted_s=seconds, count=False)

    # -- dispatch -------------------------------------------------------------------

    def dispatch(self, problems: Sequence[Tuple[int, Sequence, Tuple]],
                 timeout_s: float, stats=None, fork_pairs=None,
                 origins=None) -> List[Optional[List[bool]]]:
        """Route a window of blasted queries; returns per-query model bits
        or None (the caller's CDCL settles None and alone proves UNSAT).
        `fork_pairs`: (i, j) problem pairs that are the two sides of one
        batched JUMPI fork. `origins`: per-problem contract tags. Any
        error raises as a recorded DeviceFault (gpu/device.py)."""
        try:
            with trace_span("router.dispatch", cat="router",
                            queries=len(problems)) as sp:
                results = self._dispatch_impl(problems, timeout_s, stats,
                                              fork_pairs, origins)
                sp.set(hits=sum(1 for bits in results if bits is not None))
        except Exception as error:
            raise record_fault(error) from error
        return results

    def _dispatch_impl(self, problems, timeout_s, stats, fork_pairs,
                       origins) -> List[Optional[List[bool]]]:
        results: List[Optional[List[bool]]] = [None] * len(problems)
        if not problems or not self.device_usable():
            return results
        evidence = self._evidence_mode()
        if evidence and self.ragged_windows >= self.ragged_window_cap:
            return results  # evidence budget spent: host-only from here
        self._calibrate()
        caps = ragged_kernel.kernel_caps()
        budget = (min(self.dispatch_deadline(), 0.6 * timeout_s)
                  if timeout_s else self.dispatch_deadline())
        profile = {}
        if evidence:
            profile = dict(num_restarts=self._profile_restarts(),
                           steps=self.CPU_PROFILE_STEPS)

        def origin_of(index):
            if origins is None or index >= len(origins):
                return None
            return origins[index]

        buckets = {}  # shape_bucket(levels) -> list of _Unit
        states = {}   # query index -> _SplitState (partitioned queries)
        with trace_span("router.plan", cat="router", queries=len(problems)):
            self._plan_window(problems, fork_pairs, caps, buckets, states,
                              stats, origin_of)

        deadline = time.monotonic() + budget
        self._dispatch_ragged(buckets, states, results, problems, deadline,
                              profile, evidence, caps, stats)
        if states:
            self._settle_components(states, results, problems, timeout_s,
                                    stats)
        return results

    def _plan_window(self, problems, fork_pairs, caps, buckets, states,
                     stats, origin_of) -> None:
        """Admission of one window: fork pairs packed as shared cones,
        partitioned queries planned component by component, and every
        other query packed and admitted whole. Device-bound units land in
        `buckets`, split states in `states`."""
        fork_qis = set()       # every query index named in a fork pair
        fork_consumed = set()  # packed via the shared-cone pair path
        for qt, qf in fork_pairs or ():
            fork_qis.update((qt, qf))
            pair = self._pack_fork_pair(qt, qf, problems)
            if stats is not None:
                stats.add_fork_pair_pack(hit=pair is not None)
            if pair is None:
                continue
            pc, extra_taken, extra_fall = pair
            # fork cones ride the stream even when "tiny": the fused
            # launch exists to put the branch's feasibility on the SAME
            # launch as the window's other cones
            if self._admission_ragged(pc, caps, len(extra_taken)) \
                    not in ("device", "tiny"):
                continue  # the sides route individually below
            buckets.setdefault(shape_bucket(pc.num_levels), []).extend((
                _Unit(qt, None, pc, problems[qt], extra=extra_taken,
                      fork=True, origin=origin_of(qt)),
                _Unit(qf, None, pc, problems[qf], extra=extra_fall,
                      fork=True, origin=origin_of(qf))))
            fork_consumed.update((qt, qf))
        for qi, problem in enumerate(problems):
            num_vars, clauses, aig_roots = problem[:3]
            if num_vars == 0 or aig_roots is None:
                continue
            if stats is not None:
                stats.add_router_clauses(len(clauses))
            if qi in fork_consumed:
                continue  # riding the shared fork-pair cone
            partition = aig_partition.partition_for_aig_roots(aig_roots)
            if partition is not None:
                states[qi] = self._plan_components(
                    qi, num_vars, aig_roots, partition, caps, buckets,
                    stats, fork=qi in fork_qis, origin=origin_of(qi))
                continue
            pc = self.backend.pack_problem(problem, caps.var_cap)
            if pc is None:  # pre-pack var-cap reject (counted by backend)
                continue
            if not pc.ok:
                continue  # trivially unsat roots: the CDCL proves it
            verdict = self._admission_ragged(pc, caps)
            if verdict == "tiny" and qi in fork_qis:
                verdict = "device"  # fork feasibility rides the launch
            if verdict == "cap":
                self.backend.count_cap_reject(
                    under_floor=(pc.num_levels <= LEVEL_CAP_FLOOR
                                 and pc.num_levels * pc.max_width
                                 <= CELL_FLOOR))
                continue
            if verdict == "tiny":
                # propagation-only cones: the host CDCL settles these in
                # microseconds; a device slot would be pure overhead
                if stats is not None:
                    stats.add_host_direct()
                continue
            buckets.setdefault(shape_bucket(pc.num_levels), []).append(
                _Unit(qi, None, pc, problem, fork=qi in fork_qis,
                      origin=origin_of(qi)))

    def _admission_ragged(self, pc, caps, extra_roots: int = 0) -> str:
        """The admission policy, shared by monolithic queries, projected
        components and fork cones: "tiny" (the host CDCL settles it by
        propagation), "cap" (its estimated stream bytes alone bust the
        stream budget, or it exceeds the kernel's variable space or root
        slots), else "device". The JAX package's Pallas rules: no per-cone
        cost veto — the chunker's round budget still splits windows."""
        if pc.num_levels <= self.host_direct_levels:
            return "tiny"
        if (DeviceSolverBackend.ragged_entry_bytes(pc)
                > self.ragged_stream_budget
                or pc.v1 > caps.var_cap
                or pc.num_roots + extra_roots > caps.root_cap):
            return "cap"
        return "device"

    def _chunk_ragged(self, window: List[_Unit], caps) -> List[List[_Unit]]:
        """Greedy chunking of a window's admitted units into streams: a
        chunk closes when adding the next cone would bust the stream
        memory budget, the kernel's combined variable space or cone slots,
        or push the estimated round (plus the amortized stream prep) past
        the chunk budget. The combined rectangle is tracked per level —
        summed real rows, bucketed — so the estimate follows the cells the
        stream carries. A cone over any bound alone was turned away at
        admission, so every chunk is non-empty."""
        budget_s = self.ragged_chunk_budget_s()
        prep_s = self.ragged_prep_overhead_seconds()
        chunks: List[List[_Unit]] = [[]]
        chunk_bytes = 0
        chunk_vars = 0  # combined page space (var 0 shared)
        chunk_rows = np.zeros((0,), dtype=np.int64)  # combined level rows

        def combined_cells(rows, pc):
            levels = max(len(rows), pc.num_levels, 1)
            merged = np.zeros((levels,), dtype=np.int64)
            merged[: len(rows)] = rows
            merged[: len(pc.level_rows)] += pc.level_rows
            return merged, shape_bucket(levels) * shape_bucket(
                int(merged.max()))

        for unit in window:
            entry_bytes = DeviceSolverBackend.ragged_entry_bytes(unit.pc)
            unit_vars = max(unit.pc.v1 - 1, 0)
            merged, cells = combined_cells(chunk_rows, unit.pc)
            if chunks[-1] and (
                    chunk_bytes + entry_bytes > self.ragged_stream_budget
                    or 1 + chunk_vars + unit_vars > caps.var_cap
                    or len(chunks[-1]) >= caps.cone_cap
                    or self.est_ragged_round_seconds(cells) + prep_s
                    > budget_s):
                chunks.append([])
                chunk_bytes = chunk_vars = 0
                merged, cells = combined_cells(
                    np.zeros((0,), dtype=np.int64), unit.pc)
            chunks[-1].append(unit)
            chunk_bytes += entry_bytes
            chunk_vars += unit_vars
            chunk_rows = merged
        return chunks if chunks[-1] else chunks[:-1]

    def _dispatch_ragged(self, buckets, states, results, problems, deadline,
                         profile, evidence, caps, stats) -> None:
        """The window's admitted units (monoliths, components and fork
        sides alike) in level-bucket order, chunked into streams; each
        stream is one backend call (its rounds and the cube pass)."""
        window = [unit for level in sorted(buckets)
                  for unit in buckets[level]]
        if not window:
            return
        with trace_span("router.chunk", cat="router", units=len(window)):
            groups = self._chunk_ragged(self._order_window(window), caps)
        for group in groups:
            if ((evidence and self.ragged_windows >= self.ragged_window_cap)
                    or self._breaker.state == breaker_mod.OPEN):
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0.1:
                break  # the host settles the rest: the deadline guarantee
            t0 = time.monotonic()
            group_bits = self._ragged_dispatch(group, remaining, profile)
            elapsed = time.monotonic() - t0
            hits = sum(1 for bits in group_bits if bits is not None)
            if stats is not None:
                # no query-axis padding on a ragged stream: slots == cones
                stats.add_device_dispatch(len(group), len(group), elapsed)
                if any(unit.fork for unit in group):
                    stats.add_fork_stream_dispatch()
            self.record_dispatch(hits, elapsed)
            with trace_span("router.land", cat="router", units=len(group)):
                self._apply_group_bits(group, group_bits, results, states,
                                       problems, stats)

    def _ragged_dispatch(self, group, remaining, profile):
        """One chunk through the backend (a ragged stream's rounds, then
        the cube second pass on the cones they missed) behind the
        device.dispatch fault site, on the deadline runner's thread with a
        hard bound of the remaining budget plus the grace. Everything the
        stream enqueues on the device (pack, upload, K1's launches, the
        copies back) is enqueued inside the call, on the runner thread,
        with the backend's device made current there."""
        device = self.backend.device

        def call():
            maybe_inject("device.dispatch")
            scope = (torch.cuda.device(device) if device.type == "cuda"
                     else contextlib.nullcontext())
            with scope:
                return self.backend.try_solve_batch_ragged(
                    [unit.problem for unit in group],
                    budget_seconds=remaining,
                    packed_hint=[unit.pc for unit in group],
                    extra_roots=[unit.extra for unit in group],
                    cube_vars=self.cube_vars(),
                    cube_min_levels=self.cube_min_levels,
                    stream_budget=self.ragged_stream_budget,
                    **profile)

        return run_with_deadline("device.dispatch", call,
                                 remaining + self.deadline_grace())

    @staticmethod
    def _order_window(window: List[_Unit]) -> List[_Unit]:
        """With >= 2 distinct origins present, round-robin the units by
        origin (per-origin order preserved) before chunking, so a chunk
        boundary cannot turn a mixed window into single-origin streams.
        Single-origin and untagged windows keep the level order."""
        tagged = {unit.origin for unit in window if unit.origin is not None}
        if len(tagged) < 2:
            return window
        queues, order = {}, []
        for unit in window:
            if unit.origin not in queues:
                queues[unit.origin] = []
                order.append(unit.origin)
            queues[unit.origin].append(unit)
        mixed: List[_Unit] = []
        cursor = 0
        while len(mixed) < len(window):
            for origin in order:
                if cursor < len(queues[origin]):
                    mixed.append(queues[origin][cursor])
            cursor += 1
        return mixed

    @staticmethod
    def _apply_group_bits(group, group_bits, results, states, problems,
                          stats) -> None:
        """Land one dispatch's per-unit model bits: monolithic units write
        their query slot, projected components merge into their query's
        split state (misses go to the in-router host list)."""
        device_components = component_hits = 0
        for unit, bits in zip(group, group_bits):
            if unit.component is None:
                results[unit.qi] = bits
                if bits is not None and stats is not None:
                    stats.add_router_model("device")
                continue
            device_components += 1
            unit.resolved = True
            state = states[unit.qi]
            if bits is not None:
                component_hits += 1
                aig_partition.merge_component_bits(
                    unit.comp_dense, problems[unit.qi][2][2],
                    aig_partition.component_vars(unit.comp_dense), bits,
                    state.merged)
            else:
                state.host.append(unit)
        if stats is not None and device_components:
            stats.add_aig_device_components(device_components)
            stats.add_aig_device_component_hits(component_hits)

    def _pack_fork_pair(self, qt, qf, problems):
        """Shared-cone pack of one fork pair: both sides must have blasted
        in the SAME AIG with root sets differing by exactly one literal
        and its negation — the fork literal. Returns (shared
        PackedCircuit, taken-side extra roots, fall-side extra roots) or
        None (the sides then pack individually)."""
        art, arf = problems[qt][2], problems[qf][2]
        if art is None or arf is None:
            return None
        try:
            aig_t, roots_t = art[0], list(art[1])
            aig_f, roots_f = arf[0], list(arf[1])
        except (TypeError, IndexError, KeyError):
            return None  # packed-hint style problems: no raw root view
        if aig_t is not aig_f:
            return None
        set_t, set_f = set(roots_t), set(roots_f)
        only_t, only_f = set_t - set_f, set_f - set_t
        if len(only_t) != 1 or len(only_f) != 1:
            return None
        lit = next(iter(only_t))
        if lit < 2 or next(iter(only_f)) != (lit ^ 1):
            return None
        shared = [root for root in roots_t if root != lit]
        pc = self.backend.pack_cone(aig_t, shared, carry_lits=(lit,))
        if not pc.ok:
            return None
        lit_local = pc.carry_local.get(lit >> 1)
        if not lit_local:
            return None
        want_taken = (lit & 1) == 0  # positive literal = node True
        return (pc, ((lit_local, want_taken),),
                ((lit_local, not want_taken),))

    def _plan_components(self, qi, num_vars, aig_roots, partition, caps,
                         buckets, stats=None, fork: bool = False,
                         origin=None) -> _SplitState:
        """Project a partitioned query onto dispatch units: trivial
        components (all-unit root sets) write their literals into the
        merge state directly, device-eligible components join the buckets
        individually, and the rest settle on the host CDCL inside
        _settle_components."""
        aig, dense_q = aig_roots[0], aig_roots[2]
        state = _SplitState(num_vars)
        for component in partition.components:
            if aig_partition.apply_trivial_assignment(component, dense_q,
                                                      state.merged):
                continue
            pc = self.backend.pack_cone(aig, component.roots)
            comp_nv, comp_cnf, comp_dense = component.instance(aig)
            unit = _Unit(qi, component, pc,
                         (comp_nv, comp_cnf,
                          (aig, list(component.roots), comp_dense)),
                         comp_dense, fork=fork, origin=origin)
            state.units.append(unit)
            # not pc.ok: past the circuit caps (the partition never
            # projects constant roots) — routes host like any other
            verdict = self._admission_ragged(pc, caps) if pc.ok else "cap"
            if verdict == "tiny" and fork:
                verdict = "device"
            if verdict == "device":
                buckets.setdefault(shape_bucket(pc.num_levels),
                                   []).append(unit)
            else:
                # the sub-cone is deliberately routed host while its
                # siblings ride the device (no cap reject counted)
                unit.resolved = True
                state.host.append(unit)
                if stats is not None:
                    stats.add_aig_host_components(1)
        return state

    def _settle_components(self, states, results, problems, timeout_s,
                           stats) -> None:
        """Finish partitioned queries: host-settle leftover components
        (device misses, tiny or oversized sub-cones, never-dispatched
        units) under a bounded budget, then accept the recomposed model
        only if it satisfies the FULL query CNF. A component that cannot
        be settled — an UNSAT one included — leaves the query to the
        caller's CDCL, which alone proves UNSAT."""
        host_budget = min(0.5 * timeout_s, 5.0) if timeout_s else 2.5
        host_deadline = time.monotonic() + host_budget
        with trace_span("router.settle_components", cat="router",
                        queries=len(states)):
            self._settle_components_inner(states, results, problems,
                                          host_deadline, stats)

    @staticmethod
    def _settle_components_inner(states, results, problems, host_deadline,
                                 stats) -> None:
        from mythril_tpu_torch.smt.solver import sat_backend

        for qi, state in states.items():
            leftovers = state.host + [
                unit for unit in state.units if not unit.resolved]
            complete = True
            for unit in leftovers:
                remaining = host_deadline - time.monotonic()
                if remaining <= 0.05:
                    complete = False
                    break
                comp_nv, comp_cnf = unit.problem[0], unit.problem[1]
                t0 = time.monotonic()
                status, bits = sat_backend.solve_cnf(
                    comp_nv, comp_cnf, timeout_seconds=remaining,
                    allow_device=False)
                if stats is not None:
                    stats.add_host_route_seconds(time.monotonic() - t0)
                if status != sat_backend.SAT:
                    complete = False
                    break
                aig_partition.merge_component_bits(
                    unit.comp_dense, problems[qi][2][2],
                    aig_partition.component_vars(unit.comp_dense), bits,
                    state.merged)
            # recomposition soundness net: the merged assignment must
            # satisfy the whole query's CNF (the caller's _reconstruct
            # then re-validates it against the original constraints)
            if complete and DeviceSolverBackend._honors(state.merged,
                                                        problems[qi][1]):
                results[qi] = state.merged
                if stats is not None:
                    # K1 found it only if it found every non-trivial part
                    stats.add_router_model(
                        "trivial" if not state.units
                        else "host" if leftovers else "device")


_router: Optional[QueryRouter] = None


def get_router(device=None) -> QueryRouter:
    """The process-global router over `device`'s backend (None = the
    CUDA device; raises without one). A different device makes a new
    router."""
    global _router
    backend = get_device_backend(device)
    if _router is None or _router.backend is not backend:
        _router = QueryRouter(backend)
    return _router


def reset_router() -> None:
    """Drop calibration, the breaker, the stream count and a recorded
    device fault."""
    global _router
    _router = None
    clear_fault()
