#!/usr/bin/env python3
"""Run the PyTorch port's batched device solve and `analyze` on one CUDA card.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --forms-only   # env, build and the timing phase
    python3 chip_smoke.py --fork-prep    # env, build and the fork-prep runs
    python3 chip_smoke.py --frontier-only  # env, build and the frontier phase
    python3 chip_smoke.py --telemetry-overhead  # env, build, the overhead legs twice
    python3 chip_smoke.py --resilience-only  # env, build, the resilience phase
    python3 chip_smoke.py --bucketed-only  # env, build, the bucketed phase
    python3 chip_smoke.py --k3-split PATH  # env, build, K3's split
    python3 chip_smoke.py --k2-split PATH  # env, build, K2's split
    python3 chip_smoke.py --xla-only     # env, build, the xla phase
    python3 chip_smoke.py --corpus-only  # env, build, the corpus phase
    python3 chip_smoke.py --serve-only   # env, build, the serve phase
    python3 chip_smoke.py --autotune-only  # env, build, the autotune phase
    python3 chip_smoke.py --mesh-only    # env, build, the mesh phase
    python3 chip_smoke.py --options-only  # env, build, the options phase
    python3 chip_smoke.py --inputs-only  # env, build, the inputs phase

Phases, one JSON line each (any failure exits non-zero before the last
line):

  env     torch / CUDA versions, the card and its power limit;
  build   nvcc for the ragged round (mythril_tpu_torch/csrc/ragged_round.cu),
          for the frontier step (csrc/frontier_step.cu), for the
          bucketed path's per-query round (csrc/circuit_round.cu) and for
          the xla mode's round K2 (csrc/xla_round.cu), and g++ for the
          host CDCL (native/sat.cpp), all started together, into
          mythril_tpu_torch/_build/;
  slice   get_models_batch with solver_backend="gpu" on a window of 64
          sibling-path queries at 256 bits (the coalescing window cap),
          pre-analysis and the result tiers off, through the router:
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
          the same work);
  router  the default solve path at full width (256-bit queries, 64
          lanes, 64 steps, the default kernel capacities) behind a fresh
          router, so its calibration really measures: (a) the same
          64-query window through scheduler.solve_batch with pre-analysis
          on, cold and warm, then once more with its verdicts kept
          (the memory tier must answer all 64 without a launch), beside
          the host CDCL with the same pre-analysis; (b) a window of 16 JUMPI fork pairs
          (support/workloads.fork_window) through
          scheduler.solve_fork_batch. Verdicts must equal the host
          CDCL's, models must satisfy their constraints, K1 itself must
          find models in (a) (components it solved, and queries whose
          every part it solved, counted apart from those the router
          settled on the host), fork pairs must pack shared cones and
          ride a stream in (b), and K1 must have launched in each (counts
          read around each run). It prints the calibration, the
          admission, the streams the router launched and where the time
          went, and holds K1 bit for bit against its plain version on the
          largest stream the router launched in (a), and times it there;
  frontier the frontier step K6 against its plain version (the same
          micro-op interpreter in torch ops) on the card, on 100 seeded
          random straight-line runs (support/workloads.frontier_program,
          a quarter of the words at the edges 0, 1, 2^255 and 2^256 - 1)
          over 1-64 rows each, some rows starved of gas, through the
          tensor wrapper and through the stepper's packed step: the ok
          masks must be equal and every output equal on the ok rows; then
          K6 alone (its device time from torch.profiler over the packed
          steps, and back-to-back launches under CUDA events), its
          wrapper, the whole host step
          (the packed step: one copy up, the launch, one copy down) and
          its plain version, each held bit for bit first, on a 64-row
          batch of one fixed run, on a 1-row, 3-op run (the launch
          floor) and on K7's own 64-row batch (12 DIV/MOD/SDIV/SMOD, each
          followed by a POP, over random 1-8-word divisors);
  analyze the port's MythrilAnalyzer end to end, in process, once with
          solver_backend "cpu" (the host CDCL alone, the frontier stepped
          on the host) and once with "gpu" (every batched window through
          the scheduler and the router to K1, every frontier step through
          K6, on the card), the batched frontier on, fork pruning on
          (--pruning-factor 1): KILLBILLY
          (tests/test_analysis.py, rebuilt here with the port's
          easm_to_code) at -t 2 and the four bench_inputs/corpus contracts
          at -t 1, each with an execution timeout of 600 s that the runs
          must not reach, then bench_inputs/stress_dispatch.hex at -t 1
          with a fixed 5 s each (reported, its findings compared only if
          both runs completed; 120 s before the frontier phase came, 60 s
          before the corpus phase came, 30 s before the serve phase came,
          10 s before the mesh and options phases came, cut to keep the
          script inside its time limit). KILLBILLY and
          xc_dispatch_a.hex run a third time, on the host CDCL with the
          frontier stepped by K6 (MYTHRIL_GPU_FRONTIER_BACKEND=cuda): the
          report must equal the host run's byte for byte, and the frontier
          counters too. Fails unless those five runs completed with
          the same findings on both backends at issue granularity (SWC id,
          function, address, title), K1 and K6 launched, the router
          returned models and K1 itself solved components (counts read
          around each run), K1 is bit for bit equal to its plain version
          on the largest stream the five launched and on the largest of
          stress_dispatch, timed on each, and K6 equals its plain version
          on the largest frontier batch the five stepped (rows x ops),
          timed there. The device backend's frontier steps of
          xc_dispatch_a.hex are kept and replayed through the packed
          step for the device's idle share over them (the profiler's
          device time against the steps' host wall). stress_dispatch's
          launches are counted apart ("analyze_stress"): its runs end on
          the clock, so their count depends on the host's speed. Per
          contract and backend it prints the wall, the solver,
          interpreter and prepare seconds,
          the router's plan, landing, round loop and settles, K1's
          launches and component finds, the device queries and hits, the
          frontier's counters and K6's launches, the tracer's spans, and
          the findings. Every device-backend run (the five and
          stress_dispatch) also writes the port's run telemetry under
          chiprun_out/telemetry/<contract>/: the stats JSON
          (MYTHRIL_GPU_STATS_JSON), the heartbeat every 0.5 s
          (MYTHRIL_GPU_HEARTBEAT) and the Prometheus file
          (MYTHRIL_GPU_PROM), and a flight-recorder dump taken with
          flightrec.dump_now after it. One "telemetry" record a run
          prints the roofline rows, the wall decomposition and the top
          gaps, and the run fails unless: completed is true; platform is
          the card's name and kernel_backend the kernel mode
          ("pallas"); the roofline has
          every stage, with a calibrated ceiling on kernel, pack, ragged
          and settle; its wall terms sum to the solver wall (to their
          rounding) or attributed_frac is 1.0; kernel_launches equals
          K1's launches counted around the run less the calibration's;
          frontier_vmap_steps equals K6's launches; the heartbeat holds
          two beats or more, seq rising, and its final beat has the stats
          JSON's counters; the flight recorder's ring (CHECKED_RING_CAP
          spans; full tracing was on for the span summary, --trace
          unarmed) holds the run's last router.dispatch and
          laser.frontier_step spans; and the dump reads back;
  bucketed the bucketed path (--no-ragged) with K3, the per-query round
          (after the analyze phase): (1) K3 against its plain version,
          bit for bit (x and found), on 100 seeded random batches of 1-16
          queries (support/workloads.circuit_batch: spare query slots,
          1-4 roots, spare variables; two of them with x past shared
          memory, so the global tier runs) at random lanes, steps and
          walk depths, on the graft entry's batch
          (mythril_tpu_torch.graft.entry), and on a deep synthetic batch
          of each layout tier (support/workloads.deep_batch, K3_TIER_CASES:
          shared32 with the stream in the ring and resident, shared16,
          xshared at 32, 16 and 8 lanes a word, global) at 64, 1 and 33
          lanes (the variants at 64; 31 and 96 too before the serve phase
          came; tests/test_torch_cuda_circuit.py keeps every lane count
          1-96), launch_shape's tier checked
          on each; (2) the sibling window
          (WINDOW queries, seed SEED) through get_models_batch with
          MYTHRIL_GPU_RAGGED=0 behind a fresh router: verdicts must equal
          the host CDCL's, every model must satisfy its constraints, K3
          must launch, and it is held on the largest batch launched; (3)
          KILLBILLY (-t 2) and xc_dispatch_a.hex (-t 1) through
          MythrilAnalyzer with no_ragged on the device backend at the
          production profile (64 lanes, 64 steps): findings must equal the
          host backend's at issue granularity, K3 must launch and K1 must
          not, K3 is held on the largest batch each run launched, and each
          run prints its wall, prepare, cnf_prep and get_model seconds
          beside the host and ragged device runs of the analyze phase
          (--bucketed-only runs those two itself); (4) K3 timed on the
          largest batch of the two under CUDA events, with its split
          (steps=0: one simulate and the check; walk_depth=0: the
          simulates and root picks without walks) and the plain run's
          walk lengths (mean, largest, and the mean of a 32-lane group's
          longest), beside its plain version's time, the bound and the
          serial chain of phases a lane's steps run (steps x (levels +
          walk depth));
  xla     the xla kernel mode (MYTHRIL_GPU_KERNEL=xla) with K2, the
          XLA-semantics ragged round (after the bucketed phase): (1) K2
          against its plain version, bit for bit (x and found), on 100
          seeded random streams padded to their shape bucket (1-40
          support/workloads.random_cones, pinned inputs) at random lanes,
          steps and walk depths, and on a stream past every K1 capacity
          (three big_cone cones, one asserting 300 roots, and 140 small
          ones: more than 65,536 variables and 128 cones); (2) KILLBILLY
          (-t 2) and xc_dispatch_a.hex (-t 1) through MythrilAnalyzer on
          the device backend in xla mode at the production profile (64
          lanes, 64 steps): findings must equal the host backend's, K2
          must run solve rounds (its calibration's launches counted
          apart) and K1 must not launch, and K2 must have solved
          components (aig_device_component_hits over the two); (3) the
          fallback leg: xc_dispatch_a.hex (-t 1) in pallas mode with
          MYTHRIL_GPU_RAGGED_VAR_CAP=32768, so its 37,381-variable cone
          rides K2 in a stream of its own: K1 and K2 must both launch,
          findings equal the host's, and K2 is held and timed on its
          largest launch (K1's capacities are launch arguments: no
          rebuild); (4)
          K2 held and timed on the largest launch of (2) under CUDA
          events, with its split (steps=0, walk_depth=0), its launch
          shape (each cone's tier) and the plain run's walk lengths,
          beside its plain version's time and its bound (the
          real gates' level entries and the other tables and x read
          once, x and found written once, against the real gates' and
          roots' operations, as K3's); the fallback leg's largest launch
          and the stream past every K1 capacity timed the same way.
          --xla-only runs the host legs of (2) itself;
  telemetry-overhead  KILLBILLY (-t 2) (and xc_dispatch_a.hex -t 1
          before the serve phase came; --telemetry-overhead runs both) on
          the device backend with every telemetry artifact off
          (MYTHRIL_GPU_FLIGHTREC=0, nothing written) and on (the ring at
          its default 512 spans, the heartbeat every 0.5 s, the
          Prometheus file, the stats JSON), full tracing off, in the
          order off, on (off, on, on, off before the corpus phase came):
          the walls of each, and the CPU
          seconds spent inside the telemetry's own calls (a span
          recorded, a beat, the stats JSON) in each leg;
  resilience  fault containment and the disk tier on the device backend,
          through the fault-injection harness: (1) KILLBILLY (-t 2)
          through the port's CLI in a subprocess with
          --inject-fault device.dispatch:hang:n1, MYTHRIL_GPU_DEVICE_DEADLINE
          and MYTHRIL_GPU_STAGE_GRACE at 2 s: it must exit 2 within the
          deadline, the grace and 30 s while the abandoned call still
          sleeps, with a stats JSON of completed false, a deadline event
          at device.dispatch and one injected fault, and a flight-recorder
          dump whose trigger is the deadline; (2) device.dispatch:raise:n1
          and, with the cuda step, frontier.step:raise:n1: exit 2 with the
          injected fault as the DeviceFault's cause and its event; (3) in
          process, KILLBILLY on the disk tier with no fault, then under
          each of HOST_FAULTS: the run completes with the no-fault run's
          findings (issue granularity) and the site's events, and K1
          launches (except under aig.session:raise:*, whose un-rewritten
          queries exceed the router's variable cap; its n1 run
          launches), and K1
          is held bit for bit against its plain version on each run's
          largest stream (a fault changes the cones K1 is sent); the
          clean run records no deadline and prints the deadline runner's
          cost (the stats JSON's deadline_runner_calls and
          deadline_handoff_wall, which the runner counts itself); (4)
          KILLBILLY (-t 2; xc_dispatch_a.hex -t 1 before the corpus phase
          came) three times in new processes on one
          --solve-cache disk directory: the first stores entries (K1
          launched), the second hits them with no verify reject, the third
          (disk.entry:corrupt:*) quarantines, both with the first's
          findings. Each run prints its wall and K1's and K6's launches
          (the stats JSON's kernel_launches and frontier_vmap_steps for
          the CLI runs), beside the card's nvidia-smi line. Every check of
          the analyze phase's telemetry also fails a clean run that
          recorded a deadline, and the analyze phase prints the runner's
          cost summed over the five compared contracts' dispatches;
  corpus  corpus runs (after the resilience phase) of the four
          bench_inputs/corpus contracts at -t 1 through MythrilAnalyzer,
          fork pruning on, 600 s timeouts they must not reach, each
          contract loaded under its file name: (a) --corpus-interleave 4
          on the device backend: findings by contract must equal the
          analyze phase's sequential host and device runs at issue
          granularity, a stream must mix two contracts
          (xcontract_windows), and K1 must launch while a mixed-origin
          group is dispatched (the router's _ragged_dispatch wrapped to
          count them); K1 is held bit for bit against its plain version
          on the largest mixed-origin stream and timed there beside its
          bound; (b) --jobs 4 on the device backend: the same findings,
          K1 and K6 launches in the stats the workers sent back, K1
          launched by every worker (each worker's record: its pid, its
          launches by kernel and its router's calibrated K1 rate), the
          workers' final metrics snapshots merged
          (observe.metrics.merge_snapshots) agreeing with the absorbed
          stats, and the card's busy share over the leg (nvidia-smi's
          utilization.gpu every 200 ms, all processes); (c) --jobs 2 on
          KILLBILLY and xc_dispatch_a.hex under jobs.worker:exit:n1: a
          worker_requeue and then a degraded event,
          resilience_worker_requeues 1, both contracts analyzed in this
          process on K1 with the host's findings (KILLBILLY's at -t 1
          from a host run here); (d) --jobs 4 on the host backend. It
          prints each leg's wall and contracts per hour beside the
          sequential host and device walls of the analyze phase.
          --corpus-only runs the sequential host and device runs itself.
  serve   `serve` on the card, last: (a) the daemon in this process over
          HTTP on port 0 at its defaults (batch 4, queue 64, tenant budget
          8) with the device backend; three tenants POST five requests at
          once (KILLBILLY at -t 2, the four corpus contracts at -t 1);
          each answer's findings (issue granularity) equal the contract's
          sequential host run (the analyze phase's, or run here); it
          prints each request's latency, each batch's wall,
          serve_batches and serve_batch_tenants, K1's launches in all and
          on mixed-origin streams (at least one), K6's launches and the
          card's busy share over the leg, with their counts set to 0
          just before the leg and read just after, and K1 held bit for
          bit and timed on the largest mixed-origin stream beside its
          bound by bytes; (b) KILLBILLY again for the same tenant records
          fewer cdcl_settles than its first run and than a cold tenant's
          run, with its K1 launches; (c) POST /evict drops that tenant's
          memory tiers and leaves the others'; (d) `serve --shards 2`
          as a subprocess with a shared MYTHRIL_GPU_NET_TIER_DIR: one
          contract from two tenants lands on one shard, a contract routed
          to the other shard runs there, the first contract sent to the
          other shard is served from the tier (net_tier_hits), both
          shards' K1 solve rounds are above 0, the merged /metrics equal
          the shards' snapshots summed, and SIGTERM exits 0; (e) `serve`
          with device.dispatch:raise:n1: both requests answer
          `device_fault` (or are refused with it), /healthz answers 503
          with ok false, and the process exits 2. --serve-only runs the
          host runs itself.
  autotune  the autotune slice on the card, last, in a fresh cache
          directory under chiprun_out/autotune/: (a) `python -m
          mythril_tpu_torch autotune -f <KILLBILLY's creation code> -t 2
          --candidates 3 --rounds 2 -v 4` in a new process (the whole
          script: --candidates 1 --rounds 1): it must exit
          0 with `tuned` or `no_improvement`, its platform the card's
          name, no candidate failed, candidates_tried equal to the parity
          and regression rejects plus the winner, its stats JSON's
          autotune counters equal to its summary; it prints every child's
          wall and K1 solve rounds (the search's log lines) and the gap
          stages; when it persisted a profile, a second call (no --force)
          must answer already_tuned with no child run; (b) the card's
          profile written through calibration.save_tuned with
          MYTHRIL_GPU_KERNEL=xla and MYTHRIL_GPU_CIRCUIT_STEPS=32, then
          KILLBILLY -t 2 through the CLI in a new process
          (autotune_child: K1's and K2's launches counted, the router's
          calibration apart, and their largest solve-round launches
          kept): both knobs have source tuned,
          tuned_knobs_applied is 2, kernel_backend is xla, K2 launches
          and K1 does not (no solve round either), findings equal the
          host run's, and K2 is held bit for bit and timed on its
          largest launch, at 32 steps, beside its bound; (c) the same with
          MYTHRIL_GPU_KERNEL=pallas in the env: the knob's source is env,
          tuned_knobs_applied 1, K1 launches and is held bit for bit and
          timed on its largest launch; (d) a corrupt calibration.json:
          tuned_profile_rejects 1, every knob from its default, the run
          completes on K1 with the host's findings. The three runs of
          (b)-(d) go side by side, each in its own process.
          --autotune-only runs the host run itself.
  options the engine options analyze reads, after the analyze phase:
          KILLBILLY -t 2 on the host and the device backend under
          --enable-summaries, --enable-state-merging and (its runtime
          code, whose selectors the prioritiser ranks)
          --disable-incremental-txs (the whole script: summaries only):
          the findings must be equal at issue granularity and non-empty,
          K1 must run solve rounds and K6 launch (counted from just
          before the device run to just after it; under summaries no
          state takes the batched frontier, in the JAX package too, so
          K6 must not launch), and every K1 launch
          of the device run is held bit for bit against its plain
          version, the largest timed; then -j and -g of KILLBILLY -t 1
          through the CLI in this process on both backends: the
          device's statespace JSON byte for byte the host's, its vis.js
          page the same node and edge sets, none empty (written under
          chiprun_out/options/).
  inputs  the inputs the CLI reads besides bytecode, after the options
          phase, through the CLI in this process on both backends: (a)
          `analyze -a ADDRESS --rpc 127.0.0.1:PORT -t 2` of a KILLBILLY
          whose kill() reads an unlock flag from storage, served with
          its storage by a pinned chain on 127.0.0.1 (a stdlib server in
          a thread of this process): the findings equal at issue
          granularity and non-empty, K1 solve rounds past the
          calibration and K6 launches (counted from just before the
          device run to just after it), eth_getCode and eth_getStorageAt
          among the chain's requests; (b) `read-storage` in its position,
          range, array and mapping forms, each line the pinned value at
          the slot the layout's keccak math gives; (c) `safe-functions`
          of KILLBILLY's runtime code at -t 2, the device's list the
          host's (kill() flagged: no function safe); (d) `concolic` on a
          two-way branch run with 7, flipping its JUMPI: the device's
          JSON the host's, the flipped input 42, its K1 launches printed
          (0 when every window settles before the router). Every K1
          launch of (a) and (c), and (d)'s largest, is run again on the
          card and held bit for bit against its plain version on the
          host (6 spawned processes while the later legs go on), each
          leg's largest timed.
  mesh    K4, after the bucketed phase: graft.dryrun_multichip on a
          virtual mesh of 8 shards on the card (4 x 2; the whole script:
          4 shards, 2 x 2, leg 1 only): the pinned contract's analyze
          harvested on the host, leg 1 solving its shallow 256-bit cones
          with host-checked models and leg 2 executing the deep ones.
          Every K4 round is held as it returns: each shard's x and found
          bit for bit against run_round_circuit_plain on its blocks with
          its folded seed (on the host, in 4 spawned processes while the
          dryrun goes on, every one waited for; the first round on the
          card too, its plain runs timed there), solved against
          found.any over mp; launches are counted by shard. K4 is then
          timed under CUDA events on leg 1's first round (leg 1 is one
          batch) beside K3 on the same batch unsharded. Its bound is the
          slowest device's share: each dp block's tables read once a
          device, x and found per shard (on a virtual mesh, K3's bound
          on the batch unsharded).
The whole script prints each phase's seconds in its "total" record.
--telemetry-overhead runs the overhead legs alone, twice over (eight legs
a contract).

The kernel and timing phases build their streams with pre-analysis off,
as this script's earlier versions did, so their timed stream stays the
same.
--fork-prep runs xc_dispatch_a.hex and xc_dispatch_b.hex at -t 1 through
the analyze phase's runner in five legs: the host backend, the device
backend, the device backend with --no-frontier-fork, with the fork-pair
members prepared under the normal (forced) aig_opt sweep instead of the
deferred one, and with --no-vmap-frontier. Each leg prints its wall,
prepare seconds and the cnf_prep and aig_opt spans split into the
fork-pair members' and the other queries' (count, seconds, clauses,
propagation rounds); every analyze record carries the same split. It
checks nothing.
--frontier-only runs the frontier phase alone. It calls only the step's
interface (run_step_kernel, prepare_launch, step_batch, encode_program),
so a copy of this script placed in a checkout of an earlier version of
the port times that version's K6 on the same batches.
--k3-split PATH times K3 at those three settings on the largest batch of
the two bucketed analyze runs, kept in the torch.save file PATH (captured
and written there when it does not exist). It calls only the round's
interface, so a copy of this script placed in a checkout of an earlier
version of the port times that version's K3 on the same batch.
--k2-split PATH times K2 the same way (full, steps=0, walk_depth=0) on
three launches kept in the torch.save file PATH (captured and written
there when it does not exist): the fallback leg's largest launch, the
largest launch of the xla mode's two analyze runs and the stream past
every K1 capacity; the fallback launch also at 16 and 8 lanes a word. It
prints each launch's shape, its bound and serial chain and, where the
plain version counts walks, the plain run's walk lengths (the mean
longest walk of a group of 32 lanes and of 8), K2 held bit for bit. It
uploads each stream through device_stream and calls only the round's
interface, so a copy of this script placed in a checkout of an earlier
version of the port times that version's K2 on the same launches.
--forms-only times the same three streams with the host CDCL's verdicts
and no other phase. It calls only the round's interface (flatten_stream,
device_flat, run_round_ragged_kernel), so a copy of this script placed in
a checkout of an earlier version of the port times that version's kernel.

Then the script's total seconds, the {"kernels": [...]} line (K1's and
K6's launches over the five compared analyze contracts and their times on
the largest stream and frontier batch they launched; K1's router and slice
streams and K6's 64-row, division and 1-row batches and its idle share
beside them; K3's launches over the bucketed analyze runs and its time on
their largest batch, with its split and the plain run's walk lengths;
K2's launches over the xla-mode analyze runs, the fallback leg and the
random streams, and its time on the xla runs' largest launch with its
split and walk lengths, then on the fallback's and the past-k1 stream;
K1's and K6's launches in the corpus phase, and K1's time on its largest
mixed-origin stream; the same of the serve phase, and the fleet shards'
K1 solve rounds; the autotune phase's: the search children's K1 solve
rounds, K1's launches under (c) and (d) and its time on (c)'s largest
launch, K2's launches under (b) and its time there; K1's and K6's
launches under each option leg and K1's in the -j/-g dumps; K1's and
K6's launches under each inputs leg and K1's time on their largest
launch; K4's launches
by shard in the mesh phase, its time on leg 1's round, the plain runs'
sum, its bound and K3 unsharded beside it), the card's
nvidia-smi line, and last {"ok": true,
"device": {...}}. A copy of every JSON line goes to
chiprun_out/chip_smoke.jsonl.
"""

import contextlib
import glob
import json
import logging
import os
import random
import re
import shutil
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

# one H100 SXM: HBM rate and the non-tensor 32-bit peak (NVIDIA's data
# sheet); the ragged round's work is 32-bit integer logic, for which the
# data sheet gives no separate rate, so the CUDA-core float32 rate is used
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
WINDOW = 64        # service/scheduler.py DEFAULT_COALESCE_MAX_RAGGED
FORK_PAIRS = 16    # the fork window: 32 queries
SEED = 20261016
OUT_DIR = "chiprun_out"
ANALYZE_TIMEOUT = 600   # s per analyze run; the runs must complete inside
STRESS_TIMEOUT = 5      # s per stress_dispatch run, a measurement
FRONTIER_RUNS = 100     # random runs K6 is held against its plain version
FRONTIER_EDGE_BIAS = 0.25
# analyze runs repeated on the host CDCL with the frontier stepped by K6
CUDA_HOST_RUNS = ("killbilly", "xc_dispatch_a.hex")
# the contract whose frontier steps are replayed for the device's idle share
IDLE_CONTRACT = "xc_dispatch_a.hex"
CORPUS = ("xc_dispatch_a.hex", "xc_dispatch_b.hex", "xc_sender_a.hex",
          "xc_sender_b.hex")
# the heartbeat's cadence on every device-backend analyze run
HEARTBEAT_INTERVAL_S = 0.5
# the flight recorder's ring on the checked analyze runs: 512 (the
# default) loses the last router.dispatch span on the sender contracts,
# which make about 600 spans after it
CHECKED_RING_CAP = 4096
# contracts timed with every telemetry artifact off and on, in turns
OVERHEAD_CONTRACTS = ("killbilly",)
# --telemetry-overhead times these
OVERHEAD_ONLY_CONTRACTS = ("killbilly", "xc_dispatch_a.hex")

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


@contextlib.contextmanager
def _preanalysis(on: bool):
    """MYTHRIL_GPU_PREANALYSIS pinned inside the block."""
    saved = os.environ.get("MYTHRIL_GPU_PREANALYSIS")
    os.environ["MYTHRIL_GPU_PREANALYSIS"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MYTHRIL_GPU_PREANALYSIS", None)
        else:
            os.environ["MYTHRIL_GPU_PREANALYSIS"] = saved


# -- phases ---------------------------------------------------------------


def phase_build():
    from mythril_tpu_torch.gpu import (
        circuit_kernel,
        frontier_kernel,
        ragged_kernel,
        xla_kernel,
    )
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
                ("nvcc-frontier", frontier_kernel.build_kernel),
                ("nvcc-circuit", circuit_kernel.build_kernel),
                ("nvcc-xla", xla_kernel.build_kernel),
                ("g++", sat_backend.get_native_lib))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    def ptxas(name):
        return [line.strip() for line in results[name][1]["ptxas"].splitlines()
                if "registers" in line or "smem" in line]

    emit({"phase": "build", "nvcc_s": round(results["nvcc"][0], 3),
          "nvcc_frontier_s": round(results["nvcc-frontier"][0], 3),
          "nvcc_circuit_s": round(results["nvcc-circuit"][0], 3),
          "nvcc_xla_s": round(results["nvcc-xla"][0], 3),
          "gxx_s": round(results["g++"][0], 3), "ptxas": ptxas("nvcc"),
          "ptxas_frontier": ptxas("nvcc-frontier"),
          "ptxas_circuit": ptxas("nvcc-circuit"),
          "ptxas_xla": ptxas("nvcc-xla")})


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
    """The 64-query window with pre-analysis off (the caller pins it) and
    the result tiers off, so each run solves every query."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.gpu import backend as backend_mod
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches, get_models_batch
    from mythril_tpu_torch.support.workloads import sibling_window

    queries = sibling_window(smt, WINDOW, seed=SEED)
    stats = SolverStatistics()
    stats.enabled = True
    clear_caches()
    args.solve_cache = "off"
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
    args.solve_cache = "memory"
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


def _profile_device(run_once, kernel: str) -> tuple:
    """(run_once's result, µs of every CUDA event, µs of the events whose
    name holds `kernel`) over one call of run_once, from torch.profiler
    (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run_once()
    device_us = kernel_us = 0.0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", 0.0)
        device_us += us
        if kernel in event.key:
            kernel_us += us
    return result, device_us, kernel_us


def _device_busy(run_once) -> dict:
    """Device time by kernel over one warm run of the slice, from
    torch.profiler, against that run's wall."""
    (_results, wall), device_us, kernel_us = _profile_device(
        run_once, "ragged_round")
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
    return _compare_timed(flat, x, seed, steps, walk_depth, caps)[0]


def _compare_timed(flat, x, seed, steps, walk_depth, caps):
    """K1 against its plain version on one launch's inputs: (max abs
    error, which must be 0, and the plain run's ms, that one run timed as
    the K2 and K3 holds time theirs)."""
    import torch

    from mythril_tpu_torch.gpu import ragged_kernel

    got_x, got_found = ragged_kernel.run_round_ragged_kernel(
        flat, x, seed, steps, walk_depth, caps)
    (want_x, want_found), plain_ms = _timed_once(
        x.device, lambda: ragged_kernel.run_round_ragged_plain(
            flat, x, seed, steps, walk_depth, caps))
    torch_sync(x.device)
    if not (torch.equal(got_x, want_x) and torch.equal(got_found,
                                                        want_found)):
        raise AssertionError(
            f"kernel disagrees with its plain version: "
            f"{int((got_x != want_x).sum())} x cells, "
            f"{int((got_found != want_found).sum())} found cells")
    return max(int((got_x - want_x).abs().max()),
               int((got_found.int() - want_found.int()).abs().max())), \
        plain_ms


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
    chunks = _greedy_chunks(packed, caps,
                            backend_mod.RAGGED_STREAM_BYTES_DEFAULT)
    chunk = max(chunks, key=lambda c: sum(pc.num_gates for _i, pc, _e in c))
    plain = circuit.RaggedStream([(pc, extra) for _i, pc, extra in chunk])
    lanes = ragged_kernel.pad_lanes(backend.num_restarts, caps)
    return caps, lanes, backend.CIRCUIT_STEPS, cube, plain


def _greedy_chunks(packed, caps, stream_budget):
    """The window's cones in query order, cut where the next cone would
    push the combined variable space past var_cap, the cone count past
    cone_cap or the estimated stream bytes past `stream_budget`: the
    chunking that made the timed stream before the router took over the
    main path (the timed stream is its chunk with the most gates)."""
    from mythril_tpu_torch.gpu.backend import DeviceSolverBackend

    chunks = [[]]
    chunk_vars = chunk_bytes = 0
    for entry in packed:
        pc = entry[1]
        unit_vars = max(pc.v1 - 1, 0)
        entry_bytes = DeviceSolverBackend.ragged_entry_bytes(pc)
        if chunks[-1] and (1 + chunk_vars + unit_vars > caps.var_cap
                           or len(chunks[-1]) >= caps.cone_cap
                           or chunk_bytes + entry_bytes > stream_budget):
            chunks.append([])
            chunk_vars = chunk_bytes = 0
        chunks[-1].append(entry)
        chunk_vars += unit_vars
        chunk_bytes += entry_bytes
    return [chunk for chunk in chunks if chunk]


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


def _run_counted(device, solver_backend, solve, streams=None,
                 keep_tiers=False):
    """One run of `solve` with every count set to 0 just before it and
    read just after: (results, wall seconds, {launches, counters, spans,
    backend deltas}). The result tiers are emptied first unless
    `keep_tiers`, so the run solves every query; `streams` collects
    (stream, entries) of each ragged stream the backend assembles."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu.backend import get_device_backend
    from mythril_tpu_torch.observe.tracer import get_tracer
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_result_tiers

    args.solver_backend = solver_backend
    args.torch_device = None if device.type == "cuda" else device
    backend = get_device_backend(args.torch_device)
    if not keep_tiers:
        clear_result_tiers()
    stats = SolverStatistics()
    stats.enabled = True
    stats.reset()
    ragged_kernel.reset_launches()
    before = backend.stats()
    tracer = get_tracer()
    tracer.reset()
    tracer.enable(None)
    if streams is not None:
        backend.on_stream = lambda stream, entries: streams.append(
            (stream, entries))
    torch_sync(device)
    start = time.monotonic()
    try:
        results = solve()
        torch_sync(device)
        wall = time.monotonic() - start
    finally:
        backend.on_stream = None
        spans = tracer.summary()
        tracer.reset()
    after = backend.stats()
    deltas = {key: round(after[key] - before[key], 4) for key in after
              if isinstance(after[key], (int, float))}
    return results, wall, {"launches": ragged_kernel.launches,
                           "counters": stats.as_dict(), "spans": spans,
                           "backend": deltas}


def _breakdown(info, wall) -> dict:
    """Where one run's `wall` went. The parts: the memory-tier and
    quick-sat probes; prepare (with its pre-analysis stages beside it);
    the router's admission plan (partition, component instances and pack,
    pack_s beside it); its calibration; its chunking; stream assembly +
    upload; the round loop; the host check of K1's models; landing them
    (merging component models into their queries); the router's own
    component settle; the reconstruction of device models; the CDCL
    settle pass. unattributed_s is the wall less those parts (the cold
    run's calibration holds one small prepare of its own, counted in
    both), and router_other_s the router's span less its parts. The counters beside cnf_prep_s say what it worked
    on: its instances, the AIG nodes before and after the rewrite, the
    units it propagated, the clauses it removed and its propagation
    rounds (each a pass over every literal)."""
    counters, spans, backend = (info["counters"], info["spans"],
                                info["backend"])

    def span_s(name):
        return spans.get(name, [0, 0.0])[1]

    parts = {"probe_s": span_s("cache.probe"),
             "prepare_s": counters["prepare_wall"],
             "router_plan_s": span_s("router.plan"),
             "calibration_s": span_s("router.calibrate"),
             "chunk_s": span_s("router.chunk"),
             "stream_assembly_upload_s": backend.get("ragged_seconds", 0.0),
             "round_loop_s": backend.get("solve_seconds", 0.0),
             "device_check_s": span_s("device.check"),
             "land_s": span_s("router.land"),
             "router_settle_s": span_s("router.settle_components"),
             "reconstruct_s": span_s("solver.reconstruct"),
             "cdcl_settle_s": span_s("solver.settle_pass")}
    router_parts = ("router_plan_s", "calibration_s", "chunk_s",
                    "stream_assembly_upload_s", "round_loop_s",
                    "device_check_s", "land_s", "router_settle_s")
    return {**parts,
            "unattributed_s": wall - sum(parts.values()),
            "router_s": span_s("router.dispatch"),
            "router_other_s": span_s("router.dispatch") - sum(
                parts[key] for key in router_parts),
            "incremental_s": span_s("solver.prefix_resume"),
            "aig_opt_s": span_s("solver.aig_opt"),
            "cnf_prep_s": span_s("solver.cnf_prep"),
            "pack_s": backend.get("pack_seconds", 0.0),
            "cnf_prep_instances": spans.get("solver.cnf_prep", [0, 0.0])[0],
            "aig_nodes_before": counters["aig_nodes_before"],
            "aig_nodes_after": counters["aig_nodes_after"],
            "aig_const_folds": counters["aig_const_folds"],
            "cnf_units_propagated": counters["cnf_units_propagated"],
            "cnf_prep_rounds": counters["cnf_prep_rounds"],
            "cnf_clauses_removed": counters["cnf_clauses_removed"],
            "router_clauses": counters["router_dispatched_clauses"]}


def _check_against_host(name, results, host, queries):
    verdicts = [status for status, _model in results]
    host_verdicts = [status for status, _model in host]
    if verdicts != host_verdicts:
        raise AssertionError(f"{name}: verdicts differ from the host CDCL: "
                             f"{verdicts} vs {host_verdicts}")
    for (status, model), constraints in zip(results, queries):
        if status == "sat" and not model.satisfies(constraints):
            raise AssertionError(f"{name}: a model fails its constraints")
    return verdicts


def _stream_rows(streams):
    """Per captured stream: cones (distinct packed cones), variables,
    combined levels, and the deepest cone's levels and variables."""
    rows = []
    for stream, entries in streams:
        deepest = max((pc for pc, _extra in entries),
                      key=lambda pc: pc.num_levels)
        rows.append({"cones": stream.num_cones,
                     "distinct_cones": len({id(pc) for pc, _e in entries}),
                     "pinned": sum(1 for _pc, extra in entries if extra),
                     "vars": stream.v1, "levels": stream.num_levels,
                     "deepest_cone_levels": deepest.num_levels,
                     "deepest_cone_vars": deepest.v1})
    return rows


def phase_router(device):
    """The default solve path behind a fresh router (see the module
    note). Returns the launches of each run and the largest error of the
    bit-for-bit comparison."""
    import torch

    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.gpu import circuit, ragged_kernel
    from mythril_tpu_torch.gpu.backend import get_device_backend
    from mythril_tpu_torch.gpu.router import get_router
    from mythril_tpu_torch.service.scheduler import get_scheduler
    from mythril_tpu_torch.support.model import clear_caches
    from mythril_tpu_torch.support.workloads import fork_window, sibling_window

    clear_caches()  # a fresh router, scheduler and pre-analysis memos
    queries = sibling_window(smt, WINDOW, seed=SEED)

    def batch():
        return get_scheduler().solve_batch(queries)

    streams = []
    results, cold_s, cold = _run_counted(device, "gpu", batch, streams)
    _results, warm_s, warm = _run_counted(device, "gpu", batch)
    # the window once more, its verdicts kept: the memory tier answers
    again, tier_s, tier = _run_counted(device, "gpu", batch,
                                       keep_tiers=True)
    host, host_s, host_info = _run_counted(device, "cpu", batch)
    verdicts = _check_against_host("sibling window", results, host, queries)
    counters = cold["counters"]
    if counters["device_batch_hits"] <= 0:
        raise AssertionError("router: the router returned no model")
    if (counters["router_device_found"] <= 0
            or counters["aig_device_component_hits"] <= 0):
        raise AssertionError("router: K1 found no model (the router's "
                             "models were all settled on the host)")
    if cold["launches"] <= 0:
        raise AssertionError("router: K1 was never launched")
    _check_against_host("memory tier", again, host, queries)
    if (tier["launches"] or tier["counters"]["memory_hits"]
            != len(queries)):
        raise AssertionError("router: the repeated window was not served "
                             "by the memory tier alone")
    for info in (cold, warm, host_info):
        if info["counters"]["resilience_degraded"]:
            raise AssertionError("router: a pre-analysis stage degraded")
    backend = get_device_backend(None if device.type == "cuda" else device)
    router = get_router(None if device.type == "cuda" else device)
    rates = router.attainable_rates()
    if not rates.get("kernel_cells_s"):
        raise AssertionError("router: calibration measured no kernel rate")
    rows = _stream_rows(streams)
    emit({"phase": "router", "window": "sibling", "queries": len(queries),
          "sat": verdicts.count("sat"), "unsat": verdicts.count("unsat"),
          "unknown": verdicts.count("unknown"),
          "wall_cold_s": cold_s, "wall_warm_s": warm_s,
          "wall_memory_tier_s": tier_s,
          "memory_hits": tier["counters"]["memory_hits"],
          "host_cdcl_s": host_s,
          "calibration": {"seconds": router.calibration_seconds,
                          "kernel_timer": ("cuda events"
                                           if device.type == "cuda"
                                           else "perf_counter"),
                          **rates},
          "admission": {"host_direct": counters["router_host_direct"],
                        "components_dispatched":
                            counters["aig_device_components"],
                        "components_found_by_k1":
                            counters["aig_device_component_hits"],
                        "components_to_host":
                            counters["aig_host_components"],
                        "aig_components": counters["aig_components"],
                        "cap_rejects": counters["cap_rejects"],
                        "cap_rejects_floor": counters["cap_rejects_floor"]},
          "device_batch_queries": counters["device_batch_queries"],
          "device_batch_hits": counters["device_batch_hits"],
          "router_device_found": counters["router_device_found"],
          "router_host_settled": counters["router_host_settled"],
          "router_trivial_settled": counters["router_trivial_settled"],
          "warm_device_batch_hits":
              warm["counters"]["device_batch_hits"],
          "warm_router_device_found":
              warm["counters"]["router_device_found"],
          "cdcl_settles": counters["cdcl_settles"],
          "cubes_dispatched": counters["cubes_dispatched"],
          "kernel_launches": cold["launches"],
          "warm_kernel_launches": warm["launches"],
          "streams": {"count": len(rows),
                      "cones_per_stream": [row["cones"] for row in rows],
                      "deepest_cone_levels": max(
                          row["deepest_cone_levels"] for row in rows),
                      "deepest_cone_vars": max(
                          row["deepest_cone_vars"] for row in rows),
                      "each": rows},
          "breakdown_cold": _breakdown(cold, cold_s),
          "breakdown_warm": _breakdown(warm, warm_s),
          "breakdown_host": _breakdown(host_info, host_s)})

    # K1 bit for bit on the largest stream the router launched
    stream, entries = max(streams, key=lambda item: sum(
        pc.num_gates for pc, _extra in item[1]))
    caps = ragged_kernel.kernel_caps()
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    lanes = ragged_kernel.pad_lanes(backend.num_restarts, caps)
    x = circuit.init_inputs(gen, lanes, caps.var_cap, device)
    steps, walk_depth = backend.CIRCUIT_STEPS, _walk_depth(stream)
    err, plain_ms = _compare_timed(flat, x, 19, steps, walk_depth, caps)
    # its time: launches made here are not counted
    launches_before = ragged_kernel.launches
    ms = _time_ms(lambda: ragged_kernel.run_round_ragged_kernel(
        flat, x, 19, steps, walk_depth, caps), repeats=5)
    ragged_kernel.launches = launches_before
    bound_ms, bound_by, moved, ops = _bound(flat, stream.v1, lanes, steps,
                                            caps)
    emit({"phase": "router", "window": "router-stream",
          **_stream_fields(stream, flat), "lanes": lanes, "steps": steps,
          "walk_depth": walk_depth,
          "global_path_cones": list(flat.cones.global_cones),
          "bit_identical": True, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": moved, "ops": ops})

    sets, pairs = fork_window(smt, FORK_PAIRS, seed=SEED)

    def forks():
        return get_scheduler().solve_fork_batch(sets, pairs)

    fork_streams = []
    fork_results, fork_s, fork = _run_counted(device, "gpu", forks,
                                              fork_streams)
    fork_host, fork_host_s, _info = _run_counted(device, "cpu", forks)
    fork_verdicts = _check_against_host("fork window", fork_results,
                                        fork_host, sets)
    counters = fork["counters"]
    if counters["fork_pair_pack_hits"] <= 0:
        raise AssertionError("router: no fork pair packed a shared cone")
    if counters["fork_stream_dispatches"] <= 0:
        raise AssertionError("router: no stream carried fork cones")
    if fork["launches"] <= 0:
        raise AssertionError("router: K1 was never launched on the forks")
    emit({"phase": "router", "window": "fork", "pairs": len(pairs),
          "queries": len(sets), "sat": fork_verdicts.count("sat"),
          "unsat": fork_verdicts.count("unsat"),
          "unknown": fork_verdicts.count("unknown"),
          "wall_s": fork_s, "host_cdcl_s": fork_host_s,
          "fork_pair_pack_attempts": counters["fork_pair_pack_attempts"],
          "fork_pair_pack_hits": counters["fork_pair_pack_hits"],
          "fork_stream_dispatches": counters["fork_stream_dispatches"],
          "device_batch_hits": counters["device_batch_hits"],
          "router_device_found": counters["router_device_found"],
          "router_host_settled": counters["router_host_settled"],
          "router_trivial_settled": counters["router_trivial_settled"],
          "kernel_launches": fork["launches"],
          "streams": _stream_rows(fork_streams),
          "breakdown": _breakdown(fork, fork_s)})
    return {"launches": cold["launches"], "fork_launches": fork["launches"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# -- the frontier phase -------------------------------------------------------


def _op_family(name: str) -> str:
    for family in ("PUSH", "DUP", "SWAP"):
        if name.startswith(family):
            return family
    return name


def _packed_outputs(nine) -> list:
    """step_batch's nine results as the wrapper's ten numpy arrays (the
    store log and the fork words stacked on axis 1)."""
    import numpy as np

    (stack_out, mem, written, msize, min_gas, max_gas, ok, mem_log,
     fork_out) = nine
    rows = ok.shape[0]

    def stacked(items, shape):
        return (np.stack(items, axis=1) if items
                else np.zeros(shape, dtype=np.int32))

    return [stack_out, mem, written, msize, min_gas, max_gas, ok,
            stacked([off for off, _value in mem_log], (rows, 0)),
            stacked([value for _off, value in mem_log], (rows, 0, 32)),
            stacked(list(fork_out), (rows, 0, 32))]


def _hold_frontier(run, frame, device):
    """K6 against its plain version on one frame, through the tensor
    wrapper and through the packed step the stepper takes: the ok masks
    must be equal and every output equal on the ok rows. Returns (ok rows,
    largest absolute difference on them); launches made here are not
    counted."""
    import numpy as np

    from mythril_tpu_torch.gpu import frontier_kernel
    from mythril_tpu_torch.laser.frontier import kernel

    launches = frontier_kernel.launches
    got = frontier_kernel.run_step_kernel(
        run, *kernel.frame_tensors(frame, device))
    got = [tensor.cpu().numpy() for tensor in got]
    want = [tensor.cpu().numpy() for tensor in kernel.step_plain(
        run, *kernel.frame_tensors(frame, device))]
    packed = _packed_outputs(kernel.step_batch(run, frame, "cuda", device))
    frontier_kernel.launches = launches
    ok = want[6]
    err = 0
    for path, outputs in (("wrapper", got), ("packed step", packed)):
        if not np.array_equal(outputs[6], ok):
            raise AssertionError(
                f"K6's ok mask ({path}) differs from its plain version's "
                f"on {run.op_names}: {int((outputs[6] != ok).sum())} rows")
        for index, (x, y) in enumerate(zip(outputs, want)):
            if x.shape != y.shape or not np.array_equal(x[ok], y[ok]):
                raise AssertionError(
                    f"K6 ({path}) disagrees with its plain version on "
                    f"output {index} of {run.op_names}")
            if x[ok].size:
                err = max(err, int(np.abs(x[ok].astype(np.int64)
                                          - y[ok].astype(np.int64)).max()))
    return int(ok.sum()), err


def _frontier_bound(run, frame, ok_rows):
    """Least time for one step: the bytes the step must move over the HBM
    rate, against the 32-bit word operations over the CUDA-core rate (8
    per word op, 72 per MUL: 64 digit products and a carry pass; 80 per
    DIV/MOD/SDIV/SMOD: long division on 32-bit digits does at most 20
    digit multiply-subtracts, (9 - n) x n for an n-digit divisor, of 4
    word operations each). The bytes: every row's stack words in
    and out, its scalars, its store log and fork words and the 32-byte
    word each MLOAD reads; and the bytes each MSTORE (32) and MSTORE8 (1)
    writes to the window and its mask (4 + 1 a byte), counted on the
    rows that end ok (a row stores nothing once it is not ok). The op
    table is read once. Untouched window bytes are not counted: the step
    updates the window in place."""
    from mythril_tpu_torch.gpu import frontier_kernel

    rows = frame.batch
    kinds = [op.kind for op in run.ops]
    n_log = frontier_kernel.log_stores(run)
    n_fork = frontier_kernel.fork_words(run)
    ops_table, consts = frontier_kernel.encode_program(run)
    per_row = (run.touch * 128 + run.out_len * 128
               + kinds.count("mload") * 32 * 4
               + n_log * (4 + 128) + n_fork * 128
               + 4 * 4 + 1 + 3 * 4 + 1)
    per_ok_row = ((kinds.count("mstore") * 32 + kinds.count("mstore8"))
                  * (4 + 1))
    moved = (rows * per_row + ok_rows * per_ok_row + ops_table.nbytes
             + consts.nbytes)
    cost = {"mul": 72, "div": 80, "mod": 80, "sdiv": 80, "smod": 80}
    ops = rows * sum(cost.get(op.arg, 8) if op.kind == "bin" else 8
                     for op in run.ops)
    byte_s, op_s = moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations", moved, ops)


def _step_device_ms(run, frame, device, repeats=50):
    """K6's device time on one packed step the stepper takes, from
    torch.profiler over `repeats` steps after a warm-up ("not measured"
    where the profiler shows none, and on the CPU)."""
    from mythril_tpu_torch.laser.frontier import kernel

    if device.type != "cuda":
        return "not measured"

    def steps():
        for _ in range(repeats):
            kernel.step_batch(run, frame, "cuda", device)

    steps()
    _result, _device_us, kernel_us = _profile_device(
        steps, "frontier_step_kernel")
    return kernel_us / 1e3 / repeats if kernel_us > 0 else "not measured"


def _time_frontier(run, frame, device, window, counts=None):
    """K6 timed on `frame`, after it is held against its plain version
    there: the kernel alone (`device_ms`: its device time from the
    profiler on the stepper's packed steps; `ms`: back-to-back launches
    into outputs allocated once,
    under CUDA events, which the Python launch path floors), the wrapper
    (`wrapper_ms`: checks, allocation and the launch, per call), the whole
    host step (`host_step_ms`: the packed step the stepper takes, one
    copy up, the launch, one copy down) and the plain version. Launches
    made here are not counted. Emits one record and returns it."""
    from mythril_tpu_torch.gpu import frontier_kernel
    from mythril_tpu_torch.laser.frontier import kernel

    ok_rows, err = _hold_frontier(run, frame, device)
    launches = frontier_kernel.launches
    tensors = kernel.frame_tensors(frame, device)
    ms = "not measured"  # on the CPU, which has no kernel to launch
    if device.type == "cuda":
        _outputs, launch = frontier_kernel.prepare_launch(run, *tensors)
        ms = _time_ms(launch, repeats=200)
    device_ms = _step_device_ms(run, frame, device)
    wrapper_ms = _time_ms(
        lambda: frontier_kernel.run_step_kernel(run, *tensors), repeats=50)
    plain_ms = _time_ms(lambda: kernel.step_plain(run, *tensors), repeats=2)
    kernel.step_batch(run, frame, "cuda", device)  # warm
    torch_sync(device)
    start = time.monotonic()
    for _ in range(20):
        kernel.step_batch(run, frame, "cuda", device)
    host_step_ms = (time.monotonic() - start) / 20 * 1e3
    frontier_kernel.launches = launches
    bound_ms, bound_by, moved, ops = _frontier_bound(run, frame, ok_rows)
    record = {"phase": "frontier", "window": window,
              "rows": frame.batch, "ops": len(run.ops),
              "op_names": list(run.op_names), "touch": run.touch,
              "out_len": run.out_len, "memory_window": frame.mem.shape[1],
              "block_rows": getattr(frontier_kernel, "block_rows",
                                    lambda _capacity: None)(run.capacity),
              **(counts or {}), "ok_rows": ok_rows,
              "equal_on_ok_rows": True, "max_abs_err": err,
              "device_ms": device_ms,
              "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
              "host_step_ms": host_step_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
              "word_ops": ops}
    emit(record)
    return record


def _timed_program(rng):
    """A fixed run for the 64-row timing: the first generated run of at
    least 16 micro-ops with a division and a memory op in it."""
    from mythril_tpu_torch.support.workloads import (
        frontier_program,
        frontier_run,
    )

    while True:
        code, init_stack = frontier_program(rng,
                                            edge_bias=FRONTIER_EDGE_BIAS)
        run = frontier_run(code)
        if (run is not None and len(run.ops) >= 16 and run.has_mem
                and any(op.arg in ("div", "mod", "sdiv", "smod")
                        for op in run.ops)):
            return run, init_stack


# K7's own batch: DIVISION_PAIRS divisions a row, each followed by a POP
DIVISION_PAIRS = 12
_DIVISIONS = (0x04, 0x06, 0x05, 0x07)  # DIV, MOD, SDIV, SMOD


def _division_batch(rng, rows):
    """(run, frame): a run of DIV, MOD, SDIV and SMOD in turn, each
    followed by a POP, over `rows` rows whose windows hold random
    dividends over random divisors of 1 to 8 words."""
    from mythril_tpu_torch.support.workloads import (
        frontier_frame,
        frontier_run,
    )

    code = b"".join(bytes([_DIVISIONS[k % 4], 0x50])
                    for k in range(DIVISION_PAIRS))
    run = frontier_run(code + b"\x00")
    frame = frontier_frame(rng, run, rows, starved_share=0.0)
    for i in range(rows):
        for k in range(DIVISION_PAIRS):
            dividend = rng.getrandbits(256)
            divisor = rng.getrandbits(32 * rng.randint(1, 8)) | 1
            top = run.touch - 1 - 2 * k  # this pair's dividend
            for j, value in ((top, dividend), (top - 1, divisor)):
                frame.stack[i, j] = list(value.to_bytes(32, "big"))
    return run, frame


def phase_frontier(device):
    """K6 on random runs and its times on a 64-row batch (see the module
    note). Returns the 64-row timing record."""
    from mythril_tpu_torch.support.workloads import (
        frontier_frame,
        frontier_program,
        frontier_run,
    )

    rng = random.Random(SEED + 31)
    checked = rows = ok_rows = err = 0
    families = {}
    start = time.monotonic()
    while checked < FRONTIER_RUNS:
        code, init_stack = frontier_program(rng,
                                            edge_bias=FRONTIER_EDGE_BIAS)
        run = frontier_run(code)
        if run is None:
            continue
        frame = frontier_frame(rng, run, rng.randint(1, 64), init_stack,
                               edge_bias=FRONTIER_EDGE_BIAS)
        n_ok, run_err = _hold_frontier(run, frame, device)
        checked += 1
        rows += frame.batch
        ok_rows += n_ok
        err = max(err, run_err)
        for family in {_op_family(name) for name in run.op_names}:
            families[family] = families.get(family, 0) + 1
    emit({"phase": "frontier", "window": "random-runs", "runs": checked,
          "rows": rows, "ok_rows": ok_rows, "runs_by_opcode": families,
          "equal_on_ok_rows": True, "max_abs_err": err,
          "seconds": time.monotonic() - start})
    run, init_stack = _timed_program(random.Random(SEED + 37))
    frame = frontier_frame(random.Random(SEED + 41), run, 64, init_stack,
                           edge_bias=FRONTIER_EDGE_BIAS, starved_share=0.0)
    timed = _time_frontier(run, frame, device, "synthetic-64")
    # the launch floor: a 1-row, 3-op run with no memory
    floor_run = frontier_run(bytes([0x60, 0x01, 0x60, 0x02, 0x01, 0x00]))
    floor = _time_frontier(floor_run,
                           frontier_frame(random.Random(1), floor_run, 1,
                                          starved_share=0.0),
                           device, "launch-floor")
    run, frame = _division_batch(random.Random(SEED + 43), 64)
    division = _time_frontier(run, frame, device, "division-64")
    # the same batch with ADD in place of every division: the rest of the
    # step, so the difference is K7's
    control_run = frontier_run(b"".join(bytes([0x01, 0x50])
                                        for _ in range(DIVISION_PAIRS))
                               + b"\x00")
    control = _time_frontier(control_run, frame, device, "division-control")
    return {**timed, "max_abs_err": max(err, timed["max_abs_err"],
                                        division["max_abs_err"],
                                        control["max_abs_err"]),
            "floor": floor, "division": division, "control": control}


# -- the analyze phase --------------------------------------------------------

# the unprotected-selfdestruct contract of tests/test_analysis.py and the
# 15-byte creation wrapper that deploys it
KILLBILLY_EASM = """
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0xe0
    SHR
    DUP1
    PUSH4 0x41c0e1b5
    EQ
    PUSH1 @kill
    JUMPI
    STOP
:kill
    JUMPDEST
    CALLER
    SELFDESTRUCT
"""


def _killbilly_creation() -> str:
    from mythril_tpu_torch.disasm.asm import easm_to_code

    runtime = easm_to_code(KILLBILLY_EASM)
    init = easm_to_code(f"""
        PUSH2 0x{len(runtime):04x}
        PUSH1 0x0f
        PUSH1 0x00
        CODECOPY
        PUSH2 0x{len(runtime):04x}
        PUSH1 0x00
        RETURN
        STOP
    """)
    if len(init) != 15:
        raise AssertionError("the creation wrapper must be 15 bytes")
    return (init + runtime).hex()


def _analyze_inputs():
    """(name, creation code hex, transaction count, execution timeout,
    compared?) of each analyze run."""
    inputs = [("killbilly", _killbilly_creation(), 2, ANALYZE_TIMEOUT, True)]
    for name in CORPUS:
        with open(os.path.join("bench_inputs", "corpus", name)) as handle:
            inputs.append((name, handle.read().strip(), 1, ANALYZE_TIMEOUT,
                           True))
    with open(os.path.join("bench_inputs", "stress_dispatch.hex")) as handle:
        inputs.append(("stress_dispatch.hex", handle.read().strip(), 1,
                       STRESS_TIMEOUT, False))
    return inputs


class _TimeoutLines(logging.Handler):
    """The engine's "... timeout reached" lines: a run that logs one
    explored a prefix that depends on the machine's speed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        if "timeout reached" in record.getMessage():
            self.lines.append(record.getMessage())


def _issue_keys(report):
    return sorted([issue.swc_id, issue.function, issue.address, issue.title]
                  for issue in report.issues.values())


FRONTIER_KEYS = (
    "frontier_vmap_steps", "frontier_states_stepped",
    "frontier_batch_slots", "frontier_fallback_exits",
    "frontier_fallback_dialect", "frontier_fallback_dynamic",
    "frontier_fallback_hook", "frontier_fallback_symbolic",
    "frontier_batch_bails", "frontier_symlane_rows", "frontier_forks",
    "frontier_fork_rows", "frontier_fork_cohort_rows",
    "frontier_fork_infeasible_pruned")


def _copy_frame(dense):
    """The step's inputs of a frame (not the symbolic lane's handles)."""
    from mythril_tpu_torch.laser.frontier.dense import DenseFrontier

    frame = DenseFrontier(0, 0, 1)
    for name in ("stack", "depth", "mem", "mem_written", "msize", "pc",
                 "min_gas", "max_gas", "gas_limit", "live"):
        setattr(frame, name, getattr(dense, name).copy())
    return frame


@contextlib.contextmanager
def _frontier_backend(backend):
    """MYTHRIL_GPU_FRONTIER_BACKEND pinned inside the block (None: auto)."""
    saved = os.environ.pop("MYTHRIL_GPU_FRONTIER_BACKEND", None)
    if backend is not None:
        os.environ["MYTHRIL_GPU_FRONTIER_BACKEND"] = backend
    try:
        yield
    finally:
        os.environ.pop("MYTHRIL_GPU_FRONTIER_BACKEND", None)
        if saved is not None:
            os.environ["MYTHRIL_GPU_FRONTIER_BACKEND"] = saved


@contextlib.contextmanager
def _keep_largest_batch(batches):
    """Keep the largest frontier batch (rows x micro-ops) the CUDA step
    takes inside the block: batches gets "size", "run" and "frame". Where
    batches holds an "every" list, every (run, frame) is added to it."""
    from mythril_tpu_torch.laser.frontier import kernel

    def keep(run, dense):
        size = dense.batch * len(run.ops)
        if size > batches.get("size", -1):
            batches.update(size=size, run=run, frame=_copy_frame(dense))
        if "every" in batches:
            batches["every"].append((run, _copy_frame(dense)))

    kernel.on_cuda_step = keep
    try:
        yield
    finally:
        kernel.on_cuda_step = None


def _split_by_deferred(events, name):
    """{"deferred"|"plain": {spans, seconds, and the sums of the spans'
    size attributes}} of one span name: the fork-pair members' prepares
    (under the deferred-forcing sweep) apart from every other query's."""
    split = {"deferred": {"spans": 0, "seconds": 0.0},
             "plain": {"spans": 0, "seconds": 0.0}}
    for event in events:
        if event["name"] != name:
            continue
        attrs = event.get("args", {})
        row = split["deferred" if attrs.get("deferred") else "plain"]
        row["spans"] += 1
        row["seconds"] += event["dur"] / 1e6
        for key in ("clauses", "rounds", "units", "roots"):
            if key in attrs:
                row[key] = row.get(key, 0) + attrs[key]
    return split


@contextlib.contextmanager
def _telemetry_env(name, ring_cap=None):
    """Every telemetry artifact of one run on: the stats JSON, the
    heartbeat (every HEARTBEAT_INTERVAL_S), the Prometheus file and the
    flight-recorder dumps, under OUT_DIR/telemetry/<name>/ (emptied
    first), and the ring at `ring_cap` spans (None: the default). Yields
    their paths."""
    folder = os.path.join(OUT_DIR, "telemetry", name)
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    paths = {"stats": os.path.join(folder, "stats.json"),
             "heartbeat": os.path.join(folder, "heartbeat.jsonl"),
             "prom": os.path.join(folder, "metrics.prom"),
             "flightrec": os.path.join(folder, "flightrec")}
    env = {"MYTHRIL_GPU_STATS_JSON": paths["stats"],
           "MYTHRIL_GPU_HEARTBEAT": paths["heartbeat"],
           "MYTHRIL_GPU_HEARTBEAT_INTERVAL": str(HEARTBEAT_INTERVAL_S),
           "MYTHRIL_GPU_PROM": paths["prom"],
           "MYTHRIL_GPU_FLIGHTREC_DIR": paths["flightrec"]}
    if ring_cap is not None:
        env["MYTHRIL_GPU_FLIGHTREC_CAP"] = str(ring_cap)
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield paths
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@contextlib.contextmanager
def _calibration_launches(counts):
    """Adds to counts["launches"] the K1 launches the router's calibration
    makes inside the block (the stats JSON's kernel_launches counts the
    solve rounds only)."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu.router import QueryRouter

    measure = QueryRouter._measure_kernel_rate

    def counted(self, *args, **kwargs):
        before = ragged_kernel.launches
        try:
            return measure(self, *args, **kwargs)
        finally:
            counts["launches"] = (counts.get("launches", 0)
                                  + ragged_kernel.launches - before)

    QueryRouter._measure_kernel_rate = counted
    try:
        yield counts
    finally:
        QueryRouter._measure_kernel_rate = measure


def _last_span(events, name):
    return next((event for event in reversed(events)
                 if event["name"] == name), None)


def _check_telemetry(device, name, paths, record, ring, events, dump):
    """The run's telemetry against the card and the smoke's own counts
    (see the module note). Emits one "telemetry" record; raises on any
    failed check."""
    import torch

    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.observe import roofline
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    failures = []
    with open(paths["stats"]) as fd:
        stats = json.load(fd)
    with open(paths["heartbeat"]) as fd:
        beats = [json.loads(line) for line in fd]
    platform = (torch.cuda.get_device_name(0) if device.type == "cuda"
                else "cpu")
    kernel_backend = ragged_kernel.kernel_mode()
    if stats["completed"] is not True:
        failures.append("completed is not true")
    if stats["platform"] != platform:
        failures.append(f"platform {stats['platform']!r}, not {platform!r}")
    if stats["kernel_backend"] != kernel_backend:
        failures.append(f"kernel_backend {stats['kernel_backend']!r}")
    stages = stats["roofline"]["stages"]
    if set(stages) != set(roofline.STAGES):
        failures.append(f"roofline stages {sorted(stages)}")
    for stage in ("kernel", "pack", "ragged", "settle"):
        if stages.get(stage, {}).get("attainable") is None:
            failures.append(f"no attainable rate for {stage}")
    wall = stats["roofline"]["wall"]
    # six values rounded to 4 decimals: the sum may miss by their rounding
    excess = sum(wall[key] for key in ("prepare_s", "settle_s",
                                       "crosscheck_s", "device_s",
                                       "other_s")) - wall["solver_total_s"]
    if abs(excess) > 6 * 0.5e-4 and wall["attributed_frac"] != 1.0:
        failures.append(f"the wall does not reconcile: excess {excess}")
    solve_launches = (record["kernel_launches"]
                      - record["calibration_launches"])
    if stats["kernel_launches"] != solve_launches:
        failures.append(f"kernel_launches {stats['kernel_launches']} "
                        f"against the smoke's {solve_launches}")
    if stats["resilience_deadline_trips"]:
        failures.append("a clean run tripped the dispatch deadline")
    if stats["frontier_vmap_steps"] != record["k6_launches"]:
        failures.append(f"frontier_vmap_steps "
                        f"{stats['frontier_vmap_steps']} against K6's "
                        f"{record['k6_launches']} launches")
    seqs = [beat["seq"] for beat in beats]
    if len(beats) < 2 or any(b <= a for a, b in zip(seqs, seqs[1:])):
        failures.append(f"heartbeat seqs {seqs}")
    final = beats[-1] if beats else {}
    if final.get("final") is not True:
        failures.append("the last beat is not final")
    fields = SolverStatistics._COUNTERS + SolverStatistics._TIMERS
    differ = [key for key in fields
              if final.get("counters", {}).get(key) != stats[key]]
    if differ:
        failures.append(f"final beat differs from the stats JSON: {differ}")
    spans_after = {}
    for span_name in ("router.dispatch", "laser.frontier_step"):
        last = _last_span(events, span_name)
        if last is None:
            failures.append(f"the run made no {span_name} span")
            continue
        spans_after[span_name] = len(events) - 1 - events.index(last)
        if last not in ring:
            failures.append(f"the ring lost the last {span_name} span")
    try:
        with open(dump) as fd:
            dumped = json.load(fd)
        if dumped["trigger"]["event"] != "smoke" or not dumped["events"]:
            failures.append("the manual dump has no events")
    except (TypeError, OSError, ValueError, KeyError) as error:
        failures.append(f"the manual dump is not readable: {error!r}")
    rows = {stage: {key: row.get(key) for key in (
        "work", "busy_s", "attained", "attainable", "sol_gap_s",
        "headroom")} for stage, row in stages.items()}
    telemetry = {
        "phase": "telemetry", "contract": name, "platform": stats["platform"],
        "kernel_backend": stats["kernel_backend"],
        "completed": stats["completed"], "roofline": rows, "wall": wall,
        "wall_terms_excess_s": round(excess, 6),
        "top_gaps": roofline.top_gaps(stats["roofline"], n=3),
        "kernel_launches": stats["kernel_launches"],
        "k1_launches_counted": record["kernel_launches"],
        "k1_calibration_launches": record["calibration_launches"],
        "frontier_vmap_steps": stats["frontier_vmap_steps"],
        "k6_launches": record["k6_launches"], "beats": len(beats),
        "ring_events": len(ring), "spans_after_last": spans_after,
        "dump": dump,
        "failed_checks": failures}
    emit(telemetry)
    if failures:
        raise AssertionError(f"telemetry: {name}: {failures}")
    return telemetry


def _analyze_once(device, code, tx_count, timeout, solver_backend, largest,
                  frontier_backend=None, batches=None, engine=None,
                  telemetry=None):
    """One in-process analyze from fresh solve state, counted: (report,
    completed, record). `largest` keeps the largest stream (by gates) the
    backend sends K1 (the calibration's own stream does not pass there,
    nor a stream past K1's capacities, which runs on K2), `batches` the
    largest frontier batch K6 steps;
    `frontier_backend` pins the frontier's step (None: auto, which is the
    host step for solver_backend "cpu" and K6 for "gpu"); `engine` adds
    CLI options (e.g. {"no_frontier_fork": True}; "bin_runtime" loads
    `code` as runtime code); `telemetry` names the
    run's folder of telemetry artifacts, all on and checked (None: none
    written)."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.gpu import frontier_kernel, ragged_kernel, xla_kernel
    from mythril_tpu_torch.gpu.backend import get_device_backend
    from mythril_tpu_torch.observe import flightrec
    from mythril_tpu_torch.observe.tracer import get_tracer
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    device_arg = None if device.type == "cuda" else device
    args.reset()
    clear_caches()  # a fresh router, scheduler, memos and engine state
    frontend._global_blaster = None
    backend = get_device_backend(device_arg)
    caps = ragged_kernel.kernel_caps()

    def keep(stream, entries):
        # K1's streams only: one past its capacities runs on K2
        if (stream.v1 > caps.var_cap or stream.cone_slots > caps.cone_cap
                or stream.max_roots > caps.root_cap):
            return
        gates = sum(pc.num_gates for pc, _extra in entries)
        if gates > largest.get("gates", -1):
            largest.update(gates=gates, stream=stream, entries=entries)

    backend.on_stream = keep
    # the stats JSON's device figures and roofline read this run alone
    backend.reset_stats()
    before = backend.stats()
    stats = SolverStatistics()
    stats.reset()
    tracer = get_tracer()
    tracer.reset()
    tracer.enable(None)
    watch = _TimeoutLines()
    logger = logging.getLogger("mythril_tpu_torch.laser.svm")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(watch)
    launches_before = ragged_kernel.launches
    k2_before = xla_kernel.launches
    frontier_kernel.reset_launches()  # K6's count for this run starts here
    engine = dict(engine or {})
    bin_runtime = engine.pop("bin_runtime", False)
    cmd_args = SimpleNamespace(
        execution_timeout=timeout, transaction_count=tx_count,
        max_depth=128, solver_backend=solver_backend,
        torch_device=device_arg, pruning_factor=1.0, **engine)
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(code, bin_runtime=bin_runtime)
    calibration = {}
    ring = dump = None
    with (_telemetry_env(telemetry, CHECKED_RING_CAP) if telemetry
          else contextlib.nullcontext()) as paths, \
            _calibration_launches(calibration):
        torch_sync(device)
        start = time.monotonic()
        try:
            with _frontier_backend(frontier_backend), \
                    _keep_largest_batch(batches if batches is not None
                                        else {}):
                analyzer = MythrilAnalyzer(disassembler, cmd_args=cmd_args)
                report = analyzer.fire_lasers(transaction_count=tx_count)
            torch_sync(device)
            wall = time.monotonic() - start
            k6_launches = frontier_kernel.launches  # ... and ends here
        finally:
            backend.on_stream = None
            logger.removeHandler(watch)
            logger.setLevel(level)
            spans = tracer.summary()
            events = tracer.events()
            if paths is not None:
                ring = tracer.ring_events()
                flightrec.reset()
                dump = flightrec.dump_now("smoke")
            tracer.reset()
            args.reset()
    if report.exceptions:
        raise AssertionError(f"analyze raised: {report.exceptions[0]}")
    after = backend.stats()
    counters = stats.as_dict()

    def span_s(name):
        return spans.get(name, [0, 0.0])[1]

    record = {
        "wall_s": wall, "completed": not watch.lines,
        "solver_s": stats.solver_time, "interp_s": stats.interp_wall,
        "prepare_s": stats.prepare_wall,
        "router": {"plan_s": span_s("router.plan"),
                   "calibration_s": span_s("router.calibrate"),
                   "land_s": span_s("router.land"),
                   "stream_assembly_upload_s":
                       round(after["ragged_seconds"]
                             - before["ragged_seconds"], 4),
                   "round_loop_s": round(after["solve_seconds"]
                                         - before["solve_seconds"], 4),
                   "device_check_s": span_s("device.check"),
                   "router_settle_s": span_s("router.settle_components"),
                   "dispatch_s": span_s("router.dispatch")},
        "cdcl_settle_pass_s": span_s("solver.settle_pass"),
        "kernel_launches": ragged_kernel.launches - launches_before,
        # of them the router's calibration, not solve rounds
        "calibration_launches": calibration.get("launches", 0),
        # K2's: the xla mode's rounds, or the pallas mode's fallback
        "k2_launches": xla_kernel.launches - k2_before,
        "k6_launches": k6_launches,
        "frontier": {**{key: counters[key] for key in FRONTIER_KEYS},
                     "frontier_batch_occupancy":
                         counters["frontier_batch_occupancy"]},
        "batched_queries": counters["batch_query_count"],
        "device_batch_queries": counters["device_batch_queries"],
        "device_batch_hits": counters["device_batch_hits"],
        "router_device_found": counters["router_device_found"],
        "router_host_settled": counters["router_host_settled"],
        "router_trivial_settled": counters["router_trivial_settled"],
        "router_host_direct": counters["router_host_direct"],
        # components K1 was sent and solved, and those the router planned
        # for its in-router host settle (a query with one of those counts
        # as router_host_settled even when K1 solved all the others)
        "aig_device_components": counters["aig_device_components"],
        "aig_device_component_hits": counters["aig_device_component_hits"],
        "aig_host_components": counters["aig_host_components"],
        "cap_rejects": counters["cap_rejects"],
        # the dispatches the deadline runner guarded, and its hand-offs
        "runner_calls": counters["deadline_runner_calls"],
        "runner_handoff_s": counters["deadline_handoff_wall"],
        "cdcl_settles": counters["cdcl_settles"],
        "single_queries": counters["query_count"],
        # {span: [count, seconds]}; spans nest, so they do not sum
        "spans": spans,
        "cnf_prep_split": _split_by_deferred(events, "solver.cnf_prep"),
        "aig_opt_split": _split_by_deferred(events, "solver.aig_opt"),
        "findings": _issue_keys(report)}
    if paths is not None:
        _check_telemetry(device, telemetry, paths, record, ring, events,
                         dump)
    return report, not watch.lines, record


def _analyze_contract(device, name, code, tx_count, timeout, compared,
                      largest, batches):
    """One contract on both backends, and for CUDA_HOST_RUNS once more on
    the host CDCL with K6 stepping the frontier (see the module note).
    Returns the device backend's (device_batch_hits,
    aig_device_component_hits, K6 launches), the K6 launches of the
    host-CDCL run, the device backend's deadline-runner (calls, hand-off
    seconds), and each leg's record."""
    keys, completed, reports, frontier, records = {}, {}, {}, {}, {}
    hits = k1_hits = k6_launches = host_k6_launches = 0
    runner = (0, 0.0)
    legs = [("cpu", None), ("gpu", None)]
    if name in CUDA_HOST_RUNS:
        legs.append(("cpu", "cuda"))
    for solver_backend, frontier_backend in legs:
        leg = solver_backend + ("+cuda-frontier" if frontier_backend else "")
        report, done, record = _analyze_once(
            device, code, tx_count, timeout, solver_backend,
            largest if solver_backend == "gpu" else {},
            frontier_backend=frontier_backend,
            batches=batches if solver_backend == "gpu" else None,
            telemetry=name if solver_backend == "gpu" else None)
        keys[leg] = _issue_keys(report)
        completed[leg] = done
        records[leg] = record
        reports[leg] = (report.as_json(), report.as_text())
        frontier[leg] = record["frontier"]
        if solver_backend == "gpu":
            hits = record["device_batch_hits"]
            k1_hits = record["aig_device_component_hits"]
            k6_launches = record["k6_launches"]
            runner = (record["runner_calls"], record["runner_handoff_s"])
        elif frontier_backend == "cuda":
            host_k6_launches = record["k6_launches"]
        emit({"phase": "analyze", "contract": name, "tx": tx_count,
              "backend": solver_backend,
              "frontier_step": frontier_backend or (
                  "cuda" if solver_backend == "gpu" else "numpy"),
              "execution_timeout": timeout, **record})
    if compared and not all(completed.values()):
        raise AssertionError(f"analyze: {name} did not complete inside "
                             f"{timeout} s: {completed}")
    if (compared or all(completed.values())) and keys["gpu"] != keys["cpu"]:
        raise AssertionError(f"analyze: {name}: the device backend's "
                             f"findings {keys['gpu']} differ from the "
                             f"host's {keys['cpu']}")
    if "cpu+cuda-frontier" in reports:
        if reports["cpu+cuda-frontier"] != reports["cpu"]:
            raise AssertionError(f"analyze: {name}: the host-CDCL report "
                                 f"with K6 stepping the frontier differs "
                                 f"from the host step's")
        if frontier["cpu+cuda-frontier"] != frontier["cpu"]:
            raise AssertionError(f"analyze: {name}: the frontier counters "
                                 f"with K6 differ from the host step's: "
                                 f"{frontier['cpu+cuda-frontier']} vs "
                                 f"{frontier['cpu']}")
        if host_k6_launches <= 0:
            raise AssertionError(f"analyze: {name}: K6 was never launched "
                                 f"on the host-CDCL run")
    return hits, k1_hits, k6_launches, host_k6_launches, runner, records


def _hold_stream(device, stream, window, counts, timed=True,
                 phase="analyze"):
    """K1 bit for bit against its plain version on `stream`, and both timed
    there unless `timed` is false; launches made here are not counted.
    Emits one record."""
    import torch

    from mythril_tpu_torch.gpu import circuit, ragged_kernel
    from mythril_tpu_torch.gpu.backend import get_device_backend

    launches = ragged_kernel.launches
    backend = get_device_backend(None if device.type == "cuda" else device)
    caps = ragged_kernel.kernel_caps()
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 11)
    lanes = ragged_kernel.pad_lanes(backend.num_restarts, caps)
    x = circuit.init_inputs(gen, lanes, caps.var_cap, device)
    steps, walk_depth = backend.CIRCUIT_STEPS, _walk_depth(stream)
    err, plain_ms = _compare_timed(flat, x, 23, steps, walk_depth, caps)
    ms = None
    if timed:
        ms = _time_ms(lambda: ragged_kernel.run_round_ragged_kernel(
            flat, x, 23, steps, walk_depth, caps), repeats=5)
    else:
        plain_ms = None
    ragged_kernel.launches = launches
    bound_ms, bound_by, moved, ops = _bound(flat, stream.v1, lanes, steps,
                                            caps)
    emit({"phase": phase, "window": window,
          **_stream_fields(stream, flat), "lanes": lanes, "steps": steps,
          "walk_depth": walk_depth,
          "global_path_cones": list(flat.cones.global_cones), **counts,
          "bit_identical": True, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": moved, "ops": ops})
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _frontier_idle(device, steps):
    """The device's idle share over one analyze contract's frontier steps,
    replayed through the packed step: the steps' host wall (a warm pass,
    perf_counter around each step) against the device time the profiler
    saw in a second pass (K6 and the copies). Emits one record."""
    from mythril_tpu_torch.gpu import frontier_kernel
    from mythril_tpu_torch.laser.frontier import kernel

    def replay():
        for run, frame in steps:
            kernel.step_batch(run, frame, "cuda", device)

    launches = frontier_kernel.launches
    replay()  # the programs onto the card
    wall = 0.0
    for run, frame in steps:
        start = time.perf_counter()
        kernel.step_batch(run, frame, "cuda", device)
        wall += time.perf_counter() - start
    device_us = kernel_us = 0.0
    if device.type == "cuda":
        _result, device_us, kernel_us = _profile_device(
            replay, "frontier_step_kernel")
    frontier_kernel.launches = launches
    record = {"phase": "analyze", "window": "frontier-idle",
              "contract": IDLE_CONTRACT, "steps": len(steps),
              "rows": sum(frame.batch for _run, frame in steps),
              "host_step_ms": wall / max(len(steps), 1) * 1e3,
              "steps_wall_s": wall}
    if device_us > 0:
        record.update(device_busy_s=device_us / 1e6,
                      k6_device_s=kernel_us / 1e6,
                      device_idle_share=1 - device_us / 1e6 / wall)
    else:
        record.update(device_idle_share="not measured")
    emit(record)
    return record


def phase_analyze(device):
    """The port's `analyze` on both backends (see the module note).
    Returns K1's launches over the five compared contracts, its comparison
    and times on the largest stream they launched, and stress_dispatch's
    launches apart: its runs are cut by the clock, so their count depends
    on the host's speed; and K6's launches on the same runs, with its
    comparison and times on the largest frontier batch; and K2's launches
    on either (a cone past K1's capacities runs on K2)."""
    from mythril_tpu_torch.gpu import ragged_kernel, xla_kernel

    inputs = _analyze_inputs()
    largest, stress_largest, batches = {}, {}, {}
    hits = k1_hits = k6_launches = host_k6_launches = 0
    ragged_kernel.reset_launches()  # the compared runs' count starts here
    xla_kernel.reset_launches()
    steps = []
    runner_calls, runner_s = 0, 0.0
    records = {}
    for name, code, tx_count, timeout, compared in inputs:
        if compared:
            if name == IDLE_CONTRACT:
                batches["every"] = steps
            found = _analyze_contract(device, name, code, tx_count,
                                      timeout, True, largest, batches)
            records[name] = found[5]
            batches.pop("every", None)
            hits, k1_hits = hits + found[0], k1_hits + found[1]
            k6_launches += found[2]
            host_k6_launches += found[3]
            runner_calls += found[4][0]
            runner_s += found[4][1]
    launches = ragged_kernel.launches  # ... and ends here
    k2_launches = xla_kernel.launches
    # the deadline runner's cost over every guarded dispatch of the five
    emit({"phase": "analyze", "runner_calls": runner_calls,
          "runner_handoff_s": runner_s})
    if launches <= 0:
        raise AssertionError("analyze: K1 was never launched")
    if hits <= 0:
        raise AssertionError("analyze: the router returned no model")
    if k1_hits <= 0:
        raise AssertionError("analyze: K1 solved no component it was sent")
    if k6_launches <= 0 or not batches:
        raise AssertionError("analyze: K6 was never launched")
    ragged_kernel.reset_launches()  # stress_dispatch's count starts here
    xla_kernel.reset_launches()
    stress_k6 = 0
    for name, code, tx_count, timeout, compared in inputs:
        if not compared:
            stress_k6 += _analyze_contract(device, name, code, tx_count,
                                           timeout, False, stress_largest,
                                           {})[2]
    stress_launches = ragged_kernel.launches  # ... and ends here
    k2_stress = xla_kernel.launches

    held = _hold_stream(device, largest["stream"], "analyze-stream",
                        {"kernel_launches": launches,
                         "device_batch_hits": hits,
                         "aig_device_component_hits": k1_hits})
    err = held["max_abs_err"]
    if stress_largest:
        err = max(err, _hold_stream(
            device, stress_largest["stream"], "stress-stream",
            {"kernel_launches": stress_launches})["max_abs_err"])
    k6 = _time_frontier(batches["run"], batches["frame"], device,
                        "analyze-largest-batch",
                        {"k6_launches": k6_launches,
                         "k6_launches_host_cdcl": host_k6_launches,
                         "k6_launches_stress": stress_k6})
    idle = _frontier_idle(device, steps) if steps else {}
    return {**held, "launches": launches, "stress_launches": stress_launches,
            "k2_launches": k2_launches, "k2_stress": k2_stress,
            "max_abs_err": err, "k6": k6, "k6_launches": k6_launches,
            "k6_host_launches": host_k6_launches, "k6_stress": stress_k6,
            "frontier_idle": idle, "records": records}


@contextlib.contextmanager
def _telemetry_seconds(spent):
    """Adds to spent["s"] the CPU seconds of the calling thread spent
    inside the telemetry's own calls within the block: a span recorded
    (Tracer._record), a beat (Heartbeat.beat, on its own thread) and the
    stats JSON (_dump_stats_json). CPU time, not wall: a beat's thread
    also waits for the interpreter lock, which costs the run nothing."""
    from mythril_tpu_torch.core import MythrilAnalyzer
    from mythril_tpu_torch.observe.metrics import Heartbeat
    from mythril_tpu_torch.observe.tracer import Tracer

    patched = [(Tracer, "_record"), (Heartbeat, "beat"),
               (MythrilAnalyzer, "_dump_stats_json")]
    saved = [owner.__dict__[attr] for owner, attr in patched]

    def timed(fn):
        def wrapped(*args, **kwargs):
            start = time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                spent["s"] = spent.get("s", 0.0) + time.thread_time() - start
        return wrapped

    for (owner, attr), original in zip(patched, saved):
        if isinstance(original, staticmethod):
            setattr(owner, attr, staticmethod(timed(original.__func__)))
        else:
            setattr(owner, attr, timed(original))
    try:
        yield spent
    finally:
        for (owner, attr), original in zip(patched, saved):
            setattr(owner, attr, original)


def _overhead_leg(device, name, code, tx_count, on):
    """One device-backend analyze from fresh solve state with every
    telemetry artifact on (the flight recorder's ring at its default
    size, the heartbeat every HEARTBEAT_INTERVAL_S, the Prometheus file,
    the stats JSON) or off (MYTHRIL_GPU_FLIGHTREC=0: no ring, and nothing
    written); full tracing off in both. Returns the wall and the CPU
    seconds spent inside the telemetry's own calls."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.observe import flightrec
    from mythril_tpu_torch.observe.tracer import get_tracer
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    args.reset()
    clear_caches()
    frontend._global_blaster = None
    tracer = get_tracer()
    tracer.reset()
    saved_env = os.environ.get(flightrec.FLIGHTREC_ENV)
    if not on:
        os.environ[flightrec.FLIGHTREC_ENV] = "0"
    cmd_args = SimpleNamespace(
        execution_timeout=ANALYZE_TIMEOUT, transaction_count=tx_count,
        max_depth=128, solver_backend="gpu",
        torch_device=None if device.type == "cuda" else device,
        pruning_factor=1.0)
    disassembler = MythrilDisassembler()
    disassembler.load_from_bytecode(code)
    spent = {}
    try:
        with (_telemetry_env(f"overhead-{name}") if on
              else contextlib.nullcontext()), _telemetry_seconds(spent):
            torch_sync(device)
            start = time.monotonic()
            report = MythrilAnalyzer(
                disassembler, cmd_args=cmd_args).fire_lasers(
                    transaction_count=tx_count)
            torch_sync(device)
            wall = time.monotonic() - start
    finally:
        tracer.reset()
        if saved_env is None:
            os.environ.pop(flightrec.FLIGHTREC_ENV, None)
        else:
            os.environ[flightrec.FLIGHTREC_ENV] = saved_env
        args.reset()
    if report.exceptions:
        raise AssertionError(f"analyze raised: {report.exceptions[0]}")
    return wall, spent.get("s", 0.0)


def phase_telemetry_overhead(device, order=("off", "on"), contracts=None):
    """What the telemetry costs: each of `contracts` (OVERHEAD_CONTRACTS)
    on the device backend with every artifact off and on, in `order`.
    Emits one record a contract: the walls of each leg and the CPU
    seconds inside the telemetry's own calls."""
    inputs = {name: (code, tx_count)
              for name, code, tx_count, _timeout, _compared
              in _analyze_inputs()}
    order = list(order)
    for name in contracts or OVERHEAD_CONTRACTS:
        code, tx_count = inputs[name]
        walls = {"off": [], "on": []}
        inside = {"off": [], "on": []}
        for leg in order:
            wall, spent = _overhead_leg(device, name, code, tx_count,
                                        leg == "on")
            walls[leg].append(wall)
            inside[leg].append(spent)
        emit({"phase": "telemetry-overhead", "contract": name,
              "tx": tx_count, "order": order,
              "wall_off_s": walls["off"], "wall_on_s": walls["on"],
              "telemetry_cpu_on_s": inside["on"],
              "telemetry_cpu_off_s": inside["off"]})


# -- resilience: fault containment and the disk tier on the card ------------

# the hang case's knobs: the dispatch budget and the grace past it
HANG_DEADLINE_S = 2
HANG_GRACE_S = 2
HANG_SLACK_S = 30   # process start, CUDA set-up, exploration to the hang
RESILIENCE_TIMEOUT = 600  # s per CLI run of the phase
DISK_CONTRACT = "killbilly"  # at -t 2, as in step 3
# host sites on the device backend (KILLBILLY -t 2): spec, the site's
# events that must be counted, and whether K1 must launch in the run.
# Under aig.session:raise:* every cone stays un-rewritten, and the
# un-rewritten queries exceed the router's variable cap
# (MYTHRIL_GPU_VAR_CAP): they are cap rejects settled on the host, so the
# n1 run holds the site to K1 instead.
HOST_FAULTS = (
    ("scheduler.flush:raise:n1", ("injected", "retry"), True),
    ("prepare.incremental:raise:*", ("injected", "degraded"), True),
    ("aig.session:raise:*", ("injected", "degraded"), False),
    ("aig.session:raise:n1", ("injected", "degraded"), True),
    ("preanalysis.summary:raise:n1", ("injected", "degraded"), True),
    ("store.lock:raise:n1", ("injected", "degraded"), True),
    ("disk.write:raise:n1", ("injected", "retry"), True),
)


def _cli_analyze(device, folder, name, code_path, tx_count, extra=(),
                 env=None, timeout=RESILIENCE_TIMEOUT):
    """One `python -m mythril_tpu_torch analyze` in its own process on the
    device backend, fork pruning on, its stats JSON and flight-recorder
    dumps under `folder`/`name`: a dict of the exit code, the wall, the
    stats JSON, the findings (issue keys; None unless it exited 0 or 1)
    and the end of stderr."""
    run_dir = os.path.join(folder, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    stats_path = os.path.join(run_dir, "stats.json")
    argv = [sys.executable, "-m", "mythril_tpu_torch", "analyze",
            "-f", code_path, "-t", str(tx_count), "-o", "json",
            "--pruning-factor", "1", "--execution-timeout",
            str(ANALYZE_TIMEOUT), *extra]
    if device.type != "cuda":
        argv += ["--torch-device", "cpu"]
    start = time.monotonic()
    done = subprocess.run(
        argv, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "MYTHRIL_GPU_STATS_JSON": stats_path,
             "MYTHRIL_GPU_FLIGHTREC_DIR": os.path.join(run_dir, "flightrec"),
             **(env or {})})
    wall = time.monotonic() - start
    stats = {}
    if os.path.exists(stats_path):
        with open(stats_path) as fd:
            stats = json.load(fd)
    findings = None
    if done.returncode in (0, 1):
        issues = json.loads(done.stdout.strip().splitlines()[-1])["issues"]
        findings = sorted([i["swc-id"], i["function"], i["address"],
                           i["title"]] for i in issues)
    dumps = []
    for path in sorted(glob.glob(os.path.join(run_dir, "flightrec",
                                              "*.json"))):
        with open(path) as fd:
            dumps.append(json.load(fd)["trigger"])
    return {"rc": done.returncode, "wall_s": wall, "stats": stats,
            "findings": findings, "dumps": dumps,
            "stderr": done.stderr[-1500:]}


def _site_events(stats, site):
    return stats.get("resilience", {}).get("sites", {}).get(site, {})


def _cli_record(case, run):
    stats = run["stats"]
    return {"phase": "resilience", "case": case, "rc": run["rc"],
            "wall_s": round(run["wall_s"], 3),
            "k1_launches": stats.get("kernel_launches"),
            "k6_launches": stats.get("frontier_vmap_steps"),
            "completed": stats.get("completed"),
            "resilience": {site: events for site, events in stats.get(
                "resilience", {}).get("sites", {}).items() if events},
            "persistent": {key: stats.get(key) for key in (
                "persistent_hits", "persistent_misses",
                "persistent_stores", "persistent_verify_rejects")},
            "dumps": run["dumps"], "findings": run["findings"]}


def _host_fault_run(device, code, spec, cache_dir, largest):
    """KILLBILLY -t 2 in process on the device backend with `spec` armed
    (None: no fault) and the disk tier on a fresh `cache_dir`: the
    analyze record and the stats JSON's counters (its resilience section
    among them). `largest` keeps the largest stream K1 was sent."""
    from mythril_tpu_torch.resilience import faults
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

    saved = os.environ.get("MYTHRIL_GPU_CACHE_DIR")
    os.environ["MYTHRIL_GPU_CACHE_DIR"] = cache_dir
    try:
        _report, completed, record = _analyze_once(
            device, code, 2, ANALYZE_TIMEOUT, "gpu", largest,
            engine={"inject_fault": spec, "solve_cache": "disk"})
        counters = SolverStatistics().as_dict()
    finally:
        faults.configure(None)
        if saved is None:
            os.environ.pop("MYTHRIL_GPU_CACHE_DIR", None)
        else:
            os.environ["MYTHRIL_GPU_CACHE_DIR"] = saved
    if not completed:
        raise AssertionError(f"resilience: {spec}: the run did not complete")
    return record, counters


def phase_resilience(device):
    """Fault containment and the disk tier on the card (see the module
    note). Returns K1's launches over the host-site runs."""
    folder = os.path.join(OUT_DIR, "resilience")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    killbilly = os.path.join(folder, "killbilly.hex")
    with open(killbilly, "w") as fd:
        fd.write(_killbilly_creation())
    smi = nvidia_smi_line()
    failures = []

    # 1. a dispatch that never returns: abandoned at budget plus grace
    hang = _cli_analyze(
        device, folder, "hang", killbilly, 2,
        extra=("--inject-fault", "device.dispatch:hang:n1"),
        env={"MYTHRIL_GPU_DEVICE_DEADLINE": str(HANG_DEADLINE_S),
             "MYTHRIL_GPU_STAGE_GRACE": str(HANG_GRACE_S)},
        timeout=HANG_DEADLINE_S + HANG_GRACE_S + HANG_SLACK_S + 60)
    emit({**_cli_record("device.dispatch:hang:n1", hang),
          "bound_s": HANG_DEADLINE_S + HANG_GRACE_S + HANG_SLACK_S,
          "nvidia_smi": smi})
    events = _site_events(hang["stats"], "device.dispatch")
    if hang["rc"] != 2 or "hard deadline" not in hang["stderr"]:
        failures.append(f"hang: exit {hang['rc']}: {hang['stderr'][-300:]}")
    if hang["wall_s"] > HANG_DEADLINE_S + HANG_GRACE_S + HANG_SLACK_S:
        failures.append(f"hang: {hang['wall_s']:.1f} s past the bound")
    if hang["stats"].get("completed") is not False \
            or events.get("deadline", 0) < 1 \
            or hang["stats"].get("resilience_deadline_trips", 0) < 1 \
            or hang["stats"].get("resilience_faults_injected") != 1:
        failures.append(f"hang: stats JSON {events}")
    if {"site": "device.dispatch", "event": "deadline"} not in hang["dumps"]:
        failures.append(f"hang: no deadline dump in {hang['dumps']}")

    # 2. device sites raising: a DeviceFault and exit 2
    for spec, env in (("device.dispatch:raise:n1", {}),
                      ("frontier.step:raise:n1",
                       {"MYTHRIL_GPU_FRONTIER_BACKEND": "cuda"})):
        site = spec.split(":")[0]
        if device.type != "cuda" and site == "frontier.step":
            emit({"phase": "resilience", "case": spec,
                  "skipped": "the cuda step needs a card"})
            continue
        run = _cli_analyze(device, folder, site, killbilly, 2,
                           extra=("--inject-fault", spec), env=env)
        emit(_cli_record(spec, run))
        if run["rc"] != 2 or f"injected fault at {site}" not in run["stderr"]:
            failures.append(f"{spec}: exit {run['rc']}: "
                            f"{run['stderr'][-300:]}")
        if _site_events(run["stats"], site).get("injected") != 1 \
                or run["stats"].get("completed") is not False:
            failures.append(f"{spec}: stats JSON "
                            f"{_site_events(run['stats'], site)}")

    # 3. host sites on the device backend, in process: findings as the
    # no-fault run's, the event counted, K1 launched
    from mythril_tpu_torch.gpu import ragged_kernel

    code = _killbilly_creation()
    # the largest stream K1 was sent in each run, held after the runs, and
    # the cases that must have one
    streams, launched = {"no fault": {}}, {"no fault"}
    base, base_counters = _host_fault_run(
        device, code, None, os.path.join(folder, "cache-base"),
        streams["no fault"])
    emit({"phase": "resilience", "case": "no fault (in process)",
          "wall_s": round(base["wall_s"], 3),
          "k1_launches": base["kernel_launches"],
          "k1_calibration_launches": base["calibration_launches"],
          "k6_launches": base["k6_launches"],
          "deadline_trips": base_counters["resilience_deadline_trips"],
          "runner_calls": base_counters["deadline_runner_calls"],
          "runner_handoff_s": base_counters["deadline_handoff_wall"],
          "findings": base["findings"], "nvidia_smi": smi})
    if base_counters["resilience_deadline_trips"]:
        failures.append("a clean run recorded a deadline")
    if not base_counters["deadline_runner_calls"]:
        failures.append("no dispatch went through the deadline runner")
    ragged_kernel.reset_launches()  # the host-site runs' count starts here
    for index, (spec, expected, k1_must_launch) in enumerate(HOST_FAULTS):
        site = spec.split(":")[0]
        streams[spec] = {}
        if k1_must_launch:
            launched.add(spec)
        record, counters = _host_fault_run(
            device, code, spec, os.path.join(folder, f"cache-{index}"),
            streams[spec])
        events = counters["resilience"]["sites"][site]
        solve_launches = (record["kernel_launches"]
                          - record["calibration_launches"])
        emit({"phase": "resilience", "case": spec,
              "wall_s": round(record["wall_s"], 3),
              "k1_launches": record["kernel_launches"],
              "k1_calibration_launches": record["calibration_launches"],
              "k2_launches": record["k2_launches"],
              "k6_launches": record["k6_launches"],
              "cap_rejects": record["cap_rejects"],
              "runner_calls": counters["deadline_runner_calls"],
              "runner_handoff_s": counters["deadline_handoff_wall"],
              "events": events, "findings": record["findings"]})
        if record["findings"] != base["findings"]:
            failures.append(f"{spec}: findings {record['findings']}")
        if any(events.get(event, 0) < 1 for event in expected):
            failures.append(f"{spec}: events {events}")
        if k1_must_launch and solve_launches <= 0:
            failures.append(f"{spec}: K1 did not launch")
    host_launches = ragged_kernel.launches  # ... and ends here
    # K1 bit for bit on each run's largest stream: under a host-site
    # fault the cones K1 is sent differ (un-rewritten, not incremental)
    host_err = 0
    for spec, largest in streams.items():
        if "stream" not in largest:
            if spec in launched:
                failures.append(f"{spec}: K1 was sent no stream")
            continue
        host_err = max(host_err, _hold_stream(
            device, largest["stream"], f"resilience-stream ({spec})",
            {"case": spec}, timed=False)["max_abs_err"])

    # 4. the disk tier across processes: fill, hit, corrupted
    disk_env = {"MYTHRIL_GPU_CACHE_DIR": os.path.join(folder, "disk-cache")}
    disk = {}
    for leg, extra in (("fill", ()), ("hit", ()),
                       ("corrupt", ("--inject-fault",
                                    "disk.entry:corrupt:*"))):
        disk[leg] = _cli_analyze(device, folder, f"disk-{leg}", killbilly,
                                 2, extra=("--solve-cache", "disk", *extra),
                                 env=disk_env)
        emit(_cli_record(f"{DISK_CONTRACT} --solve-cache disk: {leg}",
                         disk[leg]))
        if disk[leg]["rc"] not in (0, 1) \
                or disk[leg]["stats"].get("completed") is not True:
            failures.append(f"disk {leg}: exit {disk[leg]['rc']}: "
                            f"{disk[leg]['stderr'][-300:]}")
    fill, hit, corrupt = (disk[leg]["stats"]
                          for leg in ("fill", "hit", "corrupt"))
    if fill.get("persistent_stores", 0) <= 0 \
            or fill.get("kernel_launches", 0) <= 0:
        failures.append("disk fill: nothing stored, or K1 never launched")
    if hit.get("persistent_hits", 0) <= 0 \
            or hit.get("persistent_verify_rejects"):
        failures.append(f"disk hit: {hit.get('persistent_hits')} hits, "
                        f"{hit.get('persistent_verify_rejects')} rejects")
    if _site_events(corrupt, "disk.entry").get("quarantine", 0) < 1:
        failures.append("disk corrupt: no quarantine")
    for leg in ("hit", "corrupt"):
        if disk[leg]["findings"] != disk["fill"]["findings"]:
            failures.append(f"disk {leg}: findings differ from the fill's")
    emit({"phase": "resilience", "case": "summary",
          "host_site_k1_launches": host_launches,
          "disk_k1_launches": {leg: disk[leg]["stats"].get("kernel_launches")
                               for leg in disk},
          "disk_walls_s": {leg: round(disk[leg]["wall_s"], 3)
                           for leg in disk},
          "failed_checks": failures, "nvidia_smi": smi})
    if failures:
        raise AssertionError(f"resilience: {failures}")
    return {"launches": host_launches, "max_abs_err": host_err}


# -- corpus: the four corpus contracts interleaved and in worker processes ---

CORPUS_INTERLEAVE = 4
CORPUS_JOBS = 4
# the worker-death leg: two contracts in two workers, each killed at its
# first crossing of the jobs.worker site, twice over
DEATH_CONTRACTS = ("killbilly", "xc_dispatch_a.hex")
DEATH_SPEC = "jobs.worker:exit:n1"
BUSY_SAMPLE_MS = 200


@contextlib.contextmanager
def _busy_sampler(device):
    """The card's busy share over the block: nvidia-smi's utilization.gpu
    (the share of each sample period in which a kernel ran, from any
    process) every BUSY_SAMPLE_MS, averaged; "not measured" when the
    sampler cannot run. The sampler process is stopped on exit."""
    out = {}
    proc = None
    if device.type == "cuda":
        try:
            proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms",
                 str(BUSY_SAMPLE_MS)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            proc = None
    try:
        yield out
    finally:
        samples = []
        if proc is not None:
            proc.terminate()
            try:
                text, _err = proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _err = proc.communicate()
            samples = [float(line) for line in text.split()
                       if line.replace(".", "", 1).isdigit()]
        if samples:
            out.update(device_busy_share=sum(samples) / len(samples) / 100,
                       busy_samples=len(samples))
        else:
            out.update(device_busy_share="not measured")


@contextlib.contextmanager
def _track_mixed_streams(device, mixed):
    """While the block runs, `mixed` (a dict; None: nothing is tracked)
    keeps the largest stream K1 was sent for a mixed-origin group (two or
    more origins: contracts, or tenants' requests), and counts the groups
    and the K1 launches made while they were dispatched."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.gpu import router as router_mod
    from mythril_tpu_torch.gpu.backend import get_device_backend

    if mixed is None:
        yield
        return
    original = router_mod.QueryRouter._ragged_dispatch
    backend = get_device_backend(None if device.type == "cuda" else device)
    caps = ragged_kernel.kernel_caps()
    state = {"mixed": False}
    mixed.setdefault("k1_launches", 0)
    mixed.setdefault("groups", 0)

    def dispatch(self, group, remaining, profile):
        state["mixed"] = len({unit.origin for unit in group
                              if unit.origin is not None}) >= 2
        before = ragged_kernel.launches
        try:
            return original(self, group, remaining, profile)
        finally:
            if state["mixed"]:
                mixed["groups"] += 1
                mixed["k1_launches"] += ragged_kernel.launches - before
            state["mixed"] = False

    def keep(stream, stream_entries):
        if not state["mixed"] or (
                stream.v1 > caps.var_cap
                or stream.cone_slots > caps.cone_cap
                or stream.max_roots > caps.root_cap):
            return
        gates = sum(pc.num_gates for pc, _extra in stream_entries)
        if gates > mixed.get("gates", -1):
            mixed.update(gates=gates, stream=stream)

    router_mod.QueryRouter._ragged_dispatch = dispatch
    backend.on_stream = keep
    try:
        yield
    finally:
        router_mod.QueryRouter._ragged_dispatch = original
        backend.on_stream = None


def _corpus_once(device, entries, solver_backend, interleave=0, jobs=1,
                 spec=None, mixed=None):
    """One in-process MythrilAnalyzer run over `entries` ((name, creation
    code) pairs, each loaded under its name) at -t 1, fork pruning on,
    from fresh solve state: interleaved on `interleave` slots, or in
    `jobs` spawn workers, with `spec` armed. K1's, K2's and K6's counts
    in this process start at 0 just before the run and are read just
    after. `mixed` (a dict) keeps the largest stream K1 was sent for a
    mixed-origin group and counts the K1 launches made while such groups
    were dispatched. Returns a record: the wall, the findings by
    contract, the counters, the busy share, the worker records and the
    parent's resilience spans in order."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.gpu import frontier_kernel, ragged_kernel, xla_kernel
    from mythril_tpu_torch.observe.tracer import get_tracer
    from mythril_tpu_torch.resilience import faults
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    device_arg = None if device.type == "cuda" else device
    args.reset()
    clear_caches()
    frontend._global_blaster = None
    stats = SolverStatistics()
    stats.reset()
    tracer = get_tracer()
    tracer.reset()
    tracer.enable(None)  # the resilience events' order
    watch = _TimeoutLines()
    logger = logging.getLogger("mythril_tpu_torch.laser.svm")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(watch)
    cmd_args = SimpleNamespace(
        execution_timeout=ANALYZE_TIMEOUT, transaction_count=1,
        max_depth=128, solver_backend=solver_backend,
        torch_device=device_arg, pruning_factor=1.0,
        corpus_interleave=interleave, jobs=jobs, inject_fault=spec)
    disassembler = MythrilDisassembler()
    for name, code in entries:
        disassembler.load_from_bytecode(code, name=name)
    ragged_kernel.reset_launches()  # this run's counts start here
    xla_kernel.reset_launches()
    frontier_kernel.reset_launches()
    try:
        with _busy_sampler(device) as busy, _track_mixed_streams(
                device, mixed if solver_backend == "gpu" else None):
            torch_sync(device)
            start = time.monotonic()
            analyzer = MythrilAnalyzer(disassembler, cmd_args=cmd_args)
            report = analyzer.fire_lasers(transaction_count=1)
            torch_sync(device)
            wall = time.monotonic() - start
        launches = {"ragged_round": ragged_kernel.launches,  # ... and end
                    "xla_round": xla_kernel.launches,
                    "frontier_step": frontier_kernel.launches}
    finally:
        logger.removeHandler(watch)
        logger.setLevel(level)
        events = [event["name"] for event in tracer.events()
                  if event["name"].startswith("resilience.")]
        tracer.reset()
        faults.configure(None)
        args.reset()
    if report.exceptions:
        raise AssertionError(f"corpus run raised: {report.exceptions[0]}")
    counters = stats.as_dict()
    findings = {name: [] for name, _code in entries}
    for issue in report.issues.values():
        findings[issue.contract].append(
            [issue.swc_id, issue.function, issue.address, issue.title])
    return {"wall_s": wall, "completed": not watch.lines,
            "findings": {name: sorted(keys)
                         for name, keys in findings.items()},
            "launches_here": launches, "counters": counters, **busy,
            "workers": analyzer.worker_records,
            "resilience_spans": events}


def _corpus_record(leg, run, extra=None):
    counters = run["counters"]
    return {"phase": "corpus", "leg": leg, "wall_s": run["wall_s"],
            "contracts_per_hour": len(run["findings"]) * 3600
            / run["wall_s"],
            "completed": run["completed"],
            "kernel_launches": counters["kernel_launches"],
            "frontier_vmap_steps": counters["frontier_vmap_steps"],
            "launches_in_this_process": run["launches_here"],
            "xcontract_windows": counters["xcontract_windows"],
            "xcontract_cones_packed": counters["xcontract_cones_packed"],
            "ragged_windows": counters["ragged_windows"],
            "device_batch_hits": counters["device_batch_hits"],
            "aig_device_component_hits":
                counters["aig_device_component_hits"],
            "device_busy_share": run["device_busy_share"],
            "busy_samples": run.get("busy_samples", 0),
            "resilience": {site: events for site, events
                           in counters["resilience"]["sites"].items()
                           if events},
            "findings": run["findings"], **(extra or {})}


def _sequential_corpus(device):
    """The four corpus contracts one by one on both backends, as the
    analyze phase runs them (--corpus-only has no analyze phase)."""
    records = {}
    for name, code, tx_count, timeout, _compared in _analyze_inputs():
        if name not in CORPUS:
            continue
        records[name] = {}
        for solver_backend in ("cpu", "gpu"):
            _report, done, record = _analyze_once(
                device, code, tx_count, timeout, solver_backend, {})
            if not done:
                raise AssertionError(f"corpus: {name} did not complete")
            records[name][solver_backend] = record
            emit({"phase": "corpus", "leg": "sequential", "contract": name,
                  "backend": solver_backend, "wall_s": record["wall_s"],
                  "findings": record["findings"]})
    return records


def phase_corpus(device, records=None):
    """Corpus runs (see the module note): the four corpus contracts
    interleaved on four slots and in four workers on the device backend,
    two contracts through a worker death, and in four workers on the
    host; findings by contract against the sequential runs (the analyze
    phase's `records`, or run here). Returns K1's and K6's launches by
    leg and K1 held and timed on the largest mixed-origin stream."""
    from mythril_tpu_torch.observe import metrics

    if records is None:
        records = _sequential_corpus(device)
    inputs = {name: code for name, code, _tx, _timeout, _compared
              in _analyze_inputs()}
    corpus = [(name, inputs[name]) for name in CORPUS]
    expected = {}
    for name in CORPUS:
        host = records[name]["cpu"]["findings"]
        if records[name]["gpu"]["findings"] != host:
            raise AssertionError(f"corpus: {name}: the sequential device "
                                 f"and host findings differ")
        expected[name] = host
    smi = nvidia_smi_line()
    failures = []

    def check(leg, run, want):
        if not run["completed"]:
            failures.append(f"{leg}: a contract did not complete")
        for name, keys in want.items():
            if run["findings"][name] != keys:
                failures.append(f"{leg}: {name}: findings "
                                f"{run['findings'][name]} differ from the "
                                f"sequential runs' {keys}")

    # (a) interleaved on the device backend: mixed-origin K1 streams
    mixed = {}
    interleaved = _corpus_once(device, corpus, "gpu",
                               interleave=CORPUS_INTERLEAVE, mixed=mixed)
    check("interleave", interleaved, expected)
    counters = interleaved["counters"]
    if counters["xcontract_windows"] <= 0:
        failures.append("interleave: no stream mixed two contracts")
    if mixed["k1_launches"] <= 0 or "stream" not in mixed:
        failures.append("interleave: K1 never launched on a mixed stream")
    emit(_corpus_record("interleave", interleaved, {
        "slots": CORPUS_INTERLEAVE, "mixed_groups": mixed["groups"],
        "k1_launches_on_mixed_streams": mixed["k1_launches"],
        "nvidia_smi": smi}))
    held = {"max_abs_err": 0, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None}
    if "stream" in mixed:
        held = _hold_stream(device, mixed["stream"], "corpus-mixed-stream",
                            {"xcontract_windows":
                                 counters["xcontract_windows"],
                             "k1_launches_on_mixed_streams":
                                 mixed["k1_launches"]}, phase="corpus")

    # (b) four spawn workers on the device backend
    jobs = _corpus_once(device, corpus, "gpu", jobs=CORPUS_JOBS)
    check("jobs", jobs, expected)
    workers = {}
    for record in jobs["workers"]:
        worker = workers.setdefault(record["pid"], {
            "pid": record["pid"], "contracts": [], "k1_launches": 0,
            "k6_launches": 0, "k2_launches": 0,
            "k1_cells_s": record["rates"].get("kernel_cells_s")})
        worker["contracts"].append(CORPUS[record["contract"]])
        worker["k1_launches"] += record["launches"]["ragged_round"]
        worker["k6_launches"] += record["launches"]["frontier_step"]
        worker["k2_launches"] += record["launches"]["xla_round"]
    merged = metrics.merge_snapshots([record["metrics"]
                                      for record in jobs["workers"]])
    jobs_counters = jobs["counters"]
    if jobs_counters["kernel_launches"] <= 0 \
            or jobs_counters["frontier_vmap_steps"] <= 0:
        failures.append("jobs: the workers' stats hold no K1 or K6 launch")
    if any(worker["k1_launches"] <= 0 for worker in workers.values()):
        failures.append("jobs: a worker never launched K1")
    if device.type == "cuda" and not any(
            worker["k6_launches"] for worker in workers.values()):
        failures.append("jobs: no worker launched K6")
    if len(jobs["workers"]) != len(CORPUS):
        failures.append(f"jobs: {len(jobs['workers'])} worker records")
    for name in ("kernel_launches", "frontier_vmap_steps"):
        if merged["counters"][name] != jobs_counters[name]:
            failures.append(f"jobs: merged snapshots' {name} "
                            f"{merged['counters'][name]} against the "
                            f"absorbed {jobs_counters[name]}")
    emit(_corpus_record("jobs", jobs, {
        "jobs": CORPUS_JOBS, "workers": list(workers.values()),
        "nvidia_smi": smi}))

    # (c) worker death: requeued once, then analyzed in this process
    death_entries = [(name, inputs[name]) for name in DEATH_CONTRACTS]
    # KILLBILLY's host findings at -t 1 (the analyze phase runs it at -t 2)
    death_expected = {name: (expected[name] if name in expected else
                             _corpus_once(device, [(name, inputs[name])],
                                          "cpu")["findings"][name])
                      for name in DEATH_CONTRACTS}
    death = _corpus_once(device, death_entries, "gpu", jobs=2,
                         spec=DEATH_SPEC)
    check("worker-death", death, death_expected)
    order = [name for name in death["resilience_spans"]
             if name in ("resilience.worker_requeue", "resilience.degraded")]
    if order != ["resilience.worker_requeue", "resilience.degraded"]:
        failures.append(f"worker-death: events {order}")
    if death["counters"]["resilience_worker_requeues"] != 1:
        failures.append("worker-death: resilience_worker_requeues "
                        f"{death['counters']['resilience_worker_requeues']}")
    if death["workers"] or death["launches_here"]["ragged_round"] <= 0:
        failures.append("worker-death: the contracts were not analyzed in "
                        "this process, on K1")
    emit(_corpus_record("worker-death", death, {
        "spec": DEATH_SPEC, "event_order": order,
        "contracts": list(DEATH_CONTRACTS)}))

    # (d) the host's four workers, and every leg's wall
    host_jobs = _corpus_once(device, corpus, "cpu", jobs=CORPUS_JOBS)
    check("host-jobs", host_jobs, expected)
    emit(_corpus_record("host-jobs", host_jobs, {"jobs": CORPUS_JOBS}))
    walls = {
        "sequential_host": sum(records[name]["cpu"]["wall_s"]
                               for name in CORPUS),
        "sequential_device": sum(records[name]["gpu"]["wall_s"]
                                 for name in CORPUS),
        f"interleave_{CORPUS_INTERLEAVE}_device": interleaved["wall_s"],
        f"jobs_{CORPUS_JOBS}_device": jobs["wall_s"],
        f"jobs_{CORPUS_JOBS}_host": host_jobs["wall_s"]}
    emit({"phase": "corpus", "leg": "walls", "contracts": len(CORPUS),
          "wall_s": walls,
          "contracts_per_hour": {leg: len(CORPUS) * 3600 / wall
                                 for leg, wall in walls.items()},
          "failed_checks": failures, "nvidia_smi": smi})
    if failures:
        raise AssertionError(f"corpus: {failures}")
    k1_jobs = sum(worker["k1_launches"] for worker in workers.values())
    k6_jobs = sum(worker["k6_launches"] for worker in workers.values())
    return {"interleave_launches": interleaved["launches_here"],
            "mixed_k1_launches": mixed["k1_launches"],
            "jobs_k1_launches": k1_jobs, "jobs_k6_launches": k6_jobs,
            "xcontract_windows": counters["xcontract_windows"],
            "xcontract_cones_packed": counters["xcontract_cones_packed"],
            "mixed_stream": held, "max_abs_err": held["max_abs_err"]}


def corpus_only(device) -> int:
    phase_build()
    result = phase_corpus(device)
    emit({"phase": "corpus", "mixed_stream": result["mixed_stream"],
          "launches": {key: result[key] for key in (
              "interleave_launches", "mixed_k1_launches",
              "jobs_k1_launches", "jobs_k6_launches")}})
    return 0


# -- the serve phase ------------------------------------------------------------

# (tenant, contract, transaction count) of the serve leg's five requests,
# posted SERVE_STAGGER_S apart: the first rides a batch alone, and the
# other four queue behind it and form one batch of three tenants
SERVE_REQUESTS = (("bob", "xc_dispatch_a.hex", 1),
                  ("alice", "killbilly", 2),
                  ("carol", "xc_dispatch_b.hex", 1),
                  ("alice", "xc_sender_a.hex", 1),
                  ("bob", "xc_sender_b.hex", 1))
SERVE_STAGGER_S = 0.1
SERVE_HTTP_TIMEOUT = 600   # s per request over HTTP, and per drain
SERVE_START_TIMEOUT = 300  # s for a `serve` process to listen
# the fleet leg: two tenants' identical bytecode (routed to one shard), a
# contract routed to the other shard, and the first one sent straight to
# that other shard, which must serve it from the network tier
FLEET_SAME = "xc_dispatch_a.hex"
FLEET_OTHER = "killbilly"
FAULT_CONTRACT = "xc_dispatch_a.hex"


def _serve_http(port, method, path, payload=None, timeout=60.0):
    """(status, body: JSON or text) of one loopback HTTP call."""
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            status, raw = response.status, response.read()
    except urllib.error.HTTPError as error:
        status, raw = error.code, error.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode(errors="replace")


def _issue_keys_of(issues):
    return sorted([issue["swc-id"], issue["function"], issue["address"],
                   issue["title"]] for issue in issues)


def _prom_value(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _serve_cli(folder, extra, env_extra=None):
    """Start `python -m mythril_tpu_torch serve` with `extra`, its output
    in `folder`; returns (process, port) once it listens."""
    os.makedirs(folder, exist_ok=True)
    log_path = os.path.join(folder, "serve.log")
    env = dict(os.environ, **(env_extra or {}))
    env.pop("MYTHRIL_GPU_FAULTS", None)
    with open(log_path, "w") as log_fd:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port",
             "0", "-v", "3", *extra], stdout=log_fd, stderr=log_fd, env=env)
    deadline = time.monotonic() + SERVE_START_TIMEOUT
    while time.monotonic() < deadline:
        with open(log_path) as fd:
            text = fd.read()
        for line in text.splitlines():
            if " listening on http://127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split()[0])
                return proc, port
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode} before "
                                 f"listening: {text[-2000:]}")
        time.sleep(0.2)
    _stop(proc)
    raise AssertionError("serve did not listen within "
                         f"{SERVE_START_TIMEOUT} s")


def _stop(proc, timeout=120):
    """SIGTERM (a drain), then a kill past `timeout`; the exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def _serve_sequential(device):
    """The serve leg's contracts on the host backend, one by one, as the
    analyze phase runs them (--serve-only has no analyze phase)."""
    records = {}
    for name, code, tx_count, timeout, _compared in _analyze_inputs():
        if name not in {entry[1] for entry in SERVE_REQUESTS}:
            continue
        _report, done, record = _analyze_once(
            device, code, tx_count, timeout, "cpu", {})
        if not done:
            raise AssertionError(f"serve: {name} did not complete")
        records[name] = {"cpu": record}
        emit({"phase": "serve", "leg": "sequential", "contract": name,
              "backend": "cpu", "wall_s": record["wall_s"],
              "findings": record["findings"]})
    return records


def phase_serve(device, records=None):
    """`serve` on the card (see the module note): (a) the daemon over HTTP
    with five requests of three tenants posted at once, findings against
    the sequential host runs (the analyze phase's `records`, or run
    here), K1 held and timed on the largest mixed-origin stream; (b) a
    warm repeat; (c) an eviction; (d) `serve --shards 2` with a shared
    network tier; (e) an injected device fault. Returns the launch counts
    by leg and K1's record on the mixed stream."""
    from mythril_tpu_torch.gpu import frontier_kernel, ragged_kernel, xla_kernel
    from mythril_tpu_torch.serve.daemon import ServeDaemon
    from mythril_tpu_torch.service import tenancy
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support import model as model_mod
    from mythril_tpu_torch.support.args import args

    if records is None:
        records = _serve_sequential(device)
    inputs = {name: code for name, code, _tx, _timeout, _compared
              in _analyze_inputs()}
    smi = nvidia_smi_line()
    failures = []
    device_arg = None if device.type == "cuda" else device
    args.reset()
    model_mod.clear_caches()
    frontend._global_blaster = None
    args.solver_backend = "gpu"
    args.torch_device = device_arg
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    batch_walls = []
    original_execute = ServeDaemon._execute_batch

    def timed_execute(self, batch):
        start = time.monotonic()
        try:
            return original_execute(self, batch)
        finally:
            batch_walls.append({"requests": len(batch),
                                "tenants": len({r.tenant for r in batch}),
                                "wall_s": time.monotonic() - start})

    ServeDaemon._execute_batch = timed_execute
    daemon = ServeDaemon(tx_count=1, http_port=0)
    mixed = {}
    try:
        daemon.start()  # resolves the card and loads the kernels
        # (a) three tenants, five requests, posted at once
        ragged_kernel.reset_launches()  # the leg's counts start here
        xla_kernel.reset_launches()
        frontier_kernel.reset_launches()
        outcomes = [None] * len(SERVE_REQUESTS)

        def client(index, tenant, name, tx_count):
            start = time.monotonic()
            status, body = _serve_http(
                daemon.port, "POST", "/analyze",
                {"tenant": tenant, "code": inputs[name],
                 "tx_count": tx_count}, timeout=SERVE_HTTP_TIMEOUT)
            outcomes[index] = (status, body, time.monotonic() - start)

        with _busy_sampler(device) as busy, _track_mixed_streams(
                device, mixed):
            start = time.monotonic()
            threads = [threading.Thread(target=client, args=(i, *entry))
                       for i, entry in enumerate(SERVE_REQUESTS)]
            for thread in threads:
                thread.start()
                time.sleep(SERVE_STAGGER_S)
            for thread in threads:
                thread.join(timeout=SERVE_HTTP_TIMEOUT + 60)
            torch_sync(device)
            leg_wall = time.monotonic() - start
        launches = {"ragged_round": ragged_kernel.launches,  # ... and end
                    "xla_round": xla_kernel.launches,
                    "frontier_step": frontier_kernel.launches}
        requests = []
        first = {}
        for (tenant, name, tx_count), outcome in zip(SERVE_REQUESTS,
                                                     outcomes):
            if outcome is None:
                failures.append(f"serve: {tenant}/{name} never answered")
                continue
            status, body, latency = outcome
            keys = (_issue_keys_of(body.get("issues", []))
                    if isinstance(body, dict) else None)
            want = records[name]["cpu"]["findings"]
            if status != 200 or body.get("status") != "ok":
                failures.append(f"serve: {tenant}/{name} answered {status} "
                                f"{str(body)[:300]}")
            elif keys != want:
                failures.append(f"serve: {tenant}/{name} findings {keys} "
                                f"differ from the sequential run's {want}")
            if isinstance(body, dict) and name == "killbilly":
                first = body
            requests.append({"tenant": tenant, "contract": name,
                             "tx_count": tx_count, "http": status,
                             "status": body.get("status")
                             if isinstance(body, dict) else None,
                             "latency_s": latency,
                             "wait_s": body.get("wait_s")
                             if isinstance(body, dict) else None,
                             "cdcl_settles": body.get("cdcl_settles")
                             if isinstance(body, dict) else None,
                             "findings": keys})
        counters = stats.as_dict()
        if launches["ragged_round"] <= 0:
            failures.append("serve: K1 was never launched")
        if mixed.get("k1_launches", 0) <= 0 or "stream" not in mixed:
            failures.append("serve: K1 never launched on a mixed-origin "
                            "stream")
        if device.type == "cuda" and launches["frontier_step"] <= 0:
            failures.append("serve: K6 was never launched")
        emit({"phase": "serve", "leg": "daemon", "wall_s": leg_wall,
              "requests": requests, "batches": list(batch_walls),
              "serve_batches": counters["serve_batches"],
              "serve_batch_requests": counters["serve_batch_requests"],
              "serve_batch_tenants": counters["serve_batch_tenants"],
              "serve_tenant_window_share":
                  counters["serve_tenant_window_share"],
              "launches": launches,
              "k1_launches_on_mixed_streams": mixed.get("k1_launches", 0),
              "mixed_groups": mixed.get("groups", 0),
              "xcontract_windows": counters["xcontract_windows"],
              "xcontract_cones_packed": counters["xcontract_cones_packed"],
              "device_busy_share": busy["device_busy_share"],
              "busy_samples": busy.get("busy_samples", 0),
              "nvidia_smi": smi})
        held = {"max_abs_err": 0, "ms": None, "plain_ms": None,
                "bound_ms": None, "bound_by": None}
        if "stream" in mixed:
            held = _hold_stream(device, mixed["stream"],
                                "serve-mixed-stream",
                                {"k1_launches_on_mixed_streams":
                                     mixed["k1_launches"]}, phase="serve")

        # (b) the warm repeat, beside a cold tenant's solo run
        repeats = {}
        for leg, tenant in (("warm", "alice"), ("cold", "dave")):
            ragged_kernel.reset_launches()
            frontier_kernel.reset_launches()
            status, body = _serve_http(
                daemon.port, "POST", "/analyze",
                {"tenant": tenant, "code": inputs["killbilly"],
                 "tx_count": 2}, timeout=SERVE_HTTP_TIMEOUT)
            repeats[leg] = {
                "tenant": tenant, "status": body.get("status"),
                "cdcl_settles": body.get("cdcl_settles"),
                "memo_hits": body.get("memo_hits"),
                "k1_launches": ragged_kernel.launches,
                "k6_launches": frontier_kernel.launches,
                "findings": _issue_keys_of(body.get("issues", []))}
            if status != 200 or body.get("status") != "ok":
                failures.append(f"serve warm: {tenant} answered {status}")
            elif repeats[leg]["findings"] != \
                    records["killbilly"]["cpu"]["findings"]:
                failures.append(f"serve warm: {tenant}'s findings differ")
        warm = repeats["warm"]["cdcl_settles"] or 0
        if not (warm < (first.get("cdcl_settles") or 0)
                and warm < (repeats["cold"]["cdcl_settles"] or 0)):
            failures.append(
                f"serve warm: {warm} settles, not fewer than the first "
                f"run's {first.get('cdcl_settles')} and a cold tenant's "
                f"{repeats['cold']['cdcl_settles']}")
        emit({"phase": "serve", "leg": "warm-repeat",
              "first": {"cdcl_settles": first.get("cdcl_settles"),
                        "memo_hits": first.get("memo_hits"),
                        "k1_launches_of_its_batch": launches[
                            "ragged_round"]},
              **repeats})

        # (c) evict alice: her memos go, the others' stay
        others = [origin for origin in model_mod._origin_caches
                  if not tenancy.origin_in_session(origin, "alice")]
        status, body = _serve_http(daemon.port, "POST", "/evict",
                                   {"tenant": "alice"}, timeout=120)
        left = [origin for origin in model_mod._origin_caches
                if tenancy.origin_in_session(origin, "alice")]
        kept = all(origin in model_mod._origin_caches for origin in others)
        if status != 200 or left or not kept or not others:
            failures.append(f"serve evict: {status}, alice's origins left "
                            f"{left}, others kept {kept}")
        emit({"phase": "serve", "leg": "evict", "http": status,
              "alice_origins_left": left, "other_origins": len(others),
              "others_kept": kept,
              "alice_blasters_left": [o for o in tenancy._blasters
                                      if tenancy.origin_in_session(
                                          o, "alice")]})
        status, health = _serve_http(daemon.port, "GET", "/healthz")
        if status != 200 or not health.get("ok"):
            failures.append(f"serve: /healthz {status} {health}")
    finally:
        ServeDaemon._execute_batch = original_execute
        if not daemon.drain(timeout=SERVE_HTTP_TIMEOUT):
            failures.append("serve: the drain timed out")
        args.reset()
        model_mod.clear_caches()

    fleet = _serve_fleet(device, inputs, records, failures)
    fault = _serve_device_fault(device, inputs, failures)
    emit({"phase": "serve", "leg": "summary", "failed_checks": failures,
          "nvidia_smi": smi})
    if failures:
        raise AssertionError(f"serve: {failures}")
    return {"launches": launches, "mixed_k1_launches": mixed["k1_launches"],
            "warm_k1_launches": repeats["warm"]["k1_launches"],
            "fleet_k1_launches": fleet, "fault": fault,
            "mixed_stream": held, "max_abs_err": held["max_abs_err"]}


def _serve_fleet(device, inputs, records, failures):
    """(d) `serve --shards 2` with a shared network tier: identical
    bytecode of two tenants lands on one shard, a contract routed to the
    other shard runs there, the first contract sent straight to the
    other shard is served from the tier, both shards launch K1, and the
    merged /metrics equal the shards' own snapshots summed. Returns each
    shard's K1 solve rounds (kernel_launches)."""
    folder = os.path.join(OUT_DIR, "serve-fleet")
    shutil.rmtree(folder, ignore_errors=True)  # a fresh network tier
    net = os.path.join(folder, "net-tier")
    extra = ["--shards", "2", "-t", "1"]
    if device.type != "cuda":
        extra += ["--torch-device", str(device)]
    proc, port = _serve_cli(folder, extra, {
        "MYTHRIL_GPU_NET_TIER_DIR": net,
        "MYTHRIL_GPU_FLEET_PROBE_INTERVAL": "60"})
    try:
        answers = {}
        tx_counts = {entry[1]: entry[2] for entry in SERVE_REQUESTS}
        for tenant, name in (("alice", FLEET_SAME), ("bob", FLEET_SAME),
                             ("carol", FLEET_OTHER)):
            status, body = _serve_http(port, "POST", "/analyze",
                                       {"tenant": tenant,
                                        "code": inputs[name],
                                        "tx_count": tx_counts[name]},
                                       timeout=SERVE_HTTP_TIMEOUT)
            answers[tenant] = body
            if status != 200 or body.get("status") != "ok":
                failures.append(f"fleet: {tenant}/{name} answered {status}")
            elif _issue_keys_of(body["issues"]) != \
                    records[name]["cpu"]["findings"]:
                failures.append(f"fleet: {tenant}/{name} findings differ")
        hot = answers["alice"].get("shard")
        if answers["bob"].get("shard") != hot:
            failures.append("fleet: identical bytecode of two tenants "
                            "landed on two shards")
        if answers["carol"].get("shard") == hot:
            failures.append(f"fleet: {FLEET_OTHER} was routed to the same "
                            "shard")
        _status, health = _serve_http(port, "GET", "/healthz")
        shards = health.get("shards", {})
        other = 1 - hot if hot in (0, 1) else None
        before = {}
        if other is not None:
            _status, snap = _serve_http(shards[str(other)]["port"], "GET",
                                        "/snapshot")
            before = snap["counters"]
            status, body = _serve_http(
                shards[str(other)]["port"], "POST", "/analyze",
                {"tenant": "dave", "code": inputs[FLEET_SAME]},
                timeout=SERVE_HTTP_TIMEOUT)
            if status != 200 or body.get("status") != "ok":
                failures.append(f"fleet: the other shard answered {status}")
        snaps = {}
        for shard_id, row in sorted(shards.items()):
            _status, snaps[shard_id] = _serve_http(row["port"], "GET",
                                                   "/snapshot")
        _status, text = _serve_http(port, "GET", "/metrics")
        k1 = {shard_id: snap["counters"]["kernel_launches"]
              for shard_id, snap in snaps.items()}
        tier_hits = (snaps[str(other)]["counters"]["net_tier_hits"]
                     - before.get("net_tier_hits", 0)
                     if other is not None else 0)
        if len(k1) != 2 or min(k1.values()) <= 0:
            failures.append(f"fleet: K1 solve rounds by shard {k1}")
        if tier_hits <= 0:
            failures.append("fleet: the other shard served no network-tier "
                            "entry")
        merged = {}
        for key in ("kernel_launches", "net_tier_hits", "net_tier_stores",
                    "serve_requests_completed"):
            merged[key] = _prom_value(text, f"mythril_tpu_torch_{key}")
            want = sum(snap["counters"][key] for snap in snaps.values())
            if merged[key] != want:
                failures.append(f"fleet: merged /metrics {key} "
                                f"{merged[key]} against the shards' {want}")
        emit({"phase": "serve", "leg": "fleet", "hot_shard": hot,
              "shards": {shard_id: {key: snap["counters"][key] for key in (
                  "kernel_launches", "frontier_vmap_steps",
                  "net_tier_hits", "net_tier_stores", "cdcl_settles",
                  "serve_requests_completed")}
                  for shard_id, snap in snaps.items()},
              "other_shard_tier_hits": tier_hits, "merged_metrics": merged,
              "routes": {tenant: body.get("shard")
                         for tenant, body in answers.items()}})
    finally:
        rc = _stop(proc)
    if rc != 0:
        failures.append(f"fleet: the supervisor exited {rc} on SIGTERM")
    return k1


def _serve_device_fault(device, inputs, failures):
    """(e) device.dispatch:raise in one request of `serve`: it and its
    batch answer `device_fault`, /healthz is not ok, the process exits
    2."""
    folder = os.path.join(OUT_DIR, "serve-fault")
    extra = ["-t", "1", "--inject-fault", "device.dispatch:raise:n1"]
    if device.type != "cuda":
        extra += ["--torch-device", str(device)]
    proc, port = _serve_cli(folder, extra)
    try:
        answers = [None, None]

        def client(index, tenant):
            answers[index] = _serve_http(
                port, "POST", "/analyze",
                {"tenant": tenant, "code": inputs[FAULT_CONTRACT]},
                timeout=SERVE_HTTP_TIMEOUT)

        threads = [threading.Thread(target=client, args=(i, tenant))
                   for i, tenant in enumerate(("alice", "bob"))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=SERVE_HTTP_TIMEOUT + 60)
        health_status, health = _serve_http(port, "GET", "/healthz")
        statuses = [(answer[0], answer[1].get("status"),
                     answer[1].get("reason"))
                    if answer and isinstance(answer[1], dict) else None
                    for answer in answers]
        for answer in statuses:
            if answer is None or answer[1] == "ok" or not (
                    answer[1] == "device_fault" or answer[2] ==
                    "device_fault"):
                failures.append(f"fault: an answer {answer}")
        if health_status != 503 or health.get("ok") is not False \
                or "device" not in str(health.get("reason")):
            failures.append(f"fault: /healthz {health_status} {health}")
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        if proc.poll() is None:
            _stop(proc)
    if rc != 2:
        failures.append(f"fault: serve exited {rc}, not 2")
    record = {"phase": "serve", "leg": "device-fault",
              "answers": statuses, "healthz": health, "exit_code": rc}
    emit(record)
    return {"answers": [a[1] if a else None for a in statuses],
            "exit_code": rc}


def serve_only(device) -> int:
    phase_build()
    result = phase_serve(device)
    emit({"phase": "serve", "mixed_stream": result["mixed_stream"],
          "launches": result["launches"],
          "mixed_k1_launches": result["mixed_k1_launches"],
          "fleet_k1_launches": result["fleet_k1_launches"]})
    return 0


# -- the autotune phase -------------------------------------------------------

AUTOTUNE_CONTRACT = "killbilly"
AUTOTUNE_TX = 2
# the search's candidates and halving rounds: --autotune-only measures
# three over two rounds; the whole script one over one round, which checks
# the plumbing (a child's wall is mostly its start-up, PERF.md §5)
AUTOTUNE_SEARCH = (3, 2)
AUTOTUNE_SEARCH_WHOLE = (1, 1)
AUTOTUNE_TIMEOUT = 900   # s for one search (its children included)
# the profile (b)-(d) apply: K2 for every stream at 32 steps a round
AUTOTUNE_PROFILE = {"MYTHRIL_GPU_KERNEL": "xla",
                    "MYTHRIL_GPU_CIRCUIT_STEPS": 32}
_CHILD_LINE = re.compile(r"autotune child (\S+): rc=(-?\d+) wall=([\d.]+) s "
                         r"solver=(\S+) s k1_solve_rounds=(\S+)")


@contextlib.contextmanager
def _keep_largest_k1(largest, skip=None, every=None):
    """Keep the largest K1 launch (lanes x gates) inside the block: the host
    stream it was flattened from, a copy of its x, its seed, steps, walk
    depth and capacities. A launch made while `skip()` is true is not
    kept. `every`, a list, gets each launch kept the same way, and None
    for a launch whose stream was not tracked (its caller fails on it)."""
    from mythril_tpu_torch.gpu import ragged_kernel

    flatten = ragged_kernel.flatten_stream
    upload = ragged_kernel.device_flat
    real = ragged_kernel.run_round_ragged_kernel
    streams = {}

    def flattened(stream, caps):
        flat = flatten(stream, caps)
        if flat is not None:
            streams[id(flat)] = (flat, stream)
        return flat

    def uploaded(flat, device):
        out = upload(flat, device)
        if id(flat) in streams:
            streams[id(out)] = (out, streams[id(flat)][1])
        return out

    def keep(flat, x, seed, steps, walk_depth, caps):
        kept = streams.get(id(flat))
        size = x.shape[0] * flat.num_gates
        launch = None
        if kept is not None and kept[0] is flat and not (skip and skip()):
            launch = dict(size=size, stream=kept[1],
                          x=x.detach().cpu().clone(), seed=seed,
                          steps=steps, walk_depth=walk_depth,
                          caps=tuple(caps))
        if launch is not None and size > largest.get("size", -1):
            largest.update(launch)
        if every is not None and not (skip and skip()):
            every.append(launch)
        return real(flat, x, seed, steps, walk_depth, caps)

    ragged_kernel.flatten_stream = flattened
    ragged_kernel.device_flat = uploaded
    ragged_kernel.run_round_ragged_kernel = keep
    try:
        yield largest
    finally:
        ragged_kernel.flatten_stream = flatten
        ragged_kernel.device_flat = upload
        ragged_kernel.run_round_ragged_kernel = real


def _k2_kept(launch) -> dict:
    """A kept K2 launch (_keep_largest_k2) as plain CPU data for
    torch.save."""
    return {"tensors": {key: value.cpu() for key, value
                        in launch["xs"].tensors.items()},
            "num_cones": launch["xs"].num_cones, "pages": launch["pages"],
            "x": launch["x"].cpu(), "seed": launch["seed"],
            "steps": launch["steps"], "walk_depth": launch["walk_depth"]}


def _k2_restored(kept, device) -> dict:
    """A launch saved by _k2_kept, uploaded again through device_stream."""
    from mythril_tpu_torch.gpu import xla_kernel

    stream = SimpleNamespace(
        tensors={key: value.numpy() for key, value
                 in kept["tensors"].items()},
        num_cones=kept["num_cones"], pages=kept["pages"])
    return {**kept, "xs": xla_kernel.device_stream(stream, device),
            "x": kept["x"].to(device)}


def autotune_child(out_path, argv) -> int:
    """The port's CLI (`python -m mythril_tpu_torch` with `argv`) in this
    process, with K1's and K2's launches counted and their largest
    launches kept; both written to `out_path` (torch.save) when it ends.
    The autotune phase runs it as `python3 -c` in a new process, so the
    tuned profile is applied at that process's start, as for any
    `analyze`. The router's calibration launches are counted apart and
    never kept: the kept launches are the run's solve rounds."""
    import torch

    from mythril_tpu_torch.gpu import ragged_kernel, xla_kernel
    from mythril_tpu_torch.gpu.router import QueryRouter
    from mythril_tpu_torch.interfaces import cli

    calls = {"k1": 0, "k2": 0, "k1_cal": 0, "k2_cal": 0}
    calibrating = []
    real_k1 = ragged_kernel.run_round_ragged_kernel
    real_k2 = xla_kernel.run_round_xla_kernel

    def k1(*a, **k):
        calls["k1_cal" if calibrating else "k1"] += 1
        return real_k1(*a, **k)

    def k2(*a, **k):
        calls["k2_cal" if calibrating else "k2"] += 1
        return real_k2(*a, **k)

    def measured(real):
        def measure(*a, **k):
            calibrating.append(1)
            try:
                return real(*a, **k)
            finally:
                calibrating.pop()
        return measure

    ragged_kernel.run_round_ragged_kernel = k1
    xla_kernel.run_round_xla_kernel = k2
    for name in ("_measure_kernel_rate", "_measure_xla_rate"):
        setattr(QueryRouter, name, measured(getattr(QueryRouter, name)))
    k1_largest, k2_largest = {}, {}
    ragged_kernel.reset_launches()
    xla_kernel.reset_launches()
    rc = 0
    sys.argv = ["mythril_tpu_torch", *argv]
    with _keep_largest_k1(k1_largest, skip=lambda: bool(calibrating)), \
            _keep_largest_k2(k2_largest, skip=lambda: bool(calibrating)):
        try:
            cli.main()
        except SystemExit as done:
            rc = done.code if isinstance(done.code, int) else 1
    torch.save({"k1_launches": ragged_kernel.launches,
                "k2_launches": xla_kernel.launches,
                # the wrappers' calls, solve rounds and calibration apart:
                # on the CPU the plain versions run and count no launch
                "k1_calls": calls["k1"], "k2_calls": calls["k2"],
                "k1_calibration_calls": calls["k1_cal"],
                "k2_calibration_calls": calls["k2_cal"],
                "k1": {key: value for key, value in k1_largest.items()
                       if key != "size"} or None,
                "k2": _k2_kept(k2_largest) if k2_largest else None},
               out_path)
    return rc


def _autotune_search(device, folder, code_path, name, size, force=False):
    """`python -m mythril_tpu_torch autotune` on KILLBILLY in a new process
    (its stats JSON and each child's log line kept): a dict of the exit
    code, the wall, the summary, the search's stats and the children's
    (label, rc, wall, solver seconds, K1 solve rounds)."""
    stats_path = os.path.join(folder, f"{name}_stats.json")
    argv = [sys.executable, "-m", "mythril_tpu_torch", "autotune",
            "-f", code_path, "-t", str(AUTOTUNE_TX),
            "--candidates", str(size[0]), "--rounds", str(size[1]),
            "-v", "4"]
    if force:
        argv.append("--force")
    if device.type != "cuda":
        argv += ["--torch-device", "cpu"]
    start = time.monotonic()
    done = subprocess.run(
        argv, capture_output=True, text=True, timeout=AUTOTUNE_TIMEOUT,
        env={**os.environ,
             "MYTHRIL_GPU_CACHE_DIR": os.path.join(folder, "search_cache"),
             "MYTHRIL_GPU_STATS_JSON": stats_path})
    wall = time.monotonic() - start
    with open(os.path.join(folder, f"{name}.stderr"), "w") as fd:
        fd.write(done.stderr)
    summary = stats = {}
    if done.stdout.strip():
        summary = json.loads(done.stdout.strip().splitlines()[-1])
    if os.path.exists(stats_path):
        with open(stats_path) as fd:
            stats = json.load(fd)
    children = [
        {"label": m.group(1), "rc": int(m.group(2)),
         "wall_s": float(m.group(3)), "solver_s": m.group(4),
         "k1_solve_rounds": m.group(5)}
        for m in map(_CHILD_LINE.search, done.stderr.splitlines()) if m]
    return {"rc": done.returncode, "wall_s": wall, "summary": summary,
            "stats": stats, "children": children,
            "stderr": done.stderr[-1500:]}


def _autotune_profile_run(device, folder, code_path, name, cache_dir,
                          env_extra=None):
    """KILLBILLY (-t 2) through the CLI in a new process that applies the
    profile under `cache_dir` at its start (autotune_child): its exit code,
    wall, stats JSON, findings and the kept launches."""
    run_dir = os.path.join(folder, name)
    os.makedirs(run_dir, exist_ok=True)
    stats_path = os.path.join(run_dir, "stats.json")
    kept_path = os.path.join(run_dir, "launches.pt")
    argv = ["analyze", "-f", code_path, "-t", str(AUTOTUNE_TX), "-o", "json",
            "--pruning-factor", "1", "--execution-timeout",
            str(ANALYZE_TIMEOUT)]
    if device.type != "cuda":
        argv += ["--torch-device", "cpu"]
    code = ("import sys, chip_smoke; "
            f"sys.exit(chip_smoke.autotune_child({kept_path!r}, "
            f"{argv!r}))")
    env = {**os.environ, "MYTHRIL_GPU_CACHE_DIR": cache_dir,
           "MYTHRIL_GPU_STATS_JSON": stats_path, **(env_extra or {})}
    for knob in AUTOTUNE_PROFILE:
        if knob not in (env_extra or {}):
            env.pop(knob, None)
    env.pop("MYTHRIL_GPU_AUTOTUNE", None)
    from mythril_tpu_torch.tune import space

    env_knobs = sorted(name for name in space.knob_names() if name in env)
    start = time.monotonic()
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=ANALYZE_TIMEOUT + 120, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - start
    if done.returncode not in (0, 1):
        raise AssertionError(f"autotune: {name} exited {done.returncode}: "
                             f"{done.stderr[-1500:]}")
    import torch

    issues = json.loads(done.stdout.strip().splitlines()[-1])["issues"]
    with open(stats_path) as fd:
        stats = json.load(fd)
    return {"rc": done.returncode, "wall_s": wall, "stats": stats,
            "findings": sorted([i["swc-id"], i["function"], i["address"],
                                i["title"]] for i in issues),
            "kept": torch.load(kept_path, weights_only=False),
            "env_knobs": env_knobs}


def _hold_k1_launch(device, kept, window, counts, phase="autotune",
                    timed=True):
    """K1 bit for bit against its plain version on a launch kept by
    _keep_largest_k1 (its own x, seed, steps and walk depth), both timed
    there (K1 only when `timed`); launches made here are not counted.
    Emits one record of `phase`."""
    from mythril_tpu_torch.gpu import ragged_kernel

    launches = ragged_kernel.launches
    caps = ragged_kernel.KernelCaps(*kept["caps"])
    stream = kept["stream"]
    flat = ragged_kernel.device_flat(
        ragged_kernel.flatten_stream(stream, caps), device)
    x = kept["x"].to(device)
    args = (kept["seed"], kept["steps"], kept["walk_depth"])
    err, plain_ms = _compare_timed(flat, x, *args, caps)
    ms = None
    if device.type == "cuda" and timed:
        ms = _time_ms(lambda: ragged_kernel.run_round_ragged_kernel(
            flat, x, *args, caps), repeats=5)
    ragged_kernel.launches = launches
    bound_ms, bound_by, moved, ops = _bound(flat, stream.v1, x.shape[0],
                                            args[1], caps)
    emit({"phase": phase, "window": window,
          **_stream_fields(stream, flat), "lanes": x.shape[0],
          "steps": args[1], "walk_depth": args[2], **counts,
          "bit_identical": True, "max_abs_err": err,
          "ms": ms if ms is not None else "not measured",
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": moved, "ops": ops})
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _solve_launches(kept, kernel, on_card) -> int:
    """A kernel's solve-round launches in an autotune_child run: its
    wrapper's calls outside the router's calibration (on the card, where
    the module's count must also equal every call made)."""
    calls = kept[f"{kernel}_calls"]
    if on_card and kept[f"{kernel}_launches"] != (
            calls + kept[f"{kernel}_calibration_calls"]):
        raise AssertionError(f"autotune: {kernel}'s launch count "
                             f"{kept[kernel + '_launches']} is not its "
                             f"calls' {calls} + calibration "
                             f"{kept[kernel + '_calibration_calls']}")
    return calls


def _profile_leg_record(leg, run):
    stats = run["stats"]
    kept = run["kept"]
    return {"phase": "autotune", "leg": leg, "rc": run["rc"],
            "wall_s": round(run["wall_s"], 3),
            "kernel_backend": stats.get("kernel_backend"),
            "tuned_knobs_applied": stats.get("tuned_knobs_applied"),
            "tuned_profile_rejects": stats.get("tuned_profile_rejects"),
            "knobs": {name: stats["knobs"][name]
                      for name in AUTOTUNE_PROFILE},
            "k1_launches": kept["k1_launches"],
            "k1_solve_rounds": stats.get("kernel_launches"),
            "k2_launches": kept["k2_launches"],
            "k1_calls": kept["k1_calls"], "k2_calls": kept["k2_calls"],
            "k1_calibration_calls": kept["k1_calibration_calls"],
            "k2_calibration_calls": kept["k2_calibration_calls"],
            "k6_launches": stats.get("frontier_vmap_steps"),
            "findings": run["findings"]}


def phase_autotune(device, records=None, size=AUTOTUNE_SEARCH):
    """The autotune slice on the card (see the module note): (a) the search
    through `python -m mythril_tpu_torch autotune`; (b) a profile of
    AUTOTUNE_PROFILE applied at an analyze start; (c) the env shadowing
    the profile's kernel mode; (d) a corrupt profile. `records` holds the
    analyze phase's host run of KILLBILLY (None: run here); `size` is the
    search's (candidates, rounds). Returns the launches and holds for the
    kernels line."""
    from mythril_tpu_torch.service import calibration
    from mythril_tpu_torch.tune import space

    phase_start = time.monotonic()
    on_card = device.type == "cuda"
    platform = _platform_of(device)
    folder = os.path.abspath(os.path.join(OUT_DIR, "autotune"))
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    code = _killbilly_creation()
    code_path = os.path.join(folder, "killbilly.hex")
    with open(code_path, "w") as fd:
        fd.write(code)
    if records is not None and AUTOTUNE_CONTRACT in records:
        host = records[AUTOTUNE_CONTRACT]["cpu"]["findings"]
    else:
        _report, completed, record = _analyze_once(
            device, code, AUTOTUNE_TX, ANALYZE_TIMEOUT, "cpu", {})
        if not completed:
            raise AssertionError("autotune: the host run did not complete")
        host = record["findings"]

    # (a) the search on the card
    search = _autotune_search(device, folder, code_path, "search", size)
    summary = search["summary"]
    emit({"phase": "autotune", "leg": "search", "rc": search["rc"],
          "wall_s": round(search["wall_s"], 3), "summary": summary,
          "children": search["children"],
          "counters": {key: search["stats"].get(key) for key in (
              "autotune_candidates_tried", "autotune_rejected_parity",
              "autotune_rejected_regression")}})
    if search["rc"] != 0 or summary.get("autotune") not in (
            "tuned", "no_improvement"):
        raise AssertionError(f"autotune: the search failed: {summary}; "
                             f"{search['stderr']}")
    if summary["platform"] != platform:
        raise AssertionError(f"autotune: the profile's platform "
                             f"{summary['platform']!r} is not {platform!r}")
    failed = [c for c in summary["candidates"] if c.get("fail")]
    if failed:
        raise AssertionError(f"autotune: candidates failed: {failed}")
    tuned = summary["autotune"] == "tuned"
    if summary["candidates_tried"] != (summary["rejected_parity"]
                                       + summary["rejected_regression"]
                                       + (1 if tuned else 0)):
        raise AssertionError(f"autotune: the outcomes do not add up: "
                             f"{summary}")
    counters = search["stats"]
    if (counters.get("autotune_candidates_tried"),
            counters.get("autotune_rejected_parity"),
            counters.get("autotune_rejected_regression")) != (
            summary["candidates_tried"], summary["rejected_parity"],
            summary["rejected_regression"]):
        raise AssertionError(f"autotune: the search's stats JSON "
                             f"disagrees with its summary: {counters}")
    if len(search["children"]) < 1 + summary["candidates_tried"]:
        raise AssertionError(f"autotune: {len(search['children'])} child "
                             f"lines for {summary['candidates_tried']} "
                             "candidates and the baseline")
    again = None
    if tuned:
        again = _autotune_search(device, folder, code_path, "again", size)
        emit({"phase": "autotune", "leg": "search-again",
              "rc": again["rc"], "wall_s": round(again["wall_s"], 3),
              "summary": again["summary"], "children": again["children"]})
        if again["rc"] != 0 or again["summary"].get("autotune") \
                != "already_tuned" or again["children"]:
            raise AssertionError(f"autotune: a second search was not "
                                 f"answered by the profile: {again}")

    # (b)-(d) run side by side, each in its own process: the profile
    # applied, the env over it, a corrupt profile; checked after
    profile_cache = os.path.join(folder, "profile_cache")
    with _env(MYTHRIL_GPU_CACHE_DIR=profile_cache):
        if not calibration.save_tuned(platform, {
                "knobs": dict(AUTOTUNE_PROFILE),
                "probe_digest": "chip_smoke"}):
            raise AssertionError("autotune: the profile was not saved")
    corrupt_cache = os.path.join(folder, "corrupt_cache")
    os.makedirs(corrupt_cache)
    with open(os.path.join(corrupt_cache, "calibration.json"), "w") as fd:
        fd.write("{ torn json")
    legs = {"tuned": (profile_cache, None),
            "env": (profile_cache, {"MYTHRIL_GPU_KERNEL": "pallas"}),
            "corrupt": (corrupt_cache, None)}
    runs, errors = {}, []

    def run_leg(name):
        try:
            runs[name] = _autotune_profile_run(
                device, folder, code_path, name, *legs[name])
        except Exception as error:  # reported below, then the phase fails
            errors.append(f"{name}: {error}")

    threads = [threading.Thread(target=run_leg, args=(name,))
               for name in legs]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise AssertionError("autotune: " + "; ".join(errors))

    # (b) a profile applied at an analyze start
    tuned_run = runs["tuned"]
    emit(_profile_leg_record("tuned", tuned_run))
    stats = tuned_run["stats"]
    kept = tuned_run["kept"]
    want = {name: {"value": value, "source": "tuned"}
            for name, value in AUTOTUNE_PROFILE.items()}
    if any(stats["knobs"][name] != want[name] for name in want) \
            or stats["tuned_knobs_applied"] != 2 \
            or stats["kernel_backend"] != "xla":
        raise AssertionError(f"autotune: the profile did not apply: "
                             f"{_profile_leg_record('tuned', tuned_run)}")
    if _solve_launches(kept, "k2", on_card) < 1 \
            or _solve_launches(kept, "k1", on_card) != 0 \
            or kept["k1_calibration_calls"] != 0 \
            or stats["kernel_launches"] != 0 or kept["k2"] is None:
        raise AssertionError(f"autotune: under the xla profile K2 must run "
                             f"and K1 must not: "
                             f"{_profile_leg_record('tuned', tuned_run)}")
    if tuned_run["findings"] != host:
        raise AssertionError(f"autotune: the tuned run's findings "
                             f"{tuned_run['findings']} are not the host's "
                             f"{host}")
    launch = _k2_restored(kept["k2"], device)
    if launch["steps"] != AUTOTUNE_PROFILE["MYTHRIL_GPU_CIRCUIT_STEPS"]:
        raise AssertionError(f"autotune: K2 ran {launch['steps']} steps")
    k2_hold = _hold_k2(device, launch, "autotune-profile",
                       {"k2_launches": kept["k2_launches"]}, timed=True)

    # (c) an explicit env var shadows the profile's kernel mode
    env_run = runs["env"]
    emit(_profile_leg_record("env", env_run))
    stats, kept = env_run["stats"], env_run["kept"]
    if stats["knobs"]["MYTHRIL_GPU_KERNEL"] != {"value": "pallas",
                                               "source": "env"} \
            or stats["knobs"]["MYTHRIL_GPU_CIRCUIT_STEPS"] != want[
                "MYTHRIL_GPU_CIRCUIT_STEPS"] \
            or stats["tuned_knobs_applied"] != 1 \
            or _solve_launches(kept, "k1", on_card) < 1 \
            or kept["k1"] is None or env_run["findings"] != host:
        raise AssertionError(f"autotune: the env did not shadow the "
                             f"profile: {_profile_leg_record('env', env_run)}")
    k1_hold = _hold_k1_launch(device, kept["k1"], "autotune-env",
                              {"k1_launches": kept["k1_launches"]})

    # (d) a corrupt profile: counted, ignored, the run on the defaults
    corrupt_run = runs["corrupt"]
    emit(_profile_leg_record("corrupt", corrupt_run))
    stats, kept = corrupt_run["stats"], corrupt_run["kept"]
    # every knob from its default (one the child's env sets: from it)
    sources = {name: entry["source"]
               for name, entry in stats["knobs"].items()}
    if stats["tuned_profile_rejects"] != 1 \
            or stats["tuned_knobs_applied"] != 0 \
            or sources != {name: "env" if name in corrupt_run["env_knobs"]
                           else "default" for name in space.knob_names()} \
            or not stats.get("completed") \
            or _solve_launches(kept, "k1", on_card) < 1 \
            or stats["kernel_backend"] != "pallas" \
            or corrupt_run["findings"] != host:
        raise AssertionError(f"autotune: the corrupt profile was not "
                             f"ignored: "
                             f"{_profile_leg_record('corrupt', corrupt_run)}")
    seconds = time.monotonic() - phase_start
    emit({"phase": "autotune", "seconds": round(seconds, 3),
          "search_wall_s": round(search["wall_s"], 3),
          "nvidia_smi": nvidia_smi_line() if on_card else "not measured"})
    return {
        "summary": summary,
        "children": search["children"],
        "k1_launches": {"env": env_run["kept"]["k1_launches"],
                        "corrupt": corrupt_run["kept"]["k1_launches"]},
        "k2_launches": {"tuned": tuned_run["kept"]["k2_launches"],
                        "env": env_run["kept"]["k2_launches"],
                        "corrupt": corrupt_run["kept"]["k2_launches"]},
        "search_k1_solve_rounds": sum(
            int(child["k1_solve_rounds"]) for child in search["children"]
            if child["k1_solve_rounds"].isdigit()),
        "k1_hold": k1_hold, "k2_hold": k2_hold,
    }


def _platform_of(device) -> str:
    """The platform stamp of a run on `device`: the card's name, or
    "cpu"."""
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def autotune_only(device) -> int:
    """Env, build and the autotune phase (with its own host run)."""
    phase_build()
    result = phase_autotune(device)
    emit({"phase": "autotune", "k1_launches": result["k1_launches"],
          "k2_launches": result["k2_launches"],
          "search_k1_solve_rounds": result["search_k1_solve_rounds"],
          "k2_profile_launch": {key: result["k2_hold"].get(key) for key in (
              "ms", "plain_ms", "bound_ms", "bound_by")}})
    return 0


# -- the mesh phase: K4 on a virtual mesh ------------------------------------

MESH_SHARDS = 8        # --mesh-only: dryrun_multichip(8, virtual=True)
MESH_SHARDS_WHOLE = 4  # the whole script: dryrun_multichip(4, virtual=True)
K4_REPEATS = 5
HOLD_WORKERS = 4       # processes running the mesh phase's host holds


def _hold_k4_shard(placed, grid, out, i, j, seed, steps, walk_depth,
                   on):
    """Shard (i, j) of a K4 round against run_round_circuit_plain on its
    blocks with its folded seed, the plain run on device `on`: (max abs
    error, which must be 0, and the plain run's ms). Raises unless bit for
    bit."""
    import torch

    from mythril_tpu_torch.gpu import circuit, circuit_kernel

    tables = {key: value.to(on) for key, value
              in placed.tables[i][j].items()}
    x = grid.block(i, j).to(on)
    (want_x, want_found), ms = _timed_once(
        on, lambda: circuit_kernel.run_round_circuit_plain(
            tables, x, circuit.shard_seed(seed, i * 7919 + j), steps,
            walk_depth))
    got_x, got_found = out[0].block(i, j).to(on), out[1].block(i, j).to(on)
    if not (torch.equal(got_x, want_x) and torch.equal(got_found,
                                                        want_found)):
        raise AssertionError(
            f"mesh: K4's shard ({i}, {j}) disagrees with the plain round: "
            f"{int((got_x != want_x).sum())} x cells, "
            f"{int((got_found != want_found).sum())} found cells")
    return max(int((got_x - want_x).abs().max()),
               int((got_found.int() - want_found.int()).abs().max())), ms


def _plain_round_on_host(tables, x, seed, steps, walk_depth):
    """run_round_circuit_plain on numpy blocks, in a process of the mesh
    phase's pool (one thread each: the pool's processes run side by side).
    Returns (x, found) as numpy arrays."""
    import torch

    from mythril_tpu_torch.gpu import circuit_kernel

    torch.set_num_threads(1)
    out_x, found = circuit_kernel.run_round_circuit_plain(
        {key: torch.from_numpy(value) for key, value in tables.items()},
        torch.from_numpy(x), seed, steps, walk_depth)
    return out_x.numpy(), found.numpy()


@contextlib.contextmanager
def _hold_every_k4_round(device, kept):
    """Every K4 round the backend runs inside the block, held: each
    shard's (x, found) bit for bit against run_round_circuit_plain on that
    shard's blocks with its folded seed, and solved against found.any
    over mp. The plain runs go on the host, in HOLD_WORKERS spawned
    processes while the dryrun goes on (at one query slot and four lanes
    a shard the plain round's small ops run faster there than on the
    card); every one is waited for and compared when the block ends, and
    the pool is shut down. The first round, kept for the timing (the
    dryrun's leg 1 runs first), is held on `device` too, its plain runs
    timed there. Each shard's calls of K3's wrapper are counted by (dp,
    mp) index (on the card each is a launch), and the rounds by batch (a
    batch a placement of tables)."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    from mythril_tpu_torch.gpu import circuit, circuit_kernel

    real_make = circuit.make_sharded_round
    real_launch = circuit_kernel.run_round_circuit_kernel
    shard_of = {}
    kept.update(batches=[], by_shard={}, max_abs_err=0, launches=0)
    placements = []
    host_tables = {}  # dp block -> its tables on the host, this placement
    pending = []  # (shard, round, K4's x and found, the plain run)
    pool = concurrent.futures.ProcessPoolExecutor(
        HOLD_WORKERS, mp_context=multiprocessing.get_context("spawn"))

    def host(tensor):
        return tensor.detach().cpu().numpy().copy()

    def launch(tensors, x, seed, steps, walk_depth, layout=None):
        shard = shard_of.get(id(x))
        before = circuit_kernel.launches
        out = real_launch(tensors, x, seed, steps, walk_depth,
                          layout=layout)
        if shard is not None:
            key = f"{shard[0]},{shard[1]}"
            kept["by_shard"][key] = kept["by_shard"].get(key, 0) + 1
            kept["launches"] += circuit_kernel.launches - before
        return out

    def make(mesh, steps, walk_depth):
        fn = real_make(mesh, steps, walk_depth)

        def held(placed, grid, seed):
            if not placements or placements[-1] is not placed:
                placements.append(placed)
                kept["batches"].append(0)
                host_tables.clear()
            inputs = [[host(grid.block(i, j)) for j in range(mesh.mp)]
                      for i in range(mesh.dp)]
            shard_of.clear()
            shard_of.update({id(grid.block(i, j)): (i, j)
                             for i in range(mesh.dp)
                             for j in range(mesh.mp)})
            out = fn(placed, grid, seed)
            shard_of.clear()
            launches = circuit_kernel.launches
            first = "placed" not in kept
            plain_ms, err = 0.0, 0
            for i in range(mesh.dp):
                if i not in host_tables:
                    host_tables[i] = {key: host(value) for key, value
                                      in placed.tables[i][0].items()}
                for j in range(mesh.mp):
                    pending.append((
                        (i, j), sum(kept["batches"]), host(out[0].block(
                            i, j)), host(out[1].block(i, j)),
                        pool.submit(_plain_round_on_host, host_tables[i],
                                    inputs[i][j], circuit.shard_seed(
                                        seed, i * circuit.SHARD_DP_STRIDE
                                        + j), steps, walk_depth)))
                    if first:
                        shard_err, ms = _hold_k4_shard(
                            placed, grid, out, i, j, seed, steps,
                            walk_depth, device)
                        err, plain_ms = max(err, shard_err), plain_ms + ms
            if not torch.equal(out[2].cpu(),
                               out[1].gather("cpu").any(dim=1)):
                raise AssertionError("mesh: K4's solved is not found.any "
                                     "over mp")
            circuit_kernel.launches = launches  # the holds launch nothing
            kept["batches"][-1] += 1
            kept["max_abs_err"] = max(kept["max_abs_err"], err)
            if first:
                kept.update(mesh=mesh, placed=placed, seed=seed,
                            steps=steps, walk_depth=walk_depth,
                            plain_ms=plain_ms, grid=circuit.ShardGrid(
                                mesh, [[block.clone() for block in row]
                                       for row in grid.blocks]))
            return out

        return held

    circuit.make_sharded_round = make
    circuit_kernel.run_round_circuit_kernel = launch
    try:
        yield kept
        for shard, round_index, got_x, got_found, plain in pending:
            want_x, want_found = plain.result()
            if not (np.array_equal(got_x, want_x)
                    and np.array_equal(got_found, want_found)):
                raise AssertionError(
                    f"mesh: K4's shard {shard} in round {round_index} "
                    f"disagrees with the plain round: "
                    f"{int((got_x != want_x).sum())} x cells, "
                    f"{int((got_found != want_found).sum())} found cells")
            kept["max_abs_err"] = max(
                kept["max_abs_err"],
                int(np.abs(got_x.astype(np.int64) - want_x).max()),
                int(np.abs(got_found.astype(np.int64)
                           - want_found).max()))
        kept["held_shard_rounds"] = len(pending)
    finally:
        circuit.make_sharded_round = real_make
        circuit_kernel.run_round_circuit_kernel = real_launch
        pool.shutdown(wait=True, cancel_futures=True)


def _k4_bound(placed, grid, steps, walk_depth):
    """The least time of one K4 round: the slowest device's share, the
    devices running in parallel. A device reads the tables of each dp
    block placed on it once (a block's mp shards on one device share one
    copy, whose second read comes from L2), and moves each of its shards'
    x in and out and found out; its operations are its shards' (counted
    as _k3_bound counts each shard's blocks). On a virtual mesh (every
    shard on one device) this is K3's bound on the batch unsharded."""
    mesh = grid.mesh
    shares = {}  # device -> [bytes, ops, dp blocks whose tables it read]
    for i in range(mesh.dp):
        for j in range(mesh.mp):
            tables, block = placed.tables[i][j], grid.block(i, j)
            share = shares.setdefault(mesh.shard(i, j), [0, 0, set()])
            if i not in share[2]:
                share[2].add(i)
                share[0] += _k3_table_bytes(tables)
            share[0] += _k3_lane_bytes(block)
            share[1] += _k3_bound(tables, block, steps, walk_depth)[3]
    times = [(max(moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S),
              moved, ops) for moved, ops, _blocks in shares.values()]
    slowest, moved, ops = max(times)
    return (slowest * 1e3, "bytes" if moved / HBM_BYTES_PER_S
            >= ops / CUDA_CORE_OPS_PER_S else "operations", moved, ops)


def _time_k4(device, kept):
    """K4 under CUDA events on the kept round (its own inputs and seed),
    beside K3 on the same batch unsharded (the dp blocks' tables and the
    lanes gathered, with the round's seed); neither counted."""
    import torch

    from mythril_tpu_torch.gpu import circuit, circuit_kernel

    mesh, placed, grid = kept["mesh"], kept["placed"], kept["grid"]
    args = (kept["steps"], kept["walk_depth"])
    launches = circuit_kernel.launches
    fn = circuit.make_sharded_round(mesh, *args)
    tensors = {key: torch.cat([placed.tables[i][0][key]
                               for i in range(mesh.dp)]).contiguous()
               for key in circuit.TENSOR_KEYS}
    x = grid.gather(mesh.lead).contiguous()
    layout = circuit_kernel.circuit_layout(tensors)
    k4_ms = k3_ms = None
    if device.type == "cuda":
        k4_ms = _time_ms(lambda: fn(placed, grid, kept["seed"]), K4_REPEATS)
        k3_ms = _time_ms(lambda: circuit_kernel.run_round_circuit_kernel(
            tensors, x, kept["seed"], *args, layout=layout), K4_REPEATS)
    circuit_kernel.launches = launches
    bound_ms, bound_by, moved, ops = _k4_bound(placed, grid, *args)
    k3_bound = _k3_bound(tensors, x, *args)
    q_count, lanes, v1 = x.shape
    return {"queries": q_count, "lanes": lanes, "v1": v1,
            "levels": tensors["out_idx"].shape[1],
            "width": tensors["out_idx"].shape[2], "steps": args[0],
            "walk_depth": args[1], "dp": mesh.dp, "mp": mesh.mp,
            "ms": k4_ms, "plain_ms": kept["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": moved, "ops": ops,
            "k3_unsharded_ms": k3_ms, "k3_unsharded_bound_ms": k3_bound[0],
            "k3_unsharded_bound_by": k3_bound[1]}


def phase_mesh(device, shards=MESH_SHARDS, deep=True):
    """graft.dryrun_multichip(shards, virtual=True) on the card (leg 2 with
    `deep`), every K4 round held per shard (_hold_every_k4_round), then K4
    timed on leg 1's first round beside K3 unsharded. The K3 launches K4
    made are counted from just before the dryrun to just after it."""
    from mythril_tpu_torch import graft
    from mythril_tpu_torch.gpu import circuit_kernel

    kept = {}
    circuit_kernel.reset_launches()  # the dryrun's count starts here
    start = time.monotonic()
    with _hold_every_k4_round(device, kept):
        summary = graft.dryrun_multichip(shards, device=device, virtual=True,
                                         deep=deep)
    launches = circuit_kernel.launches  # ... and ends here
    wall = time.monotonic() - start
    if device.type == "cuda" and launches != kept["launches"]:
        raise AssertionError(f"mesh: K3 launched {launches} times, K4's "
                             f"shards {kept['launches']}")
    if summary["dp"] * summary["mp"] != shards or not kept["batches"] \
            or len(kept["by_shard"]) != shards:
        raise AssertionError(f"mesh: K4 did not run every shard of a "
                             f"{shards}-shard mesh ({summary}, launches by "
                             f"shard {kept['by_shard']})")
    if len(kept["batches"]) != (2 if deep else 1):
        raise AssertionError(f"mesh: K4 rounds by batch "
                             f"{kept['batches']}")
    if kept["held_shard_rounds"] != sum(kept["by_shard"].values()) \
            or kept["held_shard_rounds"] != shards * sum(kept["batches"]):
        raise AssertionError(f"mesh: {kept['held_shard_rounds']} shard "
                             f"rounds held, K3 called by shard "
                             f"{kept['by_shard']}")
    timed = _time_k4(device, kept)
    emit({"phase": "mesh", "shards": shards, "placement":
          summary["placement"], "summary": summary,
          "wall_s": round(wall, 3), "k4_rounds_by_leg": kept["batches"],
          "launches_by_shard": kept["by_shard"], "k3_launches": launches,
          "held_shard_rounds": kept["held_shard_rounds"],
          "bit_identical": True, "max_abs_err": kept["max_abs_err"],
          **{key: ("not measured" if value is None else value)
             for key, value in timed.items()}})
    return {**timed, "launches": launches,
            "launches_by_shard": kept["by_shard"],
            "max_abs_err": kept["max_abs_err"]}


def mesh_only(device) -> int:
    """Env, build and the mesh phase at MESH_SHARDS, both legs."""
    phase_build()
    phase_mesh(device)
    return 0


# -- the options phase: the engine options analyze reads ----------------------

# leg -> (CLI fields, runtime code): KILLBILLY -t 2 under each option; the
# prioritiser ranks the runtime code's selectors (a creation run's code
# has no function entries to rank)
OPTION_LEGS = {"summaries": ({"enable_summaries": True}, False),
               "state_merging": ({"enable_state_merging": True}, False),
               "incremental_txs_off": ({"disable_incremental_txs": True},
                                       True)}
OPTION_LEGS_WHOLE = ("summaries",)


def _cli_dump(device, flag, path, code, solver_backend):
    """The port's CLI, in process: `analyze -c code -t 1 flag path` on
    `solver_backend` (the card, or the named CPU device); its K1 launches."""
    from mythril_tpu_torch.gpu import ragged_kernel
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser import cfg
    from mythril_tpu_torch.laser.function_managers import (
        keccak_function_manager,
    )
    from mythril_tpu_torch.laser.state.world_state import WorldState
    from mythril_tpu_torch.laser.transaction.models import tx_id_manager
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    # the transaction ids, node uids, balance arrays and hash symbols
    # counted from the start, as in a new process: the dump carries them
    tx_id_manager.restart_counter()
    cfg._next_uid[0] = 0
    WorldState.next_balance_id = 1
    keccak_function_manager.reset()
    argv = ["analyze", "-c", code, "-t", "1", flag, path,
            "--execution-timeout", str(ANALYZE_TIMEOUT), "--solver-backend",
            solver_backend]
    if solver_backend == "gpu" and device.type != "cuda":
        argv += ["--torch-device", str(device)]
    args.reset()
    clear_caches()
    before = ragged_kernel.launches
    try:
        code_rc = cli.execute_command(cli.build_parser().parse_args(argv))
    finally:
        args.reset()
    if code_rc != 0:
        raise AssertionError(f"options: {flag} exited {code_rc}")
    with open(path) as handle:
        return handle.read(), ragged_kernel.launches - before


def _graph_sets(html):
    found = re.findall(r"new vis\.DataSet\((\[.*?\])\);\n", html)
    if len(found) != 2:
        raise AssertionError("options: -g wrote no vis.js node and edge "
                             "sets")
    return [sorted(json.dumps(item, sort_keys=True)
                   for item in json.loads(text)) for text in found]


def _statespace_dumps(device):
    """-j and -g of KILLBILLY -t 1 on the host and the device backend: the
    device's -j byte for byte the host's, its -g the same node and edge
    sets, each non-empty (the CPU tests hold both to the JAX package)."""
    folder = os.path.join(OUT_DIR, "options")
    os.makedirs(folder, exist_ok=True)
    code = _killbilly_creation()
    out = {}
    for flag, name in (("-j", "statespace.json"), ("-g", "graph.html")):
        for backend in ("cpu", "gpu"):
            out[flag, backend] = _cli_dump(
                device, flag, os.path.join(folder, f"{backend}-{name}"),
                code, backend)
    if out["-j", "gpu"][0] != out["-j", "cpu"][0]:
        raise AssertionError("options: -j on the device differs from the "
                             "host's")
    dump = json.loads(out["-j", "gpu"][0])
    nodes, edges = _graph_sets(out["-g", "gpu"][0])
    if _graph_sets(out["-g", "cpu"][0]) != [nodes, edges]:
        raise AssertionError("options: -g on the device differs from the "
                             "host's")
    if not (dump["nodes"] and dump["edges"] and nodes and edges):
        raise AssertionError("options: an empty statespace dump")
    record = {"phase": "options", "leg": "dumps",
              "statespace_json_bytes": len(out["-j", "gpu"][0]),
              "statespace_nodes": len(dump["nodes"]),
              "statespace_edges": len(dump["edges"]),
              "graph_nodes": len(nodes), "graph_edges": len(edges),
              "k1_launches": out["-j", "gpu"][1] + out["-g", "gpu"][1]}
    emit(record)
    return record


def phase_options(device, legs=tuple(OPTION_LEGS)):
    """KILLBILLY -t 2 under each option leg, on the host and the device
    backend: the findings equal at issue granularity, K1 and K6 launched
    (counted from just before the device run to just after it: solve
    rounds past the calibration's; no K6 step under summaries, whose
    execute_state hook keeps the states off the batched frontier, as in
    the JAX package), every K1 launch held bit for bit
    against its plain version (the largest timed); then the -j and -g
    dumps (_statespace_dumps). Returns the launches by leg."""
    runtime = None
    launches = {"k1": {}, "k6": {}}
    err = 0
    timed = {}
    for leg in legs:
        engine, on_runtime = OPTION_LEGS[leg]
        if on_runtime:
            from mythril_tpu_torch.disasm.asm import easm_to_code

            runtime = runtime or easm_to_code(KILLBILLY_EASM).hex()
            code, engine = runtime, {**engine, "bin_runtime": True}
        else:
            code = _killbilly_creation()
        _report, host_done, host = _analyze_once(
            device, code, 2, ANALYZE_TIMEOUT, "cpu", {}, engine=engine)
        every = []
        with _keep_largest_k1({}, every=every):
            _report, done, record = _analyze_once(
                device, code, 2, ANALYZE_TIMEOUT, "gpu", {}, engine=engine)
        k1, k6 = record["kernel_launches"], record["k6_launches"]
        solve_k1 = k1 - record["calibration_launches"]
        # every K1 launch kept, so every one is held below (on the CPU the
        # plain version runs and counts no launch)
        if None in every or (device.type == "cuda" and len(every) != k1):
            raise AssertionError(
                f"options: {leg}: {every.count(None)} of "
                f"{len(every)} K1 calls untracked, {k1} launches counted")
        emit({"phase": "options", "leg": leg, "engine": engine,
              "host_wall_s": host["wall_s"], "device_wall_s":
              record["wall_s"], "k1_launches": k1,
              "k1_calibration_launches": record["calibration_launches"],
              "k6_launches": k6, "k1_kept": len(every),
              "frontier": record["frontier"],
              "device_batch_queries": record["device_batch_queries"],
              "device_batch_hits": record["device_batch_hits"],
              "aig_device_component_hits":
                  record["aig_device_component_hits"],
              "findings": record["findings"],
              "host_findings": host["findings"]})
        if not (done and host_done):
            raise AssertionError(f"options: {leg} did not complete")
        if record["findings"] != host["findings"]:
            raise AssertionError(
                f"options: {leg}: findings {record['findings']} differ "
                f"from the host backend's {host['findings']}")
        if not host["findings"]:
            raise AssertionError(f"options: {leg} found nothing")
        # the summary plugin's execute_state hook keeps every state off
        # the batched frontier, in the JAX package too: no K6 step there
        stepped = record["frontier"]["frontier_vmap_steps"]
        if solve_k1 <= 0 or (k6 == 0) != (leg == "summaries") \
                or (stepped == 0) != (leg == "summaries"):
            raise AssertionError(f"options: {leg}: K1 {solve_k1} solve "
                                 f"rounds, K6 {k6} launches, {stepped} "
                                 f"batched steps")
        largest = max(every, key=lambda launch: launch["size"])
        for index, launch in enumerate(every):
            held = _hold_k1_launch(device, launch, f"{leg}-{index}",
                                   {"leg": leg}, phase="options",
                                   timed=launch is largest)
            err = max(err, held["max_abs_err"])
            if launch is largest and (
                    held["ms"] is not None or not timed):
                timed.setdefault(leg, held)
        launches["k1"][leg], launches["k6"][leg] = k1, k6
    dumps = _statespace_dumps(device)
    return {"launches": launches, "max_abs_err": err, "timed": timed,
            "dump_k1_launches": dumps["k1_launches"]}


def options_only(device) -> int:
    """Env, build and the options phase, every leg."""
    phase_build()
    phase_options(device)
    return 0


INPUTS_ADDRESS = "0x" + "4b" * 20
# KILLBILLY whose kill() first reads an unlock flag from storage slot 0:
# `analyze -a` reaches the chain for the slot (eth_getStorageAt) as well
# as for the code
GUARDED_KILLBILLY_EASM = """
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0xe0
    SHR
    DUP1
    PUSH4 0x41c0e1b5
    EQ
    PUSH1 @kill
    JUMPI
    STOP
:kill
    JUMPDEST
    PUSH1 0x00
    SLOAD
    PUSH1 @open
    JUMPI
    STOP
:open
    JUMPDEST
    CALLER
    SELFDESTRUCT
"""
# the concolic input: a branch on calldata[0:32] == 42, run with 7
CONCOLIC_EASM = """
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0x2a
    EQ
    PUSH1 @eq
    JUMPI
    STOP
:eq
    JUMPDEST
    PUSH1 0x01
    PUSH1 0x00
    SSTORE
    STOP
"""
READ_STORAGE_FORMS = ("1", "1,2", "2,2,array", "mapping,3,alice,bob")
# processes holding the inputs phase's K1 launches against the plain round
# on the host (a plain round there takes 0.6-21 s at the card's 64 lanes
# and 64 steps)
INPUTS_HOLD_WORKERS = 6


def _slot_of(data: bytes) -> int:
    from mythril_tpu_torch.utils.keccak import keccak256

    return int.from_bytes(keccak256(data), "big")


def _inputs_storage() -> dict:
    """The pinned slots of INPUTS_ADDRESS: the unlock flag, two plain
    slots, an array of two words at keccak(2) and a mapping at position 3
    keyed "alice" and "bob"."""
    array = _slot_of((2).to_bytes(32, "big"))
    storage = {0: 1, 1: 0x2A, 2: 0x2B, array: 0x100, array + 1: 0x101}
    for key, value in (("alice", 0xA11CE), ("bob", 0xB0B)):
        storage[_slot_of(key.encode().ljust(32, b"\x00")
                         + (3).to_bytes(32, "big"))] = value
    return storage


def _expected_storage_lines(form, storage) -> str:
    """read-storage's output for `form` from the pinned table, by the
    solidity layout's slot math."""
    def word(slot):
        return "0x" + storage.get(slot, 0).to_bytes(32, "big").hex()

    parts = form.split(",")
    if parts[0] == "mapping":
        slots = [_slot_of(key.encode().ljust(32, b"\x00")
                          + int(parts[1]).to_bytes(32, "big"))
                 for key in parts[2:]]
        if len(slots) == 1:
            return f"{slots[0]}: {word(slots[0])}"
        return "\n".join(f"{hex(slot)}: {word(slot)}" for slot in slots)
    position = int(parts[0])
    length = int(parts[1]) if len(parts) > 1 else 1
    if len(parts) == 3 and parts[2] == "array":
        position = _slot_of(position.to_bytes(32, "big"))
    if length == 1:
        return f"{position}: {word(position)}"
    return "\n".join(f"{hex(slot)}: {word(slot)}"
                     for slot in range(position, position + length))


def _cli_run(device, argv, solver_backend=None):
    """The port's CLI in this process from fresh solve state: (exit code,
    stdout, K1 launches, of them the router's calibration's, K6 launches,
    wall seconds). `solver_backend` adds the device flags (the named CPU
    device off the card)."""
    import io

    from mythril_tpu_torch.gpu import frontier_kernel, ragged_kernel
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches

    argv = list(argv)
    if solver_backend is not None:
        argv += ["--solver-backend", solver_backend]
        if solver_backend == "gpu" and device.type != "cuda":
            argv += ["--torch-device", str(device)]
    args.reset()
    clear_caches()
    frontend._global_blaster = None
    before = ragged_kernel.launches
    frontier_kernel.reset_launches()
    calibration = {}
    out = io.StringIO()
    torch_sync(device)
    start = time.monotonic()
    try:
        with _calibration_launches(calibration), \
                contextlib.redirect_stdout(out):
            code = cli.execute_command(cli.build_parser().parse_args(argv))
        torch_sync(device)
    finally:
        args.reset()
    return {"rc": code, "stdout": out.getvalue(),
            "k1": ragged_kernel.launches - before,
            "k1_calibration": calibration.get("launches", 0),
            "k6": frontier_kernel.launches,
            "wall_s": time.monotonic() - start}


def _json_issue_keys(stdout):
    return sorted([issue["swc-id"], issue["function"], issue["address"],
                   issue["title"]]
                  for issue in json.loads(stdout)["issues"])


def _inputs_device_leg(device, leg, argv, every):
    """One device-backend CLI run with every K1 launch kept in `every`
    (on the card each launch must be kept)."""
    with _keep_largest_k1({}, every=every):
        run = _cli_run(device, argv, "gpu")
    if None in every or (device.type == "cuda" and len(every) != run["k1"]):
        raise AssertionError(f"inputs: {leg}: {every.count(None)} of "
                             f"{len(every)} K1 calls untracked, {run['k1']} "
                             f"launches counted")
    return run


def _k1_plain_on_host(flat, x, seed, steps, walk_depth, caps):
    """run_round_ragged_plain on a host FlatStream and a numpy x, in a
    process of the inputs phase's pool (one thread each): ((x, found) as
    numpy arrays, the run's ms). The plain round's salts are integer
    hashes, so its result does not depend on the device it runs on."""
    import torch

    from mythril_tpu_torch.gpu import ragged_kernel

    torch.set_num_threads(1)
    flat = ragged_kernel.device_flat(flat, torch.device("cpu"))
    began = time.perf_counter()
    out_x, found = ragged_kernel.run_round_ragged_plain(
        flat, torch.from_numpy(x), seed, steps, walk_depth,
        ragged_kernel.KernelCaps(*caps))
    return (out_x.numpy(), found.numpy()), \
        (time.perf_counter() - began) * 1e3


def _warm_hold_worker() -> None:
    """Import what a hold needs, so a pool process pays its start-up while
    the phase's first legs run."""
    import torch  # noqa: F401

    from mythril_tpu_torch.gpu import ragged_kernel  # noqa: F401


def _launch_key(host_flat, launch) -> str:
    """A digest of one K1 launch's inputs: the flattened stream's tables,
    x, seed, steps, walk depth and capacities. Two launches with one key
    have one plain result (the router's calibration launches repeat in
    every run)."""
    import hashlib

    digest = hashlib.sha1()
    for name in sorted(host_flat.arrays):
        digest.update(name.encode())
        digest.update(host_flat.arrays[name].tobytes())
    digest.update(launch["x"].numpy().tobytes())
    digest.update(repr((launch["seed"], launch["steps"],
                        launch["walk_depth"], launch["caps"])).encode())
    return digest.hexdigest()


def _submit_inputs_holds(device, leg, every, pool, pending,
                         largest_only=False, plain_runs=None):
    """Each kept K1 launch of `leg` (the largest alone with
    `largest_only`) run again on `device` (its output kept on the host;
    the largest also timed under CUDA events) and its plain version
    submitted to the host pool, once for launches with the same inputs
    (`plain_runs`, a dict shared by the phase's legs, maps _launch_key to
    the submitted run); launches made here are not counted. The
    comparisons wait for _collect_inputs_holds."""
    from mythril_tpu_torch.gpu import ragged_kernel

    if not every:
        return
    plain_runs = {} if plain_runs is None else plain_runs
    launches = ragged_kernel.launches
    largest = max(every, key=lambda launch: launch["size"])
    for index, launch in enumerate(every):
        if largest_only and launch is not largest:
            continue
        caps = ragged_kernel.KernelCaps(*launch["caps"])
        host_flat = ragged_kernel.flatten_stream(launch["stream"], caps)
        key = _launch_key(host_flat, launch)
        if key not in plain_runs:
            plain_runs[key] = pool.submit(
                _k1_plain_on_host, host_flat, launch["x"].numpy(),
                launch["seed"], launch["steps"], launch["walk_depth"],
                tuple(caps))
        flat = ragged_kernel.device_flat(host_flat, device)
        x = launch["x"].to(device)
        call = (launch["seed"], launch["steps"], launch["walk_depth"], caps)
        got_x, got_found = ragged_kernel.run_round_ragged_kernel(flat, x,
                                                                 *call)
        ms = None
        if device.type == "cuda" and launch is largest:
            ms = _time_ms(lambda: ragged_kernel.run_round_ragged_kernel(
                flat, x, *call), repeats=5)
        pending.append(dict(
            leg=leg, window=f"{leg}-{index}", launch=launch, flat=host_flat,
            ms=ms, got=(got_x.cpu().numpy(), got_found.cpu().numpy()),
            future=plain_runs[key]))
    ragged_kernel.launches = launches


def _collect_inputs_holds(pending) -> dict:
    """Every submitted hold waited for and compared bit for bit (raises
    otherwise), one record each; returns the largest error and the largest
    launch's times and bound."""
    import numpy as np

    from mythril_tpu_torch.gpu import ragged_kernel

    err, largest = 0, {}
    for hold in pending:
        (want_x, want_found), plain_ms = hold["future"].result()
        got_x, got_found = hold["got"]
        if not (np.array_equal(got_x, want_x)
                and np.array_equal(got_found, want_found)):
            raise AssertionError(
                f"inputs: {hold['window']}: K1 disagrees with its plain "
                f"version: {int((got_x != want_x).sum())} x cells, "
                f"{int((got_found != want_found).sum())} found cells")
        launch_err = max(int(np.abs(got_x.astype(np.int64) - want_x).max()),
                         int(np.abs(got_found.astype(np.int64)
                                    - want_found).max()))
        err = max(err, launch_err)
        launch, flat = hold["launch"], hold["flat"]
        lanes = launch["x"].shape[0]
        bound_ms, bound_by, moved, ops = _bound(
            flat, launch["stream"].v1, lanes, launch["steps"],
            ragged_kernel.KernelCaps(*launch["caps"]))
        record = {"phase": "inputs", "window": hold["window"],
                  **_stream_fields(launch["stream"], flat), "lanes": lanes,
                  "steps": launch["steps"],
                  "walk_depth": launch["walk_depth"], "leg": hold["leg"],
                  "bit_identical": True, "max_abs_err": launch_err,
                  "ms": (hold["ms"] if hold["ms"] is not None
                         else "not measured"),
                  "plain_ms": plain_ms, "plain_on": "host",
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "bytes": moved, "ops": ops}
        emit(record)
        if launch["size"] > largest.get("size", -1):
            largest = {"leg": hold["leg"], "size": launch["size"],
                       "ms": hold["ms"], "plain_ms": plain_ms,
                       "plain_on": "host", "bound_ms": bound_ms,
                       "bound_by": bound_by}
    return {"max_abs_err": err, "largest": largest}


def phase_inputs(device):
    """The inputs of item 12 on both backends, in this process, through
    the CLI: (a) `analyze -a` of GUARDED_KILLBILLY at -t 2 over a pinned
    chain on 127.0.0.1 (ethereum/interface/local.py), findings equal at
    issue granularity and non-empty, K1 solve rounds past the calibration
    and K6 launched, the chain's requests counted (eth_getCode and
    eth_getStorageAt must reach it); (b) `read-storage` in its position,
    range, array and mapping forms, each line the pinned table's value at
    the slot math's slot; (c) `safe-functions` of KILLBILLY's runtime
    code at -t 2, the device's list the host's (kill() flagged: no
    function safe); (d) `concolic` of CONCOLIC_EASM run with 7, flipping its
    JUMPI: the device's JSON the host's, the flipped input 42 (its K1
    launches printed; 0 when every window settles before the router).
    Every K1 launch of (a) and (c), and (d)'s largest, is held bit for
    bit against its plain version, run on the host in INPUTS_HOLD_WORKERS
    spawned processes while the later legs go on (the plain round's small
    per-level ops take 0.16-10 s a launch on the card, 190 s for the
    phase's launches one after another), one plain run for launches with
    equal inputs; each leg's largest K1 launch is timed on the card."""
    import concurrent.futures
    import multiprocessing

    from mythril_tpu_torch.disasm.asm import easm_to_code

    for key in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        os.environ.pop(key, None)  # the chain is on this host
    folder = os.path.join(OUT_DIR, "inputs")
    os.makedirs(folder, exist_ok=True)
    runtime = easm_to_code(GUARDED_KILLBILLY_EASM)
    storage = _inputs_storage()
    launches = {"k1": {}, "k6": {}}
    pending = []
    plain_runs = {}
    began = time.monotonic()
    pool = concurrent.futures.ProcessPoolExecutor(
        INPUTS_HOLD_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        warm = [pool.submit(_warm_hold_worker)
                for _ in range(INPUTS_HOLD_WORKERS)]
        held = _inputs_legs(device, folder, runtime, storage, launches,
                            pool, pending, plain_runs)
        for future in warm:
            future.result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    record = {"phase": "inputs", "leg": "total",
              "seconds": time.monotonic() - began,
              "k1_launches": launches["k1"], "k6_launches": launches["k6"],
              "k1_held": len(pending), "k1_plain_runs": len(plain_runs),
              **held}
    emit(record)
    return {"launches": launches, "max_abs_err": held["max_abs_err"],
            "largest": held["largest"]}


def _inputs_legs(device, folder, runtime, storage, launches, pool,
                 pending, plain_runs):
    """The four legs of phase_inputs; returns _collect_inputs_holds'."""
    from mythril_tpu_torch.disasm.asm import easm_to_code
    from mythril_tpu_torch.disasm.disassembly import Disassembly
    from mythril_tpu_torch.ethereum.interface.local import LocalChain

    with LocalChain({INPUTS_ADDRESS: {"code": "0x" + runtime.hex(),
                                      "storage": storage,
                                      "balance": 10 ** 18}}) as chain:
        rpc = ["--rpc", f"127.0.0.1:{chain.port}"]
        # (a) analyze -a
        argv = ["analyze", "-a", INPUTS_ADDRESS, *rpc, "-t", "2", "-o",
                "json", "--execution-timeout", str(ANALYZE_TIMEOUT)]
        host = _cli_run(device, argv, "cpu")
        requests_host = dict(chain.requests)
        chain.requests.clear()
        every = []
        run = _inputs_device_leg(device, "analyze_a", argv, every)
        requests = dict(chain.requests)
        findings = _json_issue_keys(run["stdout"])
        solve_k1 = run["k1"] - run["k1_calibration"]
        emit({"phase": "inputs", "leg": "analyze_a", "rc": run["rc"],
              "host_rc": host["rc"], "host_wall_s": host["wall_s"],
              "device_wall_s": run["wall_s"], "k1_launches": run["k1"],
              "k1_calibration_launches": run["k1_calibration"],
              "k6_launches": run["k6"], "k1_kept": len(every),
              "rpc_requests": requests, "rpc_requests_host": requests_host,
              "findings": findings,
              "host_findings": _json_issue_keys(host["stdout"])})
        if run["rc"] != 1 or host["rc"] != 1:
            raise AssertionError(f"inputs: analyze -a exited {run['rc']} "
                                 f"(host {host['rc']}), not 1")
        if not findings or findings != _json_issue_keys(host["stdout"]):
            raise AssertionError("inputs: analyze -a findings differ from "
                                 "the host backend's, or are empty")
        if solve_k1 <= 0 or run["k6"] <= 0:
            raise AssertionError(f"inputs: analyze -a: K1 {solve_k1} solve "
                                 f"rounds, K6 {run['k6']} launches")
        if not (requests.get("eth_getCode") and
                requests.get("eth_getStorageAt")):
            raise AssertionError(f"inputs: the chain saw {requests}")
        _submit_inputs_holds(device, "analyze_a", every, pool, pending,
                             plain_runs=plain_runs)
        launches["k1"]["analyze_a"] = run["k1"]
        launches["k6"]["analyze_a"] = run["k6"]
        # (b) read-storage
        for form in READ_STORAGE_FORMS:
            out = _cli_run(device, ["read-storage", form, INPUTS_ADDRESS,
                                    *rpc])
            want = _expected_storage_lines(form, storage)
            emit({"phase": "inputs", "leg": "read_storage", "form": form,
                  "rc": out["rc"], "lines": out["stdout"].splitlines(),
                  "equal": out["stdout"] == want + "\n"})
            if out["rc"] != 0 or out["stdout"] != want + "\n":
                raise AssertionError(f"inputs: read-storage {form} printed "
                                     f"{out['stdout']!r}, not {want!r}")
    # (c) safe-functions of KILLBILLY (runtime code: the selectors are
    # read there)
    argv = ["safe-functions", "-c", easm_to_code(KILLBILLY_EASM).hex(),
            "--bin-runtime", "-t", "2", "--execution-timeout",
            str(ANALYZE_TIMEOUT)]
    host = _cli_run(device, argv, "cpu")
    every = []
    run = _inputs_device_leg(device, "safe_functions", argv, every)
    emit({"phase": "inputs", "leg": "safe_functions", "rc": run["rc"],
          "host_wall_s": host["wall_s"], "device_wall_s": run["wall_s"],
          "k1_launches": run["k1"],
          "k1_calibration_launches": run["k1_calibration"],
          "k6_launches": run["k6"], "k1_kept": len(every),
          "safe": run["stdout"].splitlines(),
          "host_safe": host["stdout"].splitlines()})
    if run["rc"] != 0 or host["rc"] != 0 or run["stdout"] != host["stdout"]:
        raise AssertionError("inputs: safe-functions on the device differs "
                             "from the host's")
    if run["stdout"] != "0 functions are deemed safe in this contract:\n":
        raise AssertionError(f"inputs: safe-functions printed "
                             f"{run['stdout']!r}")
    _submit_inputs_holds(device, "safe_functions", every, pool, pending,
                         plain_runs=plain_runs)
    launches["k1"]["safe_functions"] = run["k1"]
    launches["k6"]["safe_functions"] = run["k6"]
    # (d) concolic
    code = easm_to_code(CONCOLIC_EASM)
    jumpi = next(instr.address for instr in
                 Disassembly(code).instruction_list
                 if instr.opcode == "JUMPI")
    path = os.path.join(folder, "concolic.json")
    with open(path, "w") as handle:
        json.dump({"initialState": {"accounts": {INPUTS_ADDRESS: {
            "code": "0x" + code.hex(), "nonce": 0, "balance": "0x0",
            "storage": {}}}},
            "steps": [{"address": INPUTS_ADDRESS, "origin": "0x" + "ab" * 20,
                       "input": "0x" + (7).to_bytes(32, "big").hex(),
                       "value": "0x0"}]}, handle)
    argv = ["concolic", path, "--branches", str(jumpi)]
    host = _cli_run(device, argv, "cpu")
    every = []
    run = _inputs_device_leg(device, "concolic", argv, every)
    output = json.loads(run["stdout"])
    emit({"phase": "inputs", "leg": "concolic", "rc": run["rc"],
          "host_wall_s": host["wall_s"], "device_wall_s": run["wall_s"],
          "k1_launches": run["k1"],
          "k1_calibration_launches": run["k1_calibration"],
          "k1_kept": len(every), "output": output,
          "equal": run["stdout"] == host["stdout"]})
    if run["rc"] != 0 or run["stdout"] != host["stdout"]:
        raise AssertionError("inputs: concolic on the device differs from "
                             "the host's")
    flipped = output[0]["steps"][-1]["input"] if output[0] else None
    if flipped is None or int(flipped[2:66], 16) != 42:
        raise AssertionError(f"inputs: concolic flipped to {flipped}")
    _submit_inputs_holds(device, "concolic", every, pool, pending,
                         largest_only=True, plain_runs=plain_runs)
    launches["k1"]["concolic"] = run["k1"]
    return _collect_inputs_holds(pending)


def inputs_only(device) -> int:
    """Env, build and the inputs phase."""
    phase_build()
    phase_inputs(device)
    return 0


FORK_PREP_CONTRACTS = ("xc_dispatch_a.hex", "xc_dispatch_b.hex")


@contextlib.contextmanager
def _forcing_not_deferred(on):
    """With `on`, fork-pair members prepare under the normal (forced)
    aig_opt sweep, like every other query."""
    from mythril_tpu_torch.preanalysis import aig_opt

    saved = aig_opt.deferred_forcing
    if on:
        aig_opt.deferred_forcing = contextlib.nullcontext
    try:
        yield
    finally:
        aig_opt.deferred_forcing = saved


def phase_fork_prep(device):
    """Where the device backend's prepare goes with the frontier on (run
    with --fork-prep; see the module note): each contract once a leg, the
    cnf_prep and aig_opt spans split into the fork-pair members' (prepared
    under the deferred-forcing sweep) and the others'."""
    legs = (("host", "cpu", {}, False),
            ("device", "gpu", {}, False),
            ("device, no frontier fork", "gpu", {"no_frontier_fork": True},
             False),
            ("device, forcing not deferred", "gpu", {}, True),
            ("device, frontier off", "gpu", {"no_vmap_frontier": True},
             False))
    for name in FORK_PREP_CONTRACTS:
        with open(os.path.join("bench_inputs", "corpus", name)) as handle:
            code = handle.read().strip()
        for leg, solver_backend, engine, not_deferred in legs:
            with _forcing_not_deferred(not_deferred):
                report, done, record = _analyze_once(
                    device, code, 1, ANALYZE_TIMEOUT, solver_backend, {},
                    engine=engine)
            emit({"phase": "fork-prep", "contract": name, "leg": leg,
                  "completed": done, "wall_s": record["wall_s"],
                  "prepare_s": record["prepare_s"],
                  "solver_s": record["solver_s"],
                  "cnf_prep_split": record["cnf_prep_split"],
                  "aig_opt_split": record["aig_opt_split"],
                  "frontier_fork": record["spans"].get("frontier.fork"),
                  "frontier_forks": record["frontier"]["frontier_forks"],
                  "kernel_launches": record["kernel_launches"],
                  "k6_launches": record["k6_launches"],
                  "device_batch_queries": record["device_batch_queries"],
                  "device_batch_hits": record["device_batch_hits"],
                  "findings": len(report.issues)})


BUCKETED_RUNS = 100  # random batches K3 is held against its plain version
BUCKETED_GLOBAL_RUNS = 2  # of them with x past shared memory
BUCKETED_CONTRACTS = ("killbilly", "xc_dispatch_a.hex")


def _timed_once(device, fn):
    """(fn's result, its ms): CUDA events on the card, the host clock on
    the CPU."""
    import torch

    if device.type != "cuda":
        start = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, begin.elapsed_time(end)


def _compare_k3(device, tensors, x, seed, steps, walk_depth, walks=None):
    """K3 against its plain version on one launch's inputs: (max abs
    error, the plain run's ms). Raises unless bit for bit. `walks`, a
    list, gets the plain run's walk lengths (run_round_circuit_plain)."""
    import torch

    from mythril_tpu_torch.gpu import circuit_kernel

    got_x, got_found = circuit_kernel.run_round_circuit_kernel(
        tensors, x, seed, steps, walk_depth)
    extra = {} if walks is None else {"walks": walks}
    (want_x, want_found), plain_ms = _timed_once(
        device, lambda: circuit_kernel.run_round_circuit_plain(
            tensors, x, seed, steps, walk_depth, **extra))
    torch_sync(device)
    if not (torch.equal(got_x, want_x) and torch.equal(got_found,
                                                        want_found)):
        raise AssertionError(
            f"K3 disagrees with its plain version: "
            f"{int((got_x != want_x).sum())} x cells, "
            f"{int((got_found != want_found).sum())} found cells")
    return max(int((got_x - want_x).abs().max()),
               int((got_found.int() - want_found.int()).abs().max())), \
        plain_ms


def _k3_bound(tensors, x, steps, walk_depth):
    """Least time for one K3 round: the five level entries of each real
    gate (out_idx > 0: the cells the operations count; the bucket's
    padding is never needed), the per-variable and root tables of every
    query slot read once, x in and out, found out,
    over the HBM rate; against the 32-bit logic of the real gates and the
    root checks of every step and the final check over the CUDA-core rate
    (the walks, whose length depends on the data, are not counted: a
    lower bound). Returns (ms, by, bytes, ops, serial chain): the chain
    is the barrier phases a lane's steps run one after another, steps x
    (levels + walk depth) plus the final simulate, levels being those
    with a real gate."""
    from mythril_tpu_torch.gpu import circuit_kernel

    lanes = x.shape[1]
    gates = int((tensors["out_idx"] > 0).sum())
    rows = circuit_kernel.level_rows(tensors)
    moved = _k3_table_bytes(tensors) + _k3_lane_bytes(x)
    live_roots = int((tensors["root_mask"] == 1).sum())
    ops = lanes * (steps + 1) * (3 * gates + 2 * live_roots)
    byte_s, op_s = moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    levels = int((rows.amax(dim=0) > 0).sum())
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations", moved, ops,
            steps * (levels + walk_depth) + levels)


def _k3_table_bytes(tensors):
    """The tables a K3 round must read: the five level entries of each
    real gate and the per-variable and root tables of every query slot."""
    from mythril_tpu_torch.gpu import circuit_kernel

    gates = int((tensors["out_idx"] > 0).sum())
    return gates * 4 * len(circuit_kernel.LEVEL_KEYS) + sum(
        tensors[key].numel() * 4
        for key in circuit_kernel.VAR_KEYS + circuit_kernel.ROOT_KEYS)


def _k3_lane_bytes(x):
    """x [Q, R, V1] int32 in and out, found [Q, R] bool out."""
    q_count, lanes, v1 = x.shape
    return q_count * lanes * v1 * 4 * 2 + q_count * lanes


@contextlib.contextmanager
def _keep_largest_k3(largest):
    """Keep the largest K3 launch (query slots x lanes x levels x width)
    inside the block: largest gets "size", "tensors", a copy of the
    launch's "x", its "seed", "steps" and "walk_depth"."""
    from mythril_tpu_torch.gpu import circuit_kernel

    real = circuit_kernel.run_round_circuit_kernel

    def keep(tensors, x, seed, steps, walk_depth, *side, **side_kw):
        size = x.shape[0] * x.shape[1] * tensors["out_idx"][0].numel()
        if size > largest.get("size", -1):
            largest.update(size=size, tensors=tensors, x=x.clone(),
                           seed=seed, steps=steps, walk_depth=walk_depth)
        return real(tensors, x, seed, steps, walk_depth, *side, **side_kw)

    circuit_kernel.run_round_circuit_kernel = keep
    try:
        yield largest
    finally:
        circuit_kernel.run_round_circuit_kernel = real


@contextlib.contextmanager
def _k3_calibration_launches(counts):
    """Adds to counts["launches"] the K3 launches the router's calibration
    makes inside the block."""
    from mythril_tpu_torch.gpu import circuit_kernel
    from mythril_tpu_torch.gpu.router import QueryRouter

    measure = QueryRouter._measure_round_latency

    def counted(self, *args, **kwargs):
        before = circuit_kernel.launches
        try:
            return measure(self, *args, **kwargs)
        finally:
            counts["launches"] = (counts.get("launches", 0)
                                  + circuit_kernel.launches - before)

    QueryRouter._measure_round_latency = counted
    try:
        yield counts
    finally:
        QueryRouter._measure_round_latency = measure


@contextlib.contextmanager
def _ragged(on: bool):
    """MYTHRIL_GPU_RAGGED pinned inside the block."""
    saved = os.environ.get("MYTHRIL_GPU_RAGGED")
    os.environ["MYTHRIL_GPU_RAGGED"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MYTHRIL_GPU_RAGGED", None)
        else:
            os.environ["MYTHRIL_GPU_RAGGED"] = saved


def _k3_side_input(tensors):
    """The round's per-batch side input, built once as the backend builds
    it: circuit_layout, or level_rows in a checkout of the port from
    before the layout (which this script may time)."""
    from mythril_tpu_torch.gpu import circuit_kernel

    if hasattr(circuit_kernel, "circuit_layout"):
        return circuit_kernel.circuit_layout(tensors)
    return circuit_kernel.level_rows(tensors)


def _k3_shape(tensors, x) -> dict:
    """The launch's tier, lanes a word and stream mode (launch_shape)."""
    from mythril_tpu_torch.gpu import circuit_kernel

    if not hasattr(circuit_kernel, "circuit_layout"):
        return {}
    layout = circuit_kernel.circuit_layout(tensors)
    shape = circuit_kernel.launch_shape(x.shape[2], layout.stride)
    return {"tier": shape.tier, "lanes_per_word": shape.lanes_per_word,
            "stream_resident": shape.resident,
            "stream_steps": int(layout.stream_steps.max()),
            "smem_bytes": shape.smem_bytes}


def _k3_split(device, batch, repeats=5) -> dict:
    """K3's ms a launch on `batch` under CUDA events at three settings:
    its own steps and walk depth ("full"), steps=0 (one simulate and the
    check) and walk_depth=0 (every simulate and root pick, no walk),
    the side input built once outside the timing. Launches made here
    are not counted."""
    from mythril_tpu_torch.gpu import circuit_kernel

    launches = circuit_kernel.launches
    tensors, x, seed = batch["tensors"], batch["x"], batch["seed"]
    side = _k3_side_input(tensors)
    out = {}
    for name, steps, walk in (("full", batch["steps"], batch["walk_depth"]),
                              ("steps0", 0, batch["walk_depth"]),
                              ("walk0", batch["steps"], 0)):
        out[f"{name}_ms"] = _time_ms(
            lambda: circuit_kernel.run_round_circuit_kernel(
                tensors, x, seed, steps, walk, side), repeats=repeats)
    circuit_kernel.launches = launches
    return out


def _k3_walks(walks, group=32) -> dict:
    """The plain run's walk lengths (gates descended) over the (step,
    lane) pairs that walked: mean and largest, and the mean over (step,
    query, group of `group` lanes) of the group's longest, the length a
    bit-sliced warp's walk runs in lockstep."""
    import torch

    lengths = torch.stack([length for length, _ in walks]).float()
    walked = torch.stack([mask for _, mask in walks])
    if not bool(walked.any()):
        return {"walked": 0, "mean": 0.0, "max": 0, "group_max_mean": 0.0}
    steps, q_count, lanes = lengths.shape
    pad = -lanes % group
    grouped = torch.nn.functional.pad(lengths * walked, (0, pad)).reshape(
        steps, q_count, -1, group)
    any_walk = torch.nn.functional.pad(walked, (0, pad)).reshape(
        steps, q_count, -1, group).any(dim=3)
    return {"walked": int(walked.sum()),
            "mean": float(lengths[walked].mean()),
            "max": int(lengths[walked].max()),
            "group_max_mean": float(grouped.amax(dim=3)[any_walk].mean())}


def _hold_k3(device, batch, window, counts, timed=False):
    """K3 bit for bit against its plain version on a kept launch (its
    plain run timed), K3 itself timed there when `timed`, with its split
    (_k3_split) and the plain run's walk lengths; launches made here are
    not counted. Emits one record."""
    from mythril_tpu_torch.gpu import circuit_kernel

    launches = circuit_kernel.launches
    tensors, x = batch["tensors"], batch["x"]
    args = (batch["seed"], batch["steps"], batch["walk_depth"])
    walks = [] if timed else None
    err, plain_ms = _compare_k3(device, tensors, x, *args, walks=walks)
    circuit_kernel.launches = launches
    timing = {"ms": None}
    if timed:
        split = _k3_split(device, batch)
        timing = {"ms": split["full_ms"], "split": split,
                  "walks": _k3_walks(walks)}
    bound_ms, bound_by, moved, ops, chain = _k3_bound(
        tensors, x, batch["steps"], batch["walk_depth"])
    q_count, lanes, v1 = x.shape
    levels, width = tensors["out_idx"].shape[1:]
    emit({"phase": "bucketed", "window": window, "queries": q_count,
          "lanes": lanes, "levels": levels, "width": width, "v1": v1,
          "steps": batch["steps"], "walk_depth": batch["walk_depth"],
          **_k3_shape(tensors, x), **counts, "bit_identical": True,
          "max_abs_err": err, **timing, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
          "ops": ops, "serial_chain_phases": chain})
    return {"max_abs_err": err, **timing, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "serial_chain_phases": chain}


def _k3_random_holds(device):
    """K3 against its plain version on BUCKETED_RUNS seeded random batches
    of 1-16 queries (support/workloads.circuit_batch: padding slots,
    1-4 roots, spare variables), BUCKETED_GLOBAL_RUNS of them with x past
    shared memory (the global tier), and the graft entry's batch."""
    import torch

    from mythril_tpu_torch import graft
    from mythril_tpu_torch.gpu import circuit_kernel
    from mythril_tpu_torch.support.workloads import circuit_batch

    launches = circuit_kernel.launches
    err, start = 0, time.monotonic()
    tiers = {}
    for run in range(BUCKETED_RUNS):
        rng = random.Random(SEED + 100 + run)
        wide = run < BUCKETED_GLOBAL_RUNS
        batch = circuit_batch(rng, max_queries=4 if wide else 16,
                              min_v1=GLOBAL_TIER_V1 + 16 if wide else 0)
        tensors = circuit_kernel.device_batch(batch, device)
        q_count, levels = batch["out_idx"].shape[:2]
        lanes = rng.randint(1, 16)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + run)
        x = torch.randint(0, 2, (q_count, lanes, batch["ga_var"].shape[1]),
                          generator=gen, device=device, dtype=torch.int32)
        walk = rng.choice((levels + 4, rng.randint(0, levels + 4)))
        err = max(err, _compare_k3(device, tensors, x, rng.getrandbits(31),
                                   rng.randint(0, 12), walk)[0])
        tier = _k3_shape(tensors, x).get("tier", "?")
        tiers[tier] = tiers.get(tier, 0) + 1
    fn, args = graft.entry(None if device.type == "cuda" else device)
    err = max(err, _compare_k3(device, args[0], args[1], args[2],
                               graft.STEPS_PER_ROUND,
                               int(args[0]["out_idx"].shape[1]) + 4)[0])
    fn(*args)  # the entry's own step runs too
    circuit_kernel.launches = launches
    emit({"phase": "bucketed", "window": "random-batches",
          "batches": BUCKETED_RUNS, "tiers": tiers, "graft_entry": True,
          "bit_identical": True, "max_abs_err": err,
          "seconds": time.monotonic() - start})
    return err


# K3's layout tiers on deep synthetic batches (support/workloads.deep_batch:
# three cones and a padding slot): (name, deep_cone arguments, least V1,
# the tier launch_shape must pick, its lanes a word, every lane count?)
K3_TIER_CASES = (
    ("shared32", {"gates": 6000, "reach": 128}, 0, "shared32", 32, False),
    ("shared32-ring", {"gates": 20000, "reach": 12}, 0, "shared32", 32,
     True),
    ("shared16", {"gates": 40000, "reach": 48}, 0, "shared16", 16, True),
    ("xshared32", {"gates": 12000, "reach": 32}, 40000, "xshared", 32, True),
    ("xshared16", {"gates": 12000, "reach": 32}, 80000, "xshared", 16,
     False),
    ("xshared8", {"gates": 12000, "reach": 32}, 150000, "xshared", 8, False),
    ("global", {"gates": 12000, "reach": 32}, 213000, "global", 32, True),
)
K3_TIER_LANES = (64, 1, 33)
K3_TIER_STEPS = 6
GLOBAL_TIER_V1 = 196608  # past it x leaves shared memory (launch_shape)


def _k3_tier_holds(device):
    """K3 bit for bit against its plain version on a deep synthetic batch
    of each layout tier, at every lane count of K3_TIER_LANES (64 alone for
    the variants), K3_TIER_STEPS steps and the full walk depth. Returns the
    largest error."""
    import torch

    from mythril_tpu_torch.gpu import circuit_kernel
    from mythril_tpu_torch.support.workloads import deep_batch

    launches = circuit_kernel.launches
    err, start, cases = 0, time.monotonic(), []
    for index, (name, cone, min_v1, tier, width, all_lanes) in enumerate(
            K3_TIER_CASES):
        batch = deep_batch(random.Random(SEED + index), min_v1=min_v1,
                           **cone)
        tensors = circuit_kernel.device_batch(batch, device)
        q_count, levels = batch["out_idx"].shape[:2]
        v1 = batch["ga_var"].shape[1]
        for lanes in K3_TIER_LANES if all_lanes else K3_TIER_LANES[:1]:
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED + lanes)
            x = torch.randint(0, 2, (q_count, lanes, v1), generator=gen,
                              device=device, dtype=torch.int32)
            shape = _k3_shape(tensors, x)
            if (shape["tier"], shape["lanes_per_word"]) != (tier, width):
                raise AssertionError(f"K3 tier case {name}: launch_shape "
                                     f"gave {shape}")
            case_err, plain_ms = _compare_k3(device, tensors, x, SEED + index,
                                             K3_TIER_STEPS, levels + 4)
            err = max(err, case_err)
            cases.append({"case": name, "lanes": lanes, "v1": v1,
                          "levels": levels, **shape, "max_abs_err": case_err,
                          "plain_ms": plain_ms})
    circuit_kernel.launches = launches
    emit({"phase": "bucketed", "window": "tiers", "steps": K3_TIER_STEPS,
          "cases": cases, "bit_identical": True, "max_abs_err": err,
          "seconds": time.monotonic() - start})
    return err


def _bucketed_sibling(device):
    """The sibling window through get_models_batch on the bucketed path:
    verdicts equal to the host CDCL's, every model checked; K3 held on
    the largest batch it launched. Returns (launches, max abs error)."""
    import mythril_tpu_torch.smt as smt
    from mythril_tpu_torch.gpu import circuit_kernel
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
    from mythril_tpu_torch.support.args import args
    from mythril_tpu_torch.support.model import clear_caches, get_models_batch
    from mythril_tpu_torch.support.workloads import sibling_window

    queries = sibling_window(smt, WINDOW, seed=SEED)
    clear_caches()
    frontend._global_blaster = None
    host = _host_verdicts(device, queries)
    clear_caches()
    frontend._global_blaster = None
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    largest, calibration = {}, {}
    args.reset()
    args.solver_backend = "gpu"
    args.torch_device = None if device.type == "cuda" else device
    circuit_kernel.reset_launches()  # the window's count starts here
    start = time.monotonic()
    try:
        # a window of its own: no analysis's execution budget applies
        with _ragged(False), _keep_largest_k3(largest), \
                _k3_calibration_launches(calibration):
            results = get_models_batch(queries,
                                       enforce_execution_time=False)
        torch_sync(device)
    finally:
        args.reset()
    wall = time.monotonic() - start
    launches = circuit_kernel.launches  # ... and ends here
    verdicts = [status for status, _model in results]
    if verdicts != host:
        raise AssertionError(f"bucketed sibling window: verdicts {verdicts} "
                             f"differ from the host CDCL's {host}")
    for (status, model), constraints in zip(results, queries):
        if status == "sat" and not model.satisfies(constraints):
            raise AssertionError("bucketed sibling window: a model fails "
                                 "its constraints")
    if launches <= calibration.get("launches", 0) or not largest:
        raise AssertionError("bucketed sibling window: K3 ran no round")
    counters = stats.as_dict()
    emit({"phase": "bucketed", "window": "sibling", "queries": len(queries),
          "wall_s": wall, "k3_launches": launches,
          "k3_calibration_launches": calibration.get("launches", 0),
          "sat": verdicts.count("sat"),
          **{key: counters[key] for key in (
              "device_batch_queries", "device_batch_hits",
              "device_dispatches", "device_dispatched_queries",
              "device_slots", "router_host_direct", "cap_rejects",
              "router_slot_overflow", "aig_device_components",
              "aig_device_component_hits")}})
    held = _hold_k3(device, largest, "sibling-largest-bucket",
                    {"k3_launches": launches})
    return launches, held["max_abs_err"]


def phase_bucketed(device, ragged_records=None):
    """The bucketed path (--no-ragged) with K3 (see the module note).
    `ragged_records` ({contract: {leg: record}}) are the analyze phase's
    host and ragged device runs; without them the phase runs them itself.
    Returns K3's launches on the analyze runs, its comparisons and times
    on their largest batch."""
    from mythril_tpu_torch.gpu import circuit_kernel, ragged_kernel
    from mythril_tpu_torch.gpu import router as router_mod

    err = max(_k3_random_holds(device), _k3_tier_holds(device))
    sibling_launches, sibling_err = _bucketed_sibling(device)
    err = max(err, sibling_err)
    inputs = {name: (code, tx, timeout)
              for name, code, tx, timeout, _c in _analyze_inputs()
              if name in BUCKETED_CONTRACTS}
    total, largest_all = 0, {}
    for name in BUCKETED_CONTRACTS:
        code, tx_count, timeout = inputs[name]
        legs = dict((ragged_records or {}).get(name, {}))
        for leg, solver_backend in (("cpu", "cpu"), ("gpu", "gpu")):
            if leg not in legs:
                legs[leg] = _analyze_once(device, code, tx_count, timeout,
                                          solver_backend, {})[2]
        largest, calibration = {}, {}
        k1_before = ragged_kernel.launches
        circuit_kernel.reset_launches()  # this run's count starts here
        with _keep_largest_k3(largest), \
                _k3_calibration_launches(calibration):
            _report, done, record = _analyze_once(
                device, code, tx_count, timeout, "gpu", {},
                engine={"no_ragged": True})
        launches = circuit_kernel.launches  # ... and ends here
        # the roofline's ceilings of the run: K3's rate and the ship rate
        # its calibration measured, beside the stage rates
        with _ragged(False):
            ceilings = router_mod._router.attainable_rates()
        total += launches
        row = {}
        for leg, rec in (("host", legs["cpu"]), ("ragged", legs["gpu"]),
                         ("bucketed", record)):
            row[leg] = {
                "wall_s": rec["wall_s"], "completed": rec["completed"],
                "prepare_s": rec["prepare_s"],
                "cnf_prep_s": rec["spans"].get("solver.cnf_prep",
                                               [0, 0.0])[1],
                "get_model_s": rec["spans"].get("solver.get_model",
                                                [0, 0.0])[1],
                "device_batch_queries": rec["device_batch_queries"],
                "device_batch_hits": rec["device_batch_hits"],
                "cnf_prep_split": rec["cnf_prep_split"],
                "findings": len(rec["findings"])}
        emit({"phase": "bucketed", "contract": name, "tx": tx_count,
              "k3_launches": launches,
              "k3_calibration_launches": calibration.get("launches", 0),
              "k1_launches": ragged_kernel.launches - k1_before,
              "router": record["router"], "cap_rejects":
                  record["cap_rejects"], "router_host_direct":
                  record["router_host_direct"], "ceilings": ceilings,
              **row})
        if not done:
            raise AssertionError(f"bucketed: {name} did not complete")
        if record["findings"] != legs["cpu"]["findings"]:
            raise AssertionError(
                f"bucketed: {name}: findings {record['findings']} differ "
                f"from the host backend's {legs['cpu']['findings']}")
        if launches <= calibration.get("launches", 0) or not largest:
            raise AssertionError(f"bucketed: {name}: K3 ran no round")
        if ragged_kernel.launches != k1_before:
            raise AssertionError(f"bucketed: {name}: K1 launched")
        err = max(err, _hold_k3(device, largest, f"{name}-largest",
                                {"contract": name,
                                 "k3_launches": launches})["max_abs_err"])
        if largest["size"] > largest_all.get("size", -1):
            largest_all = largest
    timed = _hold_k3(device, largest_all, "analyze-largest-timed",
                     {"k3_launches": total}, timed=True)
    return {**timed, "launches": total, "max_abs_err": err,
            "sibling_launches": sibling_launches}


def bucketed_only(device) -> int:
    """Env, build and the bucketed phase alone (see the module note)."""
    phase_build()
    phase_bucketed(device)
    return 0


def k3_split(device, path) -> int:
    """K3's split (_k3_split) on the largest batch of the bucketed analyze
    runs, kept in `path` (a torch.save file): read from it when it exists,
    else captured from the two runs (device backend alone) and written
    there. It calls only the round's interface, so a copy of this script
    placed in a checkout of an earlier version of the port times that
    version's K3 on the same batch. Where the plain version counts walks,
    it is held bit for bit and its walk lengths printed."""
    import inspect

    import torch

    from mythril_tpu_torch.gpu import circuit_kernel

    phase_build()
    if os.path.exists(path):
        saved = torch.load(path)
        batch = {**saved, "tensors": {key: value.to(device) for key, value
                                      in saved["tensors"].items()},
                 "x": saved["x"].to(device)}
    else:
        inputs = {name: (code, tx, timeout)
                  for name, code, tx, timeout, _c in _analyze_inputs()
                  if name in BUCKETED_CONTRACTS}
        batch = {}
        for name in BUCKETED_CONTRACTS:
            code, tx_count, timeout = inputs[name]
            largest = {}
            with _keep_largest_k3(largest):
                _analyze_once(device, code, tx_count, timeout, "gpu", {},
                              engine={"no_ragged": True})
            if largest.get("size", -1) > batch.get("size", -1):
                batch = largest
        torch.save({**batch, "tensors": {key: value.cpu() for key, value
                                         in batch["tensors"].items()},
                    "x": batch["x"].cpu()}, path)
    record = {"phase": "k3-split", "batch": path,
              "shape": list(batch["x"].shape),
              "levels": int(batch["tensors"]["out_idx"].shape[1]),
              "width": int(batch["tensors"]["out_idx"].shape[2]),
              "steps": batch["steps"], "walk_depth": batch["walk_depth"],
              **_k3_shape(batch["tensors"], batch["x"]),
              **_k3_split(device, batch)}
    if "walks" in inspect.signature(
            circuit_kernel.run_round_circuit_plain).parameters:
        walks = []
        record["max_abs_err"], record["plain_ms"] = _compare_k3(
            device, batch["tensors"], batch["x"], batch["seed"],
            batch["steps"], batch["walk_depth"], walks=walks)
        record["walks"] = _k3_walks(walks)
    emit(record)
    return 0


# -- the xla kernel mode: K2 -------------------------------------------------

XLA_RUNS = 100  # random streams K2 is held against its plain version
XLA_CONTRACTS = ("killbilly", "xc_dispatch_a.hex")
# the fallback leg: xc_dispatch_a's 37,381-variable cone past K1's
# variable capacity
FALLBACK_CONTRACT = "xc_dispatch_a.hex"
FALLBACK_VAR_CAP = 32768


@contextlib.contextmanager
def _env(**values):
    """Environment variables set inside the block (None: unset); the
    kernel mode's cached resolution dropped on entry and on exit."""
    from mythril_tpu_torch.gpu import ragged_kernel

    saved = {key: os.environ.get(key) for key in values}
    for key, value in values.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    ragged_kernel.reset_kernel_mode()
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        ragged_kernel.reset_kernel_mode()


@contextlib.contextmanager
def _keep_largest_k2(largest, skip=None):
    """Keep the largest K2 launch (lanes x levels x width) inside the
    block: largest gets "size", "xs", the stream's "pages", a copy of the
    launch's "x", its "seed", "steps" and "walk_depth". A launch made
    while `skip()` is true is not kept."""
    from mythril_tpu_torch.gpu import xla_kernel

    real = xla_kernel.run_round_xla_kernel
    upload = xla_kernel.device_stream
    pages = {}

    def uploaded(stream, device, *args):
        xs = upload(stream, device, *args)
        pages[id(xs)] = list(stream.pages)
        return xs

    def keep(xs, x, seed, steps, walk_depth):
        size = x.shape[0] * xs.tensors["out_idx"].numel()
        if size > largest.get("size", -1) and not (skip and skip()):
            largest.update(size=size, xs=xs, pages=pages.get(id(xs)),
                           x=x.clone(), seed=seed, steps=steps,
                           walk_depth=walk_depth)
        return real(xs, x, seed, steps, walk_depth)

    xla_kernel.run_round_xla_kernel = keep
    xla_kernel.device_stream = uploaded
    try:
        yield largest
    finally:
        xla_kernel.run_round_xla_kernel = real
        xla_kernel.device_stream = upload


def _compare_k2(device, xs, x, seed, steps, walk_depth, walks=None):
    """K2 against its plain version on one launch's inputs: (max abs
    error, which must be 0, and the plain run's ms). `walks`, a list,
    gets the plain run's walk lengths (run_round_xla_plain)."""
    import torch

    from mythril_tpu_torch.gpu import xla_kernel

    got_x, got_found = xla_kernel.run_round_xla_kernel(xs, x, seed, steps,
                                                       walk_depth)
    extra = {} if walks is None else {"walks": walks}
    (want_x, want_found), plain_ms = _timed_once(
        device, lambda: xla_kernel.run_round_xla_plain(
            xs, x, seed, steps, walk_depth, **extra))
    torch_sync(device)
    if not (torch.equal(got_x, want_x) and torch.equal(got_found,
                                                        want_found)):
        raise AssertionError(
            f"K2 disagrees with its plain version: "
            f"{int((got_x != want_x).sum())} x cells, "
            f"{int((got_found != want_found).sum())} found cells")
    return max(int((got_x - want_x).abs().max()),
               int((got_found.int() - want_found.int()).abs().max())), \
        plain_ms


def _k2_bound(xs, x, steps):
    """Least time for one K2 round, counted as `_k3_bound` counts K3's:
    the five level entries of each real gate (out_idx > 0; the bucket's
    padding and the columns past a level's last row are never needed),
    the per-variable and root tables and level_rows read once, x in and
    out, found out, over the HBM rate; against the 32-bit logic of the
    real gates and the root checks of every step and the final check over
    the CUDA-core rate (the walks, whose length depends on the data, are
    not counted: a lower bound). Returns (ms, by, bytes, ops)."""
    from mythril_tpu_torch.gpu import xla_kernel

    tensors = xs.tensors
    lanes = x.shape[0]
    cones = tensors["root_var"].shape[0]
    gates = int((tensors["out_idx"] > 0).sum())
    tables = gates * 4 * len(xla_kernel.LEVEL_KEYS) + sum(
        tensors[key].numel() * 4
        for key in xla_kernel.VAR_KEYS + xla_kernel.ROOT_KEYS)
    moved = (tables + xs.level_rows.numel() * 4 + 2 * x.numel() * 4
             + lanes * cones)
    live_roots = int((tensors["root_mask"] == 1).sum())
    ops = lanes * (steps + 1) * (3 * gates + 2 * live_roots)
    byte_s, op_s = moved / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(byte_s, op_s) * 1e3,
            "bytes" if byte_s >= op_s else "operations", moved, ops)


def _k2_chain(xs, steps, walk_depth) -> int:
    """The barrier phases a lane's steps run one after another on K2's
    launch, counted as _k3_bound counts K3's: steps x (levels + walk
    depth) plus the final simulate, levels being those with a real
    gate."""
    levels = int((xs.level_rows > 0).sum())
    return steps * (levels + walk_depth) + levels


def _k2_shape(xs) -> dict:
    """The launch's shape from the stream's layout: the cones of each
    (tier, lanes a word), the longest cone's stream steps and the shared
    memory a block asks for; {} for a K2 without the per-cone layout
    (which this script may time)."""
    from mythril_tpu_torch.gpu import circuit_kernel, xla_kernel

    layout = getattr(xs, "layout", None)
    if layout is None:
        return {}
    field = {name: k for k, name in enumerate(xla_kernel.CONE_FIELDS)}
    tiers = {}
    for row in layout.header:
        key = (f"{circuit_kernel.TIERS[row[field['tier']]]}/"
               f"{row[field['lanes_per_word']]}")
        tiers[key] = tiers.get(key, 0) + 1
    return {"tiers": tiers,
            "stream_steps": int(layout.header[:, field["stream_steps"]]
                                .max()),
            "largest_page_v1": int(layout.header[:, field["v1"]].max()),
            "smem_bytes": layout.smem_bytes}


def _k2_split(device, launch, repeats=5) -> dict:
    """K2's ms a launch under CUDA events at three settings: its own steps
    and walk depth ("full"), steps=0 (one simulate and the check) and
    walk_depth=0 (every simulate and root pick, no walk), the stream
    uploaded once outside the timing. Launches made here are not
    counted."""
    from mythril_tpu_torch.gpu import xla_kernel

    launches = xla_kernel.launches
    xs, x, seed = launch["xs"], launch["x"], launch["seed"]
    out = {}
    for name, steps, walk in (("full", launch["steps"], launch["walk_depth"]),
                              ("steps0", 0, launch["walk_depth"]),
                              ("walk0", launch["steps"], 0)):
        out[f"{name}_ms"] = _time_ms(
            lambda: xla_kernel.run_round_xla_kernel(xs, x, seed, steps,
                                                    walk), repeats=repeats)
    xla_kernel.launches = launches
    return out


def _k2_walks(walks) -> dict:
    """The plain run's walk lengths (gates descended) over the (step, lane,
    cone) triples that walked, as _k3_walks counts them, with the mean
    longest walk of a group of 32 lanes (a warp's walk at 32 lanes a word)
    and of 8."""
    per_cone = [(length.t(), walked.t()) for length, walked in walks]
    if not per_cone:
        return {"walked": 0, "mean": 0.0, "max": 0, "group_max_mean": 0.0}
    out = _k3_walks(per_cone)
    if out["walked"]:
        out["group8_max_mean"] = _k3_walks(per_cone, group=8)[
            "group_max_mean"]
    return out


def _hold_k2(device, launch, window, counts, timed=False):
    """K2 bit for bit against its plain version on one kept launch (its
    plain run timed), and K2 timed there when `timed`, with its split
    (_k2_split) and the plain run's walk lengths; launches made here are
    not counted. Emits one record."""
    from mythril_tpu_torch.gpu import xla_kernel

    before = xla_kernel.launches
    xs, x = launch["xs"], launch["x"]
    args = (launch["seed"], launch["steps"], launch["walk_depth"])
    walks = [] if timed else None
    err, plain_ms = _compare_k2(device, xs, x, *args, walks=walks)
    timing = {"ms": None}
    if timed and device.type == "cuda":
        split = _k2_split(device, launch)
        timing = {"ms": split["full_ms"], "split": split}
    if timed:
        timing["walks"] = _k2_walks(walks)
    xla_kernel.launches = before
    bound_ms, bound_by, moved, ops = _k2_bound(xs, x, args[1])
    chain = _k2_chain(xs, args[1], args[2])
    levels, width = xs.tensors["out_idx"].shape
    cones, roots = xs.tensors["root_var"].shape
    emit({"phase": "xla", "window": window, "lanes": x.shape[0],
          "v1": x.shape[1], "levels": levels, "width": width,
          "live_levels": int((xs.level_rows > 0).sum()),
          "cone_slots": cones, "cones": xs.num_cones, "roots": roots,
          "steps": args[1], "walk_depth": args[2], **_k2_shape(xs),
          **counts, "bit_identical": True, "max_abs_err": err,
          **{**timing, "ms": timing["ms"] if timing["ms"] is not None
             else "not measured"},
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": moved, "ops": ops, "serial_chain_phases": chain})
    return {"max_abs_err": err, **timing, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "serial_chain_phases": chain}


def _k2_launch(device, stream, seed, lanes, steps, walk_depth=None):
    """One kept-launch record of K2 on `stream` from a seeded x."""
    import torch

    from mythril_tpu_torch.gpu import circuit, xla_kernel

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = circuit.init_inputs(gen, lanes, stream.v1, device)
    if walk_depth is None:
        walk_depth = min(stream.num_levels + 4, circuit.MAX_LEVELS)
    return {"xs": xla_kernel.device_stream(stream, device), "x": x,
            "seed": seed, "steps": steps, "walk_depth": walk_depth}


def _k2_random_holds(device):
    """K2 against its plain version on XLA_RUNS seeded random streams of
    1-40 cones (support/workloads.random_cones, a third of them with a
    pinned input) at 1-96 lanes, 0-32 steps and random walk depths.
    Returns (max abs error, K2's launches)."""
    from mythril_tpu_torch.gpu import circuit, xla_kernel
    from mythril_tpu_torch.gpu.backend import shape_bucket
    from mythril_tpu_torch.support.workloads import random_cones

    rng = random.Random(SEED + 2)
    err = 0
    xla_kernel.reset_launches()
    for run in range(XLA_RUNS):
        cones = random_cones(rng, rng.randint(1, 40))
        entries = [(pc, ((1, bool(i % 2)),) if i % 3 and pc.v1 > 1 else ())
                   for i, pc in enumerate(cones)]
        stream = circuit.RaggedStream(entries, bucket=shape_bucket)
        launch = _k2_launch(device, stream, SEED + run, rng.randint(1, 96),
                            rng.randint(0, 32),
                            rng.choice((None, 0, 1, rng.randint(2, 40))))
        err = max(err, _compare_k2(device, launch["xs"], launch["x"],
                                   launch["seed"], launch["steps"],
                                   launch["walk_depth"])[0])
    launches = xla_kernel.launches
    emit({"phase": "xla", "window": "random", "streams": XLA_RUNS,
          "k2_launches": launches, "bit_identical": True,
          "max_abs_err": err})
    return err, launches


def _k2_past_k1_stream():
    """A stream past every K1 capacity: three big cones (one asserting 300
    roots) and 140 small ones, more than 65,536 variables and more than
    128 cones (support/workloads.big_cone, random_cones)."""
    from mythril_tpu_torch.gpu import circuit, ragged_kernel
    from mythril_tpu_torch.gpu.backend import shape_bucket
    from mythril_tpu_torch.support.workloads import big_cone, random_cones

    rng = random.Random(SEED + 3)
    entries = [(big_cone(rng, roots=300), ())]
    entries += [(big_cone(rng), ()) for _ in range(2)]
    entries += [(pc, ()) for pc in random_cones(rng, 140)]
    caps = ragged_kernel.kernel_caps()
    combined = 1 + sum(pc.v1 - 1 for pc, _extra in entries)
    most_roots = max(pc.num_roots for pc, _extra in entries)
    if not (combined > caps.var_cap and len(entries) > caps.cone_cap
            and most_roots > caps.root_cap):
        raise AssertionError(f"xla: the stream ({combined} variables, "
                             f"{len(entries)} cones, {most_roots} roots) "
                             f"is inside K1's capacities {caps}")
    return (circuit.RaggedStream(entries, bucket=shape_bucket),
            {"combined_vars": combined, "most_roots": most_roots,
             "k1_caps": list(caps[:3])})


def phase_xla(device, records=None):
    """The xla kernel mode with K2 and the pallas mode's fallback (see the
    module note). `records` ({contract: {leg: record}}) are the analyze
    phase's host runs; without them the phase runs them itself. Returns
    K2's launches by path, its comparisons and times on the xla runs'
    largest launch."""
    from mythril_tpu_torch.gpu import ragged_kernel, xla_kernel
    from mythril_tpu_torch.gpu.router import QueryRouter

    err, random_launches = _k2_random_holds(device)
    stream, sizes = _k2_past_k1_stream()
    past_k1 = _hold_k2(device, _k2_launch(device, stream, SEED + 4, 64, 16),
                       "past-k1", sizes, timed=True)
    err = max(err, past_k1["max_abs_err"])
    inputs = {name: (code, tx, timeout)
              for name, code, tx, timeout, _c in _analyze_inputs()
              if name in XLA_CONTRACTS}
    host = {}
    for name in XLA_CONTRACTS:
        rec = (records or {}).get(name, {}).get("cpu")
        if rec is None:
            code, tx_count, timeout = inputs[name]
            rec = _analyze_once(device, code, tx_count, timeout, "cpu", {})[2]
        host[name] = rec

    measure = QueryRouter._measure_xla_rate
    calibration = {"launches": 0}

    def counted(self, *args, **kwargs):
        before = xla_kernel.launches
        try:
            return measure(self, *args, **kwargs)
        finally:
            calibration["launches"] += xla_kernel.launches - before

    def run(name, leg, env, largest):
        code, tx_count, timeout = inputs[name]
        k1_before = ragged_kernel.launches
        calibration["launches"] = 0
        xla_kernel.reset_launches()  # this run's count starts here
        QueryRouter._measure_xla_rate = counted
        try:
            with _env(**env), _keep_largest_k2(largest):
                _report, done, record = _analyze_once(
                    device, code, tx_count, timeout, "gpu", {})
        finally:
            QueryRouter._measure_xla_rate = measure
        k2 = xla_kernel.launches  # ... and ends here
        k1 = ragged_kernel.launches - k1_before
        emit({"phase": "xla", "contract": name, "leg": leg, "tx": tx_count,
              "k2_launches": k2,
              "k2_calibration_launches": calibration["launches"],
              "k1_launches": k1, "host_wall_s": host[name]["wall_s"],
              **{key: record[key] for key in (
                  "wall_s", "completed", "prepare_s", "router",
                  "device_batch_queries", "device_batch_hits",
                  "aig_device_components", "aig_device_component_hits",
                  "router_device_found", "router_host_settled",
                  "cap_rejects", "router_host_direct", "findings")}})
        if not done:
            raise AssertionError(f"xla: {name} ({leg}) did not complete")
        if record["findings"] != host[name]["findings"]:
            raise AssertionError(
                f"xla: {name} ({leg}): findings {record['findings']} "
                f"differ from the host backend's {host[name]['findings']}")
        return k1, k2, record

    largest, total, k2_hits = {}, 0, 0
    for name in XLA_CONTRACTS:
        k1, k2, record = run(name, "xla", {"MYTHRIL_GPU_KERNEL": "xla"},
                             largest)
        if k1:
            raise AssertionError(f"xla: {name}: K1 launched {k1} times")
        if k2 <= calibration["launches"]:
            raise AssertionError(f"xla: {name}: K2 ran no solve round")
        total += k2
        k2_hits += record["aig_device_component_hits"]
    if not k2_hits:
        raise AssertionError("xla: K2 solved no component")
    fallback = {}
    k1, fallback_launches, record = run(
        FALLBACK_CONTRACT, "pallas-fallback",
        {"MYTHRIL_GPU_KERNEL": "pallas",
         "MYTHRIL_GPU_RAGGED_VAR_CAP": FALLBACK_VAR_CAP}, fallback)
    if not (k1 and fallback_launches):
        raise AssertionError(f"xla: the fallback leg launched K1 {k1} and "
                             f"K2 {fallback_launches} times")
    fallback_held = _hold_k2(device, fallback, "fallback-largest",
                             {"k2_launches": fallback_launches,
                              "k1_launches": k1,
                              # K1's capacities are launch arguments: the
                              # leg's smaller var_cap needed no rebuild
                              "k1_rebuilt": False}, timed=True)
    err = max(err, fallback_held["max_abs_err"])
    timed = _hold_k2(device, largest, "xla-analyze-largest-timed",
                     {"k2_launches": total}, timed=True)

    def brief(held):
        return {key: held.get(key) for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "split",
            "serial_chain_phases")}

    return {**timed, "launches": total, "max_abs_err": max(
        err, timed["max_abs_err"]), "launches_by_path": {
            "xla_analyze": total, "fallback": fallback_launches,
            "random": random_launches},
        "fallback": brief(fallback_held), "past_k1": brief(past_k1)}


def xla_only(device) -> int:
    """Env, build and the xla phase alone (see the module note)."""
    phase_build()
    phase_xla(device)
    return 0


K2_SPLIT_WIDEST = (16, 8)  # narrower words timed on the fallback launch


def _k2_capture(device) -> dict:
    """The launches --k2-split times, kept as the xla phase keeps them:
    "fallback" (the fallback leg's largest launch: xc_dispatch_a's
    37,381-variable cone), "xla_largest" (the largest launch of the xla
    mode's two analyze runs) and "past_k1" (the stream past every K1
    capacity at 64 lanes and 16 steps), each with the stream's pages."""
    inputs = {name: (code, tx, timeout)
              for name, code, tx, timeout, _c in _analyze_inputs()
              if name in XLA_CONTRACTS}
    fallback, largest = {}, {}
    code, tx_count, timeout = inputs[FALLBACK_CONTRACT]
    with _env(MYTHRIL_GPU_KERNEL="pallas",
              MYTHRIL_GPU_RAGGED_VAR_CAP=FALLBACK_VAR_CAP), \
            _keep_largest_k2(fallback):
        _analyze_once(device, code, tx_count, timeout, "gpu", {})
    for name in XLA_CONTRACTS:
        code, tx_count, timeout = inputs[name]
        with _env(MYTHRIL_GPU_KERNEL="xla"), _keep_largest_k2(largest):
            _analyze_once(device, code, tx_count, timeout, "gpu", {})
    stream, _sizes = _k2_past_k1_stream()
    past = {**_k2_launch(device, stream, SEED + 4, 64, 16),
            "pages": list(stream.pages)}
    out = {}
    for name, launch in (("fallback", fallback), ("xla_largest", largest),
                         ("past_k1", past)):
        out[name] = _k2_kept(launch)
    return out


def k2_split(device, path) -> int:
    """K2's split (_k2_split) on the launches of _k2_capture, kept in
    `path` (a torch.save file): read from it when it exists, else captured
    and written there. It uploads each stream through device_stream and
    calls only the round's interface, so a copy of this script placed in a
    checkout of an earlier version of the port times that version's K2 on
    the same launches. Where device_stream takes a word width, the
    fallback launch is also timed at K2_SPLIT_WIDEST lanes a word; where
    the plain version counts walks, each launch is held bit for bit and
    its walk lengths printed."""
    import inspect

    import torch

    from mythril_tpu_torch.gpu import xla_kernel

    phase_build()
    if os.path.exists(path):
        saved = torch.load(path)
    else:
        saved = _k2_capture(device)
        torch.save(saved, path)
    counts_walks = "walks" in inspect.signature(
        xla_kernel.run_round_xla_plain).parameters
    has_widest = "widest" in inspect.signature(
        xla_kernel.device_stream).parameters
    for name, kept in saved.items():
        stream = SimpleNamespace(
            tensors={key: value.numpy() for key, value
                     in kept["tensors"].items()},
            num_cones=kept["num_cones"], pages=kept["pages"])
        launch = {**kept, "xs": xla_kernel.device_stream(stream, device),
                  "x": kept["x"].to(device)}
        xs, x = launch["xs"], launch["x"]
        bound_ms, bound_by, _moved, _ops = _k2_bound(xs, x, kept["steps"])
        record = {"phase": "k2-split", "launch": name, "file": path,
                  "lanes": x.shape[0], "v1": x.shape[1],
                  "cones": kept["num_cones"],
                  "largest_page": max(size for _b, size in kept["pages"]),
                  "levels": int(kept["tensors"]["out_idx"].shape[0]),
                  "live_levels": int((xs.level_rows > 0).sum()),
                  "steps": kept["steps"], "walk_depth": kept["walk_depth"],
                  **_k2_shape(xs), **_k2_split(device, launch),
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "serial_chain_phases": _k2_chain(xs, kept["steps"],
                                                   kept["walk_depth"])}
        if counts_walks:
            walks = []
            record["max_abs_err"], record["plain_ms"] = _compare_k2(
                device, xs, x, kept["seed"], kept["steps"],
                kept["walk_depth"], walks=walks)
            record["walks"] = _k2_walks(walks)
        if has_widest and name == "fallback":
            record["narrower_words"] = {}
            for widest in K2_SPLIT_WIDEST:
                narrow = {**launch, "xs": xla_kernel.device_stream(
                    stream, device, widest)}
                err, _plain = _compare_k2(device, narrow["xs"], x,
                                          kept["seed"], kept["steps"],
                                          kept["walk_depth"])
                record["narrower_words"][widest] = {
                    **_k2_shape(narrow["xs"]), "max_abs_err": err,
                    **_k2_split(device, narrow)}
        emit(record)
    return 0


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
    with _preanalysis(False):
        phase_timing(device, queries, _host_verdicts(device, queries),
                     with_plain=False)
    return 0


def _timing_fields(record) -> dict:
    return {key: record[key] for key in (
        "rows", "ops", "device_ms", "ms", "wrapper_ms", "plain_ms",
        "host_step_ms", "bound_ms", "bound_by")}


def frontier_only(device) -> int:
    """Env, build and the frontier phase alone (see the module note)."""
    phase_build()
    phase_frontier(device)
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
    start = time.monotonic()
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
        if "--frontier-only" in sys.argv[1:]:
            frontier_only(device)
            print(smi, flush=True)
            return 0
        if "--telemetry-overhead" in sys.argv[1:]:
            phase_build()
            phase_telemetry_overhead(device,
                                     order=("off", "on", "on", "off") * 2,
                                     contracts=OVERHEAD_ONLY_CONTRACTS)
            print(smi, flush=True)
            return 0
        if "--fork-prep" in sys.argv[1:]:
            phase_build()
            phase_fork_prep(device)
            print(smi, flush=True)
            return 0
        if "--resilience-only" in sys.argv[1:]:
            phase_build()
            phase_resilience(device)
            print(smi, flush=True)
            return 0
        if "--bucketed-only" in sys.argv[1:]:
            bucketed_only(device)
            print(smi, flush=True)
            return 0
        if "--xla-only" in sys.argv[1:]:
            xla_only(device)
            print(smi, flush=True)
            return 0
        if "--corpus-only" in sys.argv[1:]:
            corpus_only(device)
            print(smi, flush=True)
            return 0
        if "--serve-only" in sys.argv[1:]:
            serve_only(device)
            print(smi, flush=True)
            return 0
        if "--autotune-only" in sys.argv[1:]:
            autotune_only(device)
            print(smi, flush=True)
            return 0
        if "--mesh-only" in sys.argv[1:]:
            mesh_only(device)
            print(smi, flush=True)
            return 0
        if "--options-only" in sys.argv[1:]:
            options_only(device)
            print(smi, flush=True)
            return 0
        if "--inputs-only" in sys.argv[1:]:
            inputs_only(device)
            print(smi, flush=True)
            return 0
        if "--k3-split" in sys.argv[1:]:
            k3_split(device, sys.argv[sys.argv.index("--k3-split") + 1])
            print(smi, flush=True)
            return 0
        if "--k2-split" in sys.argv[1:]:
            k2_split(device, sys.argv[sys.argv.index("--k2-split") + 1])
            print(smi, flush=True)
            return 0
        seconds = {}

        def timed(name, fn, *args, **kwargs):
            began = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = round(time.monotonic() - began, 3)

        timed("build", phase_build)
        with _preanalysis(False):
            queries, verdicts, slice_launches = timed(
                "slice", phase_slice, device)
            max_err = timed("kernel", phase_kernel, device, queries,
                            verdicts)
            timing = timed("timing", phase_timing, device, queries, verdicts)
        router = timed("router", phase_router, device)
        frontier = timed("frontier", phase_frontier, device)
        analyze = timed("analyze", phase_analyze, device)
        options = timed("options", phase_options, device, OPTION_LEGS_WHOLE)
        inputs = timed("inputs", phase_inputs, device)
        bucketed = timed("bucketed", phase_bucketed, device,
                         analyze["records"])
        mesh = timed("mesh", phase_mesh, device, MESH_SHARDS_WHOLE,
                     deep=False)
        xla = timed("xla", phase_xla, device, analyze["records"])
        timed("telemetry-overhead", phase_telemetry_overhead, device)
        resilience = timed("resilience", phase_resilience, device)
        corpus = timed("corpus", phase_corpus, device, analyze["records"])
        serve = timed("serve", phase_serve, device, analyze["records"])
        autotune = timed("autotune", phase_autotune, device,
                         analyze["records"], AUTOTUNE_SEARCH_WHOLE)
        emit({"phase": "total", "seconds": time.monotonic() - start,
              "by_phase": seconds})
    except Exception as error:
        import traceback

        traceback.print_exc()
        return fail(str(error))
    emit({"kernels": [{
        "name": "ragged_round",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/ragged_round.cu",
        "replaces": "mythril_tpu/tpu/pallas_kernel.py:268",
        # the main path's launches: the analyze phase's five compared
        # contracts on the device backend (stress_dispatch's clock-cut
        # runs are counted apart)
        "launches": analyze["launches"],
        "launches_by_path": {"slice": slice_launches,
                             "router": router["launches"],
                             "router_forks": router["fork_launches"],
                             "analyze": analyze["launches"],
                             "analyze_stress": analyze["stress_launches"],
                             "resilience_host_sites":
                                 resilience["launches"],
                             # the corpus phase: interleaved in this
                             # process (those made dispatching mixed
                             # streams apart), and in the four workers
                             "corpus_interleave":
                                 corpus["interleave_launches"]["ragged_round"],
                             "corpus_interleave_mixed_streams":
                                 corpus["mixed_k1_launches"],
                             "corpus_jobs_workers":
                                 corpus["jobs_k1_launches"],
                             # the serve phase: the daemon's five
                             # requests (those made dispatching mixed
                             # streams apart), the warm repeat, and each
                             # fleet shard's solve rounds
                             "serve_daemon":
                                 serve["launches"]["ragged_round"],
                             "serve_daemon_mixed_streams":
                                 serve["mixed_k1_launches"],
                             "serve_warm_repeat": serve["warm_k1_launches"],
                             "serve_fleet_shards_solve_rounds":
                                 serve["fleet_k1_launches"],
                             # the autotune phase: the search's children
                             # (their solve rounds, from their stats),
                             # and the analyze runs under the profile
                             # with the env's pallas (c) and under a
                             # corrupt profile (d)
                             "autotune_search_children_solve_rounds":
                                 autotune["search_k1_solve_rounds"],
                             "autotune_env_shadows_profile":
                                 autotune["k1_launches"]["env"],
                             "autotune_corrupt_profile":
                                 autotune["k1_launches"]["corrupt"],
                             # the options phase: KILLBILLY -t 2 under
                             # each engine option on the device backend,
                             # and the -j and -g dumps
                             **{f"options_{leg}": count for leg, count
                                in options["launches"]["k1"].items()},
                             "options_statespace_dumps":
                                 options["dump_k1_launches"],
                             # the inputs phase: analyze -a over the
                             # local chain, safe-functions and concolic's
                             # flip pass on the device backend
                             **{f"inputs_{leg}": count for leg, count
                                in inputs["launches"]["k1"].items()}},
        "max_abs_err": max(max_err, router["max_abs_err"],
                           analyze["max_abs_err"],
                           resilience["max_abs_err"],
                           corpus["max_abs_err"], serve["max_abs_err"],
                           autotune["k1_hold"]["max_abs_err"],
                           options["max_abs_err"], inputs["max_abs_err"]),
        # times of one round on the largest stream the compared analyze
        # runs launched; the router's and the slice's streams beside them
        "ms": analyze["ms"],
        "plain_ms": analyze["plain_ms"],
        "bound_ms": analyze["bound_ms"],
        "bound_by": analyze["bound_by"],
        "library_ms": None,
        "router_stream": {"ms": router["ms"],
                          "plain_ms": router["plain_ms"],
                          "bound_ms": router["bound_ms"],
                          "bound_by": router["bound_by"]},
        "slice_stream": {"ms": timing["ms"],
                         "plain_ms": timing["plain_ms"],
                         "bound_ms": timing["bound_ms"],
                         "bound_by": timing["bound_by"]},
        # the largest mixed-origin stream of the interleaved corpus run
        "corpus_mixed_stream": corpus["mixed_stream"],
        # and of the serve daemon's five requests
        "serve_mixed_stream": serve["mixed_stream"],
        # the autotune phase's largest launch under the env's pallas over
        # a profile of 32 steps
        "autotune_env_launch": autotune["k1_hold"],
        # the inputs phase's largest launch (of its three device legs)
        "inputs_largest_launch": inputs["largest"],
    }, {
        "name": "frontier_step",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/frontier_step.cu",
        # an XLA program, not a Pallas kernel: jit(vmap(_exec)), with K7
        # (words.py _divmod_bitserial, :136) inside
        "replaces": "mythril_tpu/laser/frontier/kernel.py:316",
        # the main path's launches: the five compared contracts on the
        # device backend (the host-CDCL runs with K6 and stress_dispatch
        # counted apart)
        "launches": analyze["k6_launches"],
        "launches_by_path": {"analyze": analyze["k6_launches"],
                             "analyze_host_cdcl": analyze["k6_host_launches"],
                             "analyze_stress": analyze["k6_stress"],
                             "corpus_interleave": corpus[
                                 "interleave_launches"]["frontier_step"],
                             "corpus_jobs_workers":
                                 corpus["jobs_k6_launches"],
                             "serve_daemon":
                                 serve["launches"]["frontier_step"],
                             **{f"options_{leg}": count for leg, count
                                in options["launches"]["k6"].items()},
                             **{f"inputs_{leg}": count for leg, count
                                in inputs["launches"]["k6"].items()}},
        "max_abs_err": max(frontier["max_abs_err"],
                           analyze["k6"]["max_abs_err"]),
        # one launch on the largest frontier batch (rows x micro-ops) the
        # compared runs stepped, the kernel alone under CUDA events; its
        # device time from the profiler, its wrapper and the stepper's
        # whole host step beside it, then the 64-row, division and
        # 1-row batches and the device's idle share over one contract's
        # frontier steps
        "ms": analyze["k6"]["ms"],
        "device_ms": analyze["k6"]["device_ms"],
        "plain_ms": analyze["k6"]["plain_ms"],
        "bound_ms": analyze["k6"]["bound_ms"],
        "bound_by": analyze["k6"]["bound_by"],
        "library_ms": None,
        "wrapper_ms": analyze["k6"]["wrapper_ms"],
        "host_step_ms": analyze["k6"]["host_step_ms"],
        "synthetic_64_rows": _timing_fields(frontier),
        "division_64_rows": _timing_fields(frontier["division"]),
        "division_control_64_rows": _timing_fields(frontier["control"]),
        "launch_floor": _timing_fields(frontier["floor"]),
        "analyze_idle": {key: analyze["frontier_idle"].get(key) for key in (
            "contract", "steps", "host_step_ms", "device_idle_share")},
    }, {
        "name": "circuit_round",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/circuit_round.cu",
        # an XLA program, not a Pallas kernel: run_round_circuit, vmapped
        # over queries by run_round_circuit_batch (:507)
        "replaces": "mythril_tpu/tpu/circuit.py:460",
        # the main path's launches: the bucketed phase's analyze runs
        # (--no-ragged), their calibration launches included
        "launches": bucketed["launches"],
        "launches_by_path": {"bucketed_analyze": bucketed["launches"],
                             "bucketed_sibling":
                                 bucketed["sibling_launches"]},
        "max_abs_err": bucketed["max_abs_err"],
        # one round on the largest batch the analyze runs launched; its
        # split (steps=0, walk_depth=0) and the plain run's walk lengths
        "ms": bucketed["ms"],
        "plain_ms": bucketed["plain_ms"],
        "bound_ms": bucketed["bound_ms"],
        "bound_by": bucketed["bound_by"],
        "library_ms": None,
        "serial_chain_phases": bucketed["serial_chain_phases"],
        "split": bucketed["split"],
        "walks": bucketed["walks"],
    }, {
        "name": "xla_round",
        "route": "cuda",
        "source": "mythril_tpu_torch/csrc/xla_round.cu",
        # an XLA program, not a Pallas kernel: run_round_ragged (with
        # _walk_ragged :517 and _simulate :398)
        "replaces": "mythril_tpu/tpu/circuit.py:557",
        # the main path's launches: the xla mode's analyze runs, their
        # calibration launches included; the pallas mode's fallback leg
        # and the random streams' comparisons beside them
        "launches": xla["launches"],
        # beside them the default path's: the five compared contracts and
        # stress_dispatch's clock-cut runs, where a cone past K1's
        # capacities runs on K2
        "launches_by_path": {**xla["launches_by_path"],
                             "analyze": analyze["k2_launches"],
                             "analyze_stress": analyze["k2_stress"],
                             "serve_daemon": serve["launches"]["xla_round"],
                             # the analyze run under the tuned xla profile
                             "autotune_tuned_profile":
                                 autotune["k2_launches"]["tuned"]},
        "max_abs_err": max(xla["max_abs_err"],
                           autotune["k2_hold"]["max_abs_err"]),
        # one round on the largest launch of the xla analyze runs; its
        # split (steps=0, walk_depth=0) and the plain run's walk lengths,
        # then the fallback leg's largest launch and the past-k1 stream
        "ms": xla["ms"],
        "plain_ms": xla["plain_ms"],
        "bound_ms": xla["bound_ms"],
        "bound_by": xla["bound_by"],
        "library_ms": None,
        "serial_chain_phases": xla["serial_chain_phases"],
        "split": xla["split"],
        "walks": xla["walks"],
        "fallback_launch": xla["fallback"],
        "past_k1_stream": xla["past_k1"],
        # the largest launch under the tuned profile (xla, 32 steps)
        "autotune_profile_launch": {key: autotune["k2_hold"].get(key)
                                    for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")},
    }, {
        "name": "sharded_round",
        "route": "cuda",
        # K4: K3's kernel a shard, plus the gather and MAX over mp
        "source": "mythril_tpu_torch/csrc/circuit_round.cu",
        # an XLA program, not a Pallas kernel: shard_map of
        # run_round_circuit_batch with a pmax over "mp"
        "replaces": "mythril_tpu/tpu/circuit.py:631",
        # the main path's launches: the mesh phase's dryrun (leg 1 on a
        # virtual 2 x 2 mesh), the shards' K3 launches
        "launches": mesh["launches"],
        "launches_by_path": {"mesh_dryrun": mesh["launches"]},
        "launches_by_shard": mesh["launches_by_shard"],
        "max_abs_err": mesh["max_abs_err"],
        # one K4 round on leg 1's batch, its first round (every shard's
        # launch queued on the card's stream before any gather), beside
        # K3 on the same batch unsharded; the bound is the slowest
        # device's share (on this virtual mesh, K3's unsharded bound)
        "ms": mesh["ms"],
        "plain_ms": mesh["plain_ms"],
        "bound_ms": mesh["bound_ms"],
        "bound_by": mesh["bound_by"],
        "library_ms": None,
        "k3_unsharded_ms": mesh["k3_unsharded_ms"],
        "mesh": {key: mesh[key] for key in ("dp", "mp", "queries", "lanes",
                                            "v1", "levels", "steps")},
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
