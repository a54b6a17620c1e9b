"""Orchestration: per-contract analysis driver
(reference mythril/mythril/mythril_analyzer.py:201 +
mythril_disassembler.py:411, merged into one module).

The one-contract loop of the JAX package's core.py, with its run
telemetry: fire_lasers installs the flight recorder, starts the heartbeat
(--heartbeat / MYTHRIL_GPU_HEARTBEAT) and writes the stats JSON
(MYTHRIL_GPU_STATS_JSON) from its finally, so a run that dies (a module
exception, a DeviceFault) still leaves its telemetry, tagged
completed=false, and a flight-recorder dump, and arms the fault-injection
harness (--inject-fault / MYTHRIL_GPU_FAULTS).

Corpus runs (mythril_tpu/core.py:276-300, 411-793): several contracts in
--jobs spawn worker processes that share the card, or (--corpus-interleave
N) N analyses taking turns in this process on the interleave
coordinator's baton, so their sibling queries ride mixed-origin K1
streams. The device and every kernel are resolved and built here before
any worker or slot thread starts. The port's rule over the JAX package's:
a DeviceFault stops the whole run, from a worker (re-raised through the
pool, never rerun in process) or from a slot thread (the coordinator
cancels the other slots, and it is re-raised here). The tuned profile
(tune/) is applied at the start of fire_lasers and of each worker, before
the kernels are built. The statespace and graph dumps (-j, -g) explore
the first contract's whole statespace and report no issue.

Inputs: bytecode, an on-chain address over JSON-RPC (load_from_address;
the analyzer then hands the engine a DynLoader over the same client, so
storage, balances and callee code are read lazily from the chain, and
pre-analysis gates no module), solidity files through solc, and foundry
build-info artifacts. get_state_variable_from_storage is `read-storage`'s
slot math. A run with an RPC client analyzes its contracts one after the
other, as in the JAX package."""

import logging
import time
import traceback
from typing import List, Optional

from mythril_tpu_torch.analysis.report import Issue, Report
from mythril_tpu_torch.analysis.security import fire_lasers, retrieve_callback_issues
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.gpu.device import (
    DeviceFault,
    NoDeviceError,
    clear_fault,
    resolve_device,
)
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args
from mythril_tpu_torch.support.time_handler import time_handler
from mythril_tpu_torch.laser.transaction.models import tx_id_manager

log = logging.getLogger(__name__)

ANALYSIS_ADDRESS = 0x901D12EBE1B195E5AA8748E62BD7734AE19B51F  # well-known probe address


def build_device_kernels() -> None:
    """Build every kernel the run's device path launches: on the ragged
    path K2 (the xla mode's round, and the pallas mode's fallback past
    K1's capacities) and, in the pallas mode, K1; K3 on the bucketed path
    (--no-ragged); and K6 with the frontier on. A build is slow the first
    time (nvcc), so it happens here, before the first window, and never
    inside a dispatch's hard deadline."""
    from mythril_tpu_torch.gpu import (
        circuit_kernel,
        frontier_kernel,
        ragged_kernel,
        xla_kernel,
    )
    from mythril_tpu_torch.gpu.router import ragged_enabled
    from mythril_tpu_torch.laser import frontier

    if ragged_enabled():
        if ragged_kernel.kernel_mode() == "pallas":
            ragged_kernel.build_kernel()
        xla_kernel.build_kernel()
    else:
        circuit_kernel.build_kernel()
    if frontier.enabled():
        frontier_kernel.build_kernel()


class MythrilDisassembler:
    """Loads bytecode into EVMContract objects."""

    def __init__(self, eth=None, enable_online_lookup: bool = False):
        self.eth = eth
        self.contracts: List[EVMContract] = []
        self.enable_online_lookup = enable_online_lookup

    def load_from_bytecode(self, code: str, bin_runtime: bool = False,
                           name: Optional[str] = None) -> EVMContract:
        if bin_runtime:
            contract = EVMContract(code=code, name=name or "MAIN")
        else:
            contract = EVMContract(creation_code=code, name=name or "MAIN")
        self.contracts.append(contract)
        return contract

    def load_from_address(self, address: str) -> EVMContract:
        if self.eth is None:
            raise ValueError("no RPC client configured (use --rpc)")
        code = self.eth.eth_getCode(address)
        contract = EVMContract(code=code, name=address)
        self.contracts.append(contract)
        return contract

    def load_from_solidity(self, solidity_files: List[str],
                           solc_version: Optional[str] = None,
                           solc_args: Optional[List[str]] = None):
        from mythril_tpu_torch.solidity.soliditycontract import (
            find_solc_version,
            get_contracts_from_file,
        )

        solc_binary = (
            find_solc_version(solc_version) if solc_version else None
        )
        contracts = []
        for file in solidity_files:
            contracts.extend(
                get_contracts_from_file(file, solc_binary, solc_args))
        self.contracts.extend(contracts)
        return contracts

    def load_from_foundry(self, project_root: Optional[str] = None,
                          run_forge: bool = True):
        """Analyze a foundry project: run `forge build --build-info` and load
        every contract from the build-info artifacts (reference
        mythril_disassembler.py:160-217). With run_forge=False only existing
        artifacts are read — the offline-test path."""
        import json
        import os
        import shutil
        import subprocess

        from mythril_tpu_torch.solidity.soliditycontract import (
            get_contracts_from_foundry,
        )

        project_root = project_root or os.getcwd()
        if run_forge:
            forge = shutil.which("forge")
            if forge is None:
                raise ValueError(
                    "forge binary not found (install foundry or pass "
                    "pre-built artifacts)"
                )
            proc = subprocess.run(
                [forge, "build", "--build-info", "--force"],
                capture_output=True, text=True, cwd=project_root,
            )
            if proc.stderr:
                log.error(proc.stderr)
            if proc.returncode:
                # stale artifacts would silently analyze the OLD bytecode
                raise ValueError(
                    f"forge build failed (rc={proc.returncode}); refusing to "
                    "analyze stale artifacts"
                )
        build_dir = None
        for candidate in (
            os.path.join(project_root, "artifacts", "contracts", "build-info"),
            os.path.join(project_root, "out", "build-info"),
        ):
            if os.path.isdir(candidate):
                build_dir = candidate
                break
        if build_dir is None:
            raise ValueError(
                f"no foundry build-info directory under {project_root} "
                "(did `forge build --build-info` run?)"
            )
        files = sorted(
            (f for f in os.listdir(build_dir) if f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(build_dir, f)),
        )
        if not files:
            raise ValueError(f"{build_dir} has no build-info artifacts")
        contracts = []
        for file in files:
            with open(os.path.join(build_dir, file), encoding="utf8") as fd:
                build_info = json.load(fd)
            contracts.extend(get_contracts_from_foundry(build_info))
        self.contracts.extend(contracts)
        return contracts

    def get_state_variable_from_storage(
        self, address: str, params: Optional[List[str]] = None
    ) -> str:
        """Read storage slots over RPC, including solidity layout math for
        arrays and mappings (reference mythril_disassembler.py:330-410):
        `[position, length]` reads consecutive slots, `[pos, len, "array"]`
        starts at keccak(pos), `["mapping", pos, key...]` reads
        keccak(key ++ pos) per key."""
        from mythril_tpu_torch.utils.keccak import keccak256

        if self.eth is None:
            raise ValueError("no RPC client configured (use --rpc)")
        params = params or []
        position, length, mappings = 0, 1, []

        def slot_of(data: bytes) -> int:
            return int.from_bytes(keccak256(data), byteorder="big")

        try:
            if params and params[0] == "mapping":
                if len(params) < 3:
                    raise ValueError("mapping requires a position and keys")
                position = int(params[1])
                position_bytes = int(position).to_bytes(32, "big")
                for raw_key in params[2:]:
                    key = raw_key.encode("utf8").ljust(32, b"\x00")
                    mappings.append(slot_of(key + position_bytes))
                length = len(mappings)
                if length == 1:
                    position = mappings[0]
            else:
                if len(params) >= 4:
                    raise ValueError("too many parameters")
                if len(params) >= 1:
                    position = int(params[0])
                if len(params) >= 2:
                    length = int(params[1])
                if len(params) == 3 and params[2] == "array":
                    position = slot_of(int(position).to_bytes(32, "big"))
        except ValueError as error:
            raise ValueError(f"invalid storage index: {error}") from None

        lines = []
        if length == 1:
            lines.append(
                f"{position}: {self.eth.eth_getStorageAt(address, position)}"
            )
        elif mappings:
            for slot in mappings:
                lines.append(
                    f"{hex(slot)}: {self.eth.eth_getStorageAt(address, slot)}"
                )
        else:
            for slot in range(position, position + length):
                lines.append(
                    f"{hex(slot)}: {self.eth.eth_getStorageAt(address, slot)}"
                )
        return "\n".join(lines)


class MythrilAnalyzer:
    """Runs symbolic execution + modules per contract, renders the Report."""

    def __init__(
        self,
        disassembler: MythrilDisassembler,
        cmd_args=None,
        strategy: str = "bfs",
        address: Optional[int] = None,
    ):
        self.contracts = disassembler.contracts
        self.strategy = strategy
        self.eth = disassembler.eth
        # one record a --jobs worker task: its pid, the kernel launches it
        # counted, its router's calibrated rates and its final metrics
        # snapshot (_corpus_worker)
        self.worker_records: List[dict] = []
        self.address = address if address is not None else ANALYSIS_ADDRESS
        # copy CLI args into the global singleton (reference :65-76)
        if cmd_args is not None:
            for field in (
                "solver_timeout", "execution_timeout", "create_timeout",
                "max_depth", "loop_bound", "transaction_count",
                "pruning_factor", "call_depth_limit", "solver_log",
                "unconstrained_storage", "parallel_solving", "disable_iprof",
                "disable_mutation_pruner", "disable_dependency_pruning",
                "enable_state_merging", "enable_summaries", "solver_backend",
                "torch_device",
                "solve_cache", "transaction_sequences", "beam_width",
                "disable_coverage_strategy", "jobs", "corpus_interleave",
                "no_preanalysis",
                "no_aig_opt", "no_incremental_prep", "no_vmap_frontier",
                "no_ragged", "no_frontier_fork", "trace", "heartbeat",
                "inject_fault",
            ):
                if hasattr(cmd_args, field) and getattr(cmd_args, field) is not None:
                    setattr(args, field, getattr(cmd_args, field))
            if getattr(cmd_args, "disable_incremental_txs", False):
                args.incremental_txs = False
        # auto pruning factor (reference :78-82)
        if args.pruning_factor is None:
            args.pruning_factor = 1.0 if args.execution_timeout > 300 else 0.0

    def fire_lasers(self, modules: Optional[List[str]] = None,
                    transaction_count: Optional[int] = None) -> Report:
        import os

        from mythril_tpu_torch.observe import TRACE_ENV, get_tracer
        from mythril_tpu_torch.observe import flightrec, metrics

        reset_engine_state()
        stats = SolverStatistics()
        stats.enabled = True
        # the tuned profile (tune/): installed as the knobs' tuned tier
        # before any consumer reads its knobs and before the kernels are
        # built, since the kernel mode decides which are; once a process,
        # an explicit env var always wins, MYTHRIL_GPU_AUTOTUNE=0 disables
        from mythril_tpu_torch.tune import apply_tuned_profile

        apply_tuned_profile()
        if args.solver_backend == "gpu":
            # the device backend needs its device and its kernels before
            # the first window: with no card and none named this raises
            # (NoDeviceError), and a kernel that does not build raises,
            # before anything is explored; neither finishes on the host
            if resolve_device(args.torch_device).type == "cuda":
                build_device_kernels()
        # the fault-injection harness (resilience/faults.py): armed from
        # MYTHRIL_GPU_FAULTS or --inject-fault, disarmed when neither is
        # set; one configure per run, so crossing counters start fresh
        from mythril_tpu_torch.resilience import faults

        faults.configure_from_env(getattr(args, "inject_fault", None))
        # the always-on flight recorder: the tracer (and its span ring)
        # exists before the first span, with --trace unarmed too
        flightrec.install()
        trace_path = getattr(args, "trace", None) \
            or os.environ.get(TRACE_ENV)
        if trace_path:
            get_tracer().enable(trace_path)
        heartbeat = metrics.start_heartbeat(args.heartbeat)
        tx_count = transaction_count or args.transaction_count

        # the telemetry is written from the finally: a run that dies still
        # leaves its stats JSON (completed=false), its last beat and a
        # flight-recorder dump; the error itself propagates
        completed = False
        all_issues: List[Issue] = []
        exceptions: List[str] = []
        try:
            interleave_n = self._corpus_interleave_n()
            if args.jobs > 1 and len(self.contracts) > 1 \
                    and self.eth is None:
                if interleave_n >= 1:
                    # worker processes cannot share a coalescing window, so
                    # no cross-contract stream forms there
                    log.warning(
                        "--corpus-interleave is ignored under --jobs > 1 "
                        "(process isolation precludes cross-contract "
                        "windows); drop --jobs to interleave")
                all_issues, exceptions = self._fire_lasers_parallel(
                    modules, tx_count)
            elif interleave_n >= 1 and len(self.contracts) > 1 \
                    and self.eth is None:
                all_issues, exceptions = self._fire_lasers_interleaved(
                    modules, tx_count, stats, interleave_n)
            else:
                for contract in self.contracts:
                    issues, contract_exceptions = \
                        self._analyze_one_contract(
                            contract, modules, tx_count, stats=stats)
                    all_issues.extend(issues)
                    exceptions.extend(contract_exceptions)
            completed = True
        finally:
            if not completed:
                # before the tracer resets below
                flightrec.notify_run_incomplete()
            if heartbeat is not None:
                # the final beat: same singleton, same finally as the
                # stats JSON, so the two agree
                heartbeat.stop(final=True)
            self._dump_stats_json(stats, completed=completed)
            # the execution budget ends with the run: a window solved after
            # it, outside any analysis, is not held to a spent budget
            time_handler.start_execution(None)
            if trace_path:
                tracer = get_tracer()
                tracer.write()
                # a later fire_lasers in this process starts clean
                tracer.reset()

        report = Report(
            contracts=self.contracts,
            exceptions=exceptions,
        )
        for issue in all_issues:
            report.append_issue(issue)
        return report

    @staticmethod
    def _dump_stats_json(stats, completed: bool = True) -> None:
        """MYTHRIL_GPU_STATS_JSON=<path>: write the run's SolverStatistics
        (counters, occupancies, the device backend's stats, the roofline,
        the per-site resilience events) as one JSON object, stamped, with
        `completed` telling a clean run from telemetry salvaged by the
        finally."""
        import json
        import os

        from mythril_tpu_torch.observe import metrics

        path = os.environ.get("MYTHRIL_GPU_STATS_JSON")
        if not path:
            return
        payload = stats.as_dict()
        payload["completed"] = bool(completed)
        payload.update(metrics.stamp())
        try:
            with open(path, "w") as fd:
                json.dump(payload, fd)
        except OSError:
            log.warning("could not write solver stats to %s", path)

    def _analyze_one_contract(self, contract, modules, tx_count, stats=None):
        """Symbolic execution + modules for ONE contract (the loop body the
        corpus fan-out distributes). Returns (issues, exceptions)."""
        exceptions: List[str] = []
        tx_id_manager.restart_counter()
        from mythril_tpu_torch.laser.function_managers import (
            keccak_function_manager,
        )

        keccak_function_manager.reset()
        contract_start = time.monotonic()
        solver_before = stats.solver_time if stats else 0.0
        device_before = stats.device_stats() if stats else {}
        dynloader = None
        if self.eth is not None:
            from mythril_tpu_torch.support.loader import DynLoader

            dynloader = DynLoader(self.eth)
        from mythril_tpu_torch.observe import span as trace_span

        try:
            with trace_span("analyze.contract", cat="analyze",
                            contract=contract.name):
                sym = SymExecWrapper(
                    contract,
                    self.address,
                    self.strategy,
                    dynloader=dynloader,
                    max_depth=args.max_depth,
                    execution_timeout=args.execution_timeout,
                    loop_bound=args.loop_bound,
                    create_timeout=args.create_timeout,
                    transaction_count=tx_count,
                    modules=modules,
                    compulsory_statespace=False,
                )
                issues = fire_lasers(sym, white_list=modules)
        except KeyboardInterrupt:
            log.critical("keyboard interrupt: retrieving partial results")
            issues = retrieve_callback_issues(modules)
        except DeviceFault:
            raise  # never a partial report: the device path failed
        except Exception:
            log.exception("exception during analysis of %s", contract.name)
            exceptions.append(traceback.format_exc())
            issues = retrieve_callback_issues(modules)
        for issue in issues:
            issue.add_code_info(contract)
            issue.resolve_function_name(_signature_db())
        if stats is not None:
            log.info(str(stats))
            log.info(self._phase_split(contract.name, contract_start,
                                       solver_before, device_before, stats))
        return issues, exceptions

    def _explore_statespace(self, contract):
        """The SymExecWrapper of the -j and -g dumps (reference
        mythril_analyzer.py:84-121): the whole statespace, the batched
        frontier off, the callback modules attached as in the reference.
        The device backend resolves its device and builds its kernels
        first, as fire_lasers does, and the execution budget ends with
        the exploration."""
        reset_engine_state()
        if args.solver_backend == "gpu" \
                and resolve_device(args.torch_device).type == "cuda":
            build_device_kernels()
        try:
            return SymExecWrapper(
                contract,
                self.address,
                self.strategy,
                max_depth=args.max_depth,
                execution_timeout=args.execution_timeout,
                transaction_count=args.transaction_count,
                compulsory_statespace=True,
            )
        finally:
            time_handler.start_execution(None)

    def dump_statespace(self, contract=None) -> str:
        """JSON statespace dump (reference mythril_analyzer.py:84)."""
        import json

        from mythril_tpu_torch.analysis.traceexplore import (
            get_serializable_statespace,
        )

        sym = self._explore_statespace(contract or self.contracts[0])
        return json.dumps(get_serializable_statespace(sym))

    def graph_html(self, contract=None, enable_physics: bool = False) -> str:
        """Interactive vis.js CFG html (reference mythril_analyzer.py:105)."""
        from mythril_tpu_torch.analysis.callgraph import generate_graph

        sym = self._explore_statespace(contract or self.contracts[0])
        return generate_graph(sym, physics=enable_physics)

    def _fire_lasers_parallel(self, modules, tx_count):
        """Corpus-level parallelism (mythril_tpu/core.py:411): the
        contracts analyzed in --jobs spawn worker PROCESSES. Spawn, not
        fork: this process already holds a CUDA context. Every kernel was
        built here before the pool starts, so a worker only loads the
        built libraries. On one card the workers time-slice it.

        Results stream back through imap_unordered, so a keyboard
        interrupt or a worker failure keeps every contract already done;
        each worker's SolverStatistics and trace spans fold into this
        process's. A worker's death (the jobs.worker fault site's `exit`,
        or a killed process) is seen by a liveness watchdog: its pending
        contracts are requeued into a fresh pool once (a `worker_requeue`
        event), and a second death analyzes the rest in this process (a
        `degraded` event), as does a host error raised in a worker. A
        DeviceFault (or NoDeviceError) raised in a worker is re-raised
        here and stops the run: it is never rerun in process."""
        import multiprocessing as mp

        from mythril_tpu_torch import resilience
        from mythril_tpu_torch.observe import get_tracer

        workers = min(args.jobs, len(self.contracts))
        payloads = [
            (idx, contract, self.address, self.strategy, modules, tx_count,
             dict(args.__dict__))
            for idx, contract in enumerate(self.contracts)
        ]
        context = mp.get_context("spawn")
        stats = SolverStatistics()
        tracer = get_tracer()
        done = {}  # contract idx -> (issues, exceptions)
        interrupted = False
        try:
            pending = payloads
            requeued = False
            while True:
                try:
                    self._consume_pool(context, workers, pending, done,
                                       stats, tracer, self.worker_records)
                    break
                except _PoolWorkerDied:
                    pending = [p for p in payloads if p[0] not in done]
                    if not pending:
                        break  # the dead worker had nothing in flight
                    if not requeued:
                        requeued = True
                        # one event a requeue of the pool (the JAX package
                        # counts the contracts it requeues)
                        resilience.record_event("jobs.worker",
                                                "worker_requeue")
                        log.warning(
                            "a --jobs worker died; requeuing %d pending "
                            "contract(s) into a fresh pool", len(pending))
                        workers = min(workers, len(pending))
                        continue
                    resilience.record_event("jobs.worker", "degraded")
                    log.warning(
                        "worker died again after the requeue; analyzing "
                        "the %d incomplete contract(s) in-process",
                        len(pending))
                    break
        except KeyboardInterrupt:
            interrupted = True
            log.critical(
                "keyboard interrupt: keeping %d/%d completed contracts",
                len(done), len(payloads))
        except (DeviceFault, NoDeviceError):
            raise  # the device path failed: the run stops
        except Exception:
            resilience.record_event("jobs.worker", "degraded")
            log.exception(
                "parallel corpus analysis failed; sequential fallback for "
                "the %d incomplete contracts", len(payloads) - len(done))
        for idx, contract in enumerate(self.contracts):
            if idx in done:
                continue
            if interrupted:
                # a report missing contracts must never read as "those
                # were safe": each unanalyzed contract is an exception row
                done[idx] = ([], [
                    f"analysis of {contract.name} interrupted before "
                    f"completion (--jobs run): no findings recorded"])
            else:
                done[idx] = self._analyze_one_contract(
                    contract, modules, tx_count, stats=stats)
        all_issues: List[Issue] = []
        exceptions: List[str] = []
        for idx in range(len(self.contracts)):
            issues, contract_exceptions = done[idx]
            all_issues.extend(issues)
            exceptions.extend(contract_exceptions)
        return all_issues, exceptions

    @staticmethod
    def _corpus_interleave_n() -> int:
        """Interleave width (mythril_tpu/core.py:523): the env first
        (MYTHRIL_GPU_CORPUS_INTERLEAVE), then --corpus-interleave. 0 is
        the plain sequential loop; 1 the same slots and isolation as the
        interleaved run, one analysis at a time (the baseline its reports
        equal byte for byte on the host backend); 2 or more interleave."""
        import os

        env = os.environ.get("MYTHRIL_GPU_CORPUS_INTERLEAVE", "")
        if env:
            try:
                return max(0, int(env))
            except ValueError:
                pass
        return max(0, int(getattr(args, "corpus_interleave", 0) or 0))

    def _fire_lasers_interleaved(self, modules, tx_count, stats, slots):
        """Interleaved corpus run (mythril_tpu/core.py:540): up to
        `slots` contracts' analyses stepped round-robin in this process on
        baton-passing threads (service/interleave.py: one thread runs at a
        time). Each contract's slice of the engine state is switched at
        every hand-off, and sibling queries of different contracts park in
        the scheduler's window and ride one stream (xcontract_windows
        counts the mixed launches). An error escaping a slot (a
        DeviceFault) cancels the other slots; every slot thread is joined
        before it is re-raised here, and no slot thread outlives the
        call."""
        import threading

        from mythril_tpu_torch.service import interleave

        slots = max(1, min(slots, len(self.contracts)))
        done = {}

        def analyze_one(idx, contract):
            done[idx] = self._analyze_one_contract(
                contract, modules, tx_count, stats=stats)

        coordinator = interleave.Coordinator(
            list(enumerate(self.contracts)))
        interleave.install(coordinator)
        log.info("interleaved corpus run: %d contracts over %d "
                 "slot(s), quantum %d exec iterations",
                 len(self.contracts), slots, coordinator.quantum)
        threads = []
        try:
            for slot_id in range(slots):
                thread = threading.Thread(
                    target=coordinator.run_slot,
                    args=(slot_id, analyze_one),
                    name=f"mythril-interleave-{slot_id}")
                thread.start()
                threads.append(thread)
            for thread in threads:
                thread.join()
        except BaseException:
            # interrupted while waiting: stop the slots before unwinding
            coordinator.cancel()
            for thread in threads:
                thread.join()
            raise
        finally:
            interleave.uninstall()
        if coordinator.failure is not None:
            raise coordinator.failure
        all_issues: List[Issue] = []
        exceptions: List[str] = []
        for idx, contract in enumerate(self.contracts):
            if idx not in done:
                exceptions.append(
                    f"analysis of {contract.name} never completed "
                    f"(interleaved corpus run)")
                continue
            issues, contract_exceptions = done[idx]
            all_issues.extend(issues)
            exceptions.extend(contract_exceptions)
        return all_issues, exceptions

    @staticmethod
    def _consume_pool(context, workers, payloads, done, stats, tracer,
                      records):
        """One pool generation (mythril_tpu/core.py:602): stream results
        off imap_unordered into `done`, folding each worker's stats and
        spans into this process's and its record into `records`. Raises
        _PoolWorkerDied when the watchdog sees a worker die (its task is
        lost: the pool respawns the worker but never resubmits the
        work)."""
        with context.Pool(processes=workers) as pool:
            iterator = pool.imap_unordered(_corpus_worker, payloads)
            watchdog = _PoolWatchdog(pool)
            while True:
                try:
                    result = MythrilAnalyzer._next_result(iterator, watchdog)
                except StopIteration:
                    return
                idx, issues, contract_exceptions, snapshot, events, \
                    record = result
                done[idx] = (issues, contract_exceptions)
                stats.absorb(snapshot)
                # worker spans carry their own pid: each worker keeps its
                # own process lane in the merged timeline
                tracer.absorb_events(events)
                records.append(record)

    _POOL_POLL_S = 0.25

    @staticmethod
    def _next_result(iterator, watchdog):
        """Next streamed result, polling so the watchdog sees a worker's
        death between waits (:628). Iterators without a timed .next
        (scripted pools in tests) are consumed directly."""
        timed_next = getattr(iterator, "next", None)
        if timed_next is None:
            return next(iterator)
        import multiprocessing as mp

        while True:
            try:
                return timed_next(timeout=MythrilAnalyzer._POOL_POLL_S)
            except mp.TimeoutError:
                watchdog.check()

    @staticmethod
    def _phase_split(name, contract_start, solver_before, device_before,
                     stats) -> str:
        """Per-contract wall-clock split: interpreter / host solver / device
        pack+ship / device solve. The architecture dial for batching work:
        whichever phase dominates is what the next kernel targets."""
        wall = time.monotonic() - contract_start
        solver_s = stats.solver_time - solver_before
        device = stats.device_stats()

        def delta(key):
            return device.get(key, 0.0) - device_before.get(key, 0.0)

        pack_s = delta("pack_seconds")
        ship_s = delta("ship_seconds")
        solve_s = delta("solve_seconds")
        # solver_time already folds in the device phases (add_batch records
        # the full get_models_batch wall) — subtract once, not twice
        interp_s = max(wall - solver_s, 0.0)
        host_solver_s = max(solver_s - pack_s - ship_s - solve_s, 0.0)
        return (
            f"phase split [{name}]: wall={wall:.2f}s "
            f"interpreter={interp_s:.2f}s host-solver={host_solver_s:.2f}s "
            f"device-pack={pack_s:.2f}s device-ship={ship_s:.2f}s "
            f"device-solve={solve_s:.2f}s"
        )


class _PoolWorkerDied(Exception):
    """A --jobs worker process died with work in flight."""


class _PoolWatchdog:
    """Sees a worker process of a multiprocessing.Pool die
    (mythril_tpu/core.py:710): a worker with an exit code (dead, not yet
    reaped), or the worker pid set changed (the pool respawned one, which
    loses the task it had)."""

    def __init__(self, pool):
        self._pool = pool
        self._pids = self._snapshot()

    def _snapshot(self):
        return frozenset(
            worker.pid for worker in getattr(self._pool, "_pool", ()))

    def check(self) -> None:
        workers = getattr(self._pool, "_pool", ())
        if any(worker.exitcode is not None for worker in workers) \
                or self._snapshot() != self._pids:
            raise _PoolWorkerDied("a --jobs worker process died")


def _corpus_worker(payload):
    """Spawn-process entry for one contract of a --jobs run
    (mythril_tpu/core.py:732). Rebuilds the args singleton from the
    parent's, crosses the jobs.worker fault site (an `exit` plan kills the
    worker here: the shape a crashed worker shows the parent's watchdog),
    resets the engine and the run's statistics, applies the tuned profile,
    resolves the device and loads the kernels the parent built (no nvcc
    here, and no build inside a dispatch's hard deadline), and runs the
    one-contract path. Returns
    (idx, issues, exceptions, stats snapshot, trace events, record): plain
    data that pickles back. The record holds the worker's pid, the kernel
    launches this task counted, its router's calibrated rates and its
    final metrics snapshot. A DeviceFault propagates to the parent."""
    import os

    from mythril_tpu_torch.gpu import (
        circuit_kernel,
        frontier_kernel,
        ragged_kernel,
        xla_kernel,
    )
    from mythril_tpu_torch.observe import TRACE_ENV, flightrec, get_tracer
    from mythril_tpu_torch.observe import metrics
    from mythril_tpu_torch.resilience import faults, maybe_inject

    idx, contract, address, strategy, modules, tx_count, args_state = payload
    args.__dict__.update(args_state)
    args.jobs = 1  # workers never fan out again
    faults.configure_from_env(getattr(args, "inject_fault", None))
    maybe_inject("jobs.worker")
    reset_engine_state()
    stats = SolverStatistics()
    stats.reset()  # a pool worker may take several contracts
    stats.enabled = True
    # spawn starts a new interpreter: the parent's applied profile does
    # not cross into it, so the worker applies its own before the build
    from mythril_tpu_torch.tune import apply_tuned_profile

    apply_tuned_profile()
    flightrec.install()
    tracer = get_tracer()
    if getattr(args, "trace", None) or os.environ.get(TRACE_ENV):
        tracer.enable(None)  # collect only: the parent writes the merge
    if args.solver_backend == "gpu":
        if resolve_device(args.torch_device).type == "cuda":
            build_device_kernels()
    kernels = {"ragged_round": ragged_kernel,
               "frontier_step": frontier_kernel,
               "xla_round": xla_kernel, "circuit_round": circuit_kernel}
    before = {name: module.launches for name, module in kernels.items()}
    disassembler = MythrilDisassembler()
    disassembler.contracts.append(contract)
    analyzer = MythrilAnalyzer(disassembler, strategy=strategy,
                               address=address)
    try:
        issues, exceptions = analyzer._analyze_one_contract(
            contract, modules, tx_count, stats=stats)
    finally:
        time_handler.start_execution(None)
    from mythril_tpu_torch.gpu import router

    record = {
        "pid": os.getpid(), "contract": idx,
        "launches": {name: module.launches - before[name]
                     for name, module in kernels.items()},
        "rates": (router._router.attainable_rates()
                  if router._router is not None else {}),
        "metrics": metrics.snapshot(final=True),
    }
    return (idx, issues, exceptions, stats.as_dict(),
            tracer.drain_events(), record)


def reset_engine_state() -> None:
    """Reset the engine's process-global pieces: the transaction ids, the
    keccak function manager, the detection modules' issues and dedupe
    caches, the signature DB and a recorded device fault. Every
    fire_lasers starts here (SymExecWrapper resets the plugin loader
    itself); support/model.clear_caches calls it once this module is
    loaded. Touches nothing of the JAX package."""
    from mythril_tpu_torch.analysis.module import ModuleLoader
    from mythril_tpu_torch.laser.function_managers import (
        keccak_function_manager,
    )
    from mythril_tpu_torch.support.signatures import SignatureDB

    tx_id_manager.restart_counter()
    keccak_function_manager.reset()
    for module in ModuleLoader().get_detection_modules():
        module.reset_module()
        module.reset_cache()
    SignatureDB.reset()
    clear_fault()


def _signature_db():
    try:
        from mythril_tpu_torch.support.signatures import SignatureDB

        return SignatureDB()
    except Exception:
        return None
