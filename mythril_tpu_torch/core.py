"""Orchestration: per-contract analysis driver
(reference mythril/mythril/mythril_analyzer.py:201 +
mythril_disassembler.py:411, merged into one module).

The one-contract loop of the JAX package's core.py, with its run
telemetry: fire_lasers installs the flight recorder, starts the heartbeat
(--heartbeat / MYTHRIL_GPU_HEARTBEAT) and writes the stats JSON
(MYTHRIL_GPU_STATS_JSON) from its finally, so a run that dies (a module
exception, a DeviceFault) still leaves its telemetry, tagged
completed=false, and a flight-recorder dump, and arms the fault-injection
harness (--inject-fault / MYTHRIL_GPU_FAULTS). Its corpus surfaces
(--jobs, --corpus-interleave), the tuned profile, the statespace and graph
dumps, and loading from solidity, foundry or RPC wait for later slices."""

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

    def __init__(self):
        self.contracts: List[EVMContract] = []

    def load_from_bytecode(self, code: str, bin_runtime: bool = False,
                           name: Optional[str] = None) -> EVMContract:
        if bin_runtime:
            contract = EVMContract(code=code, name=name or "MAIN")
        else:
            contract = EVMContract(creation_code=code, name=name or "MAIN")
        self.contracts.append(contract)
        return contract


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
        self.address = address if address is not None else ANALYSIS_ADDRESS
        # copy CLI args into the global singleton (reference :65-76)
        if cmd_args is not None:
            for field in (
                "solver_timeout", "execution_timeout", "create_timeout",
                "max_depth", "loop_bound", "transaction_count",
                "pruning_factor", "call_depth_limit", "disable_iprof",
                "disable_mutation_pruner", "disable_dependency_pruning",
                "solver_backend", "torch_device",
                "solve_cache", "transaction_sequences", "beam_width",
                "disable_coverage_strategy", "no_preanalysis",
                "no_aig_opt", "no_incremental_prep", "no_vmap_frontier",
                "no_frontier_fork", "no_ragged", "trace", "heartbeat",
                "inject_fault",
            ):
                if hasattr(cmd_args, field) and getattr(cmd_args, field) is not None:
                    setattr(args, field, getattr(cmd_args, field))
        # auto pruning factor (reference :78-82)
        if args.pruning_factor is None:
            args.pruning_factor = 1.0 if args.execution_timeout > 300 else 0.0

    def fire_lasers(self, modules: Optional[List[str]] = None,
                    transaction_count: Optional[int] = None) -> Report:
        import os

        from mythril_tpu_torch.observe import TRACE_ENV, get_tracer
        from mythril_tpu_torch.observe import flightrec, metrics

        reset_engine_state()
        if args.solver_backend == "gpu":
            # the device backend needs its device and its kernels before
            # the first window: with no card and none named this raises
            # (NoDeviceError), and a kernel that does not build raises,
            # before anything is explored; neither finishes on the host
            if resolve_device(args.torch_device).type == "cuda":
                build_device_kernels()
        stats = SolverStatistics()
        stats.enabled = True
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
            for contract in self.contracts:
                issues, contract_exceptions = self._analyze_one_contract(
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
        from mythril_tpu_torch.observe import span as trace_span

        try:
            with trace_span("analyze.contract", cat="analyze",
                            contract=contract.name):
                sym = SymExecWrapper(
                    contract,
                    self.address,
                    self.strategy,
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
