"""`myth`-compatible command line (reference mythril/interfaces/cli.py:976).

Subcommands: analyze/a, serve, list-detectors, version, help. `analyze`
exits with 0 when it found no issue and 1 when it found some (reference
cli.py:875-878), and with 2 when the analysis failed: no device, a device
fault, or an exception that cut a contract's analysis short (the partial
report is printed). `analyze` runs the batched
solve windows on the CUDA device by default (--solver-backend gpu);
--torch-device cpu runs the kernels' plain PyTorch versions instead, and
--solver-backend cpu the host CDCL alone. `serve` runs the multi-tenant
daemon (serve/), or with --shards N > 1 the sharded fleet (fleet/), on
the same device rules: it exits 0 after a SIGTERM drain and 2 without a
device or once a device fault stopped it."""

import argparse
import logging
import os
import sys
from typing import List

from mythril_tpu_torch.version import __version__

log = logging.getLogger(__name__)

COMMAND_ALIASES = {"a": "analyze"}


def main() -> None:
    parser = build_parser()
    argv = sys.argv[1:]
    if argv and argv[0] in COMMAND_ALIASES:
        argv[0] = COMMAND_ALIASES[argv[0]]
    parsed = parser.parse_args(argv)
    if parsed.command == "help":
        parser.print_help()
        sys.exit(0)
    configure_logging(getattr(parsed, "verbose", 2))
    try:
        exit_code = execute_command(parsed)
    except CliError as error:
        print(f"error: {error}", file=sys.stderr)
        sys.exit(2)
    sys.exit(exit_code)


class CliError(Exception):
    pass


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="myth-gpu",
        description=(
            "mythril_tpu_torch: security analyzer for EVM bytecode on "
            "PyTorch and CUDA"
        ),
    )
    parser.add_argument("--version", action="version",
                        version=f"mythril_tpu_torch {__version__}")
    subparsers = parser.add_subparsers(dest="command")

    analyze = subparsers.add_parser("analyze", help="analyze a contract")
    add_input_args(analyze)
    add_analysis_args(analyze)
    add_output_args(analyze)

    serve = subparsers.add_parser(
        "serve",
        help="run the multi-tenant analyzer daemon (HTTP API on "
             "localhost: POST /analyze, POST /evict, GET /healthz, "
             "GET /metrics)")
    serve.add_argument(
        "--port", type=int, default=None,
        help="localhost listener port (0 = ephemeral; default: "
             "MYTHRIL_GPU_SERVE_PORT or 8311)")
    serve.add_argument(
        "--shards", type=int, default=None,
        help="worker processes: > 1 runs the sharded fleet (a supervisor "
             "and digest-routed daemon processes on the same card; "
             "default: MYTHRIL_GPU_FLEET_SHARDS or 1, one process)")
    serve.add_argument("-v", "--verbose", type=int, default=2,
                       help="log level 0-5")
    add_analysis_args(serve)

    subparsers.add_parser("list-detectors", help="list detection modules")
    subparsers.add_parser("version", help="print version")
    subparsers.add_parser("help", add_help=False,
                          help="print this help message")
    return parser


def add_input_args(parser) -> None:
    parser.add_argument("-c", "--code", help="hex bytecode string")
    parser.add_argument("-f", "--codefile", action="append",
                        help="file containing hex bytecode (repeatable: "
                             "each -f adds one contract to the run)")
    parser.add_argument("--bin-runtime", action="store_true",
                        help="treat -c/-f input as runtime (deployed) code")
    parser.add_argument("-v", "--verbose", type=int, default=2,
                        help="log level 0-5")


def add_analysis_args(parser) -> None:
    parser.add_argument("-m", "--modules",
                        help="comma-separated module names to run")
    parser.add_argument("-t", "--transaction-count", type=int, default=2)
    parser.add_argument("--max-depth", type=int, default=128)
    parser.add_argument("--strategy", default="bfs",
                        choices=["dfs", "bfs", "naive-random",
                                 "weighted-random", "beam-search", "pending"])
    parser.add_argument("--beam-search", type=int, metavar="WIDTH",
                        dest="beam_width", default=None,
                        help="shortcut: --strategy beam-search with WIDTH")
    parser.add_argument("--execution-timeout", type=int, default=86400)
    parser.add_argument("--create-timeout", type=int, default=10)
    parser.add_argument("--solver-timeout", type=int, default=25000)
    parser.add_argument("--loop-bound", type=int, default=3)
    parser.add_argument("--call-depth-limit", type=int, default=3)
    parser.add_argument("--pruning-factor", type=float, default=None)
    parser.add_argument("--jobs", type=int, default=1,
                        help="analyze the contracts in N spawn worker "
                             "processes sharing the card")
    parser.add_argument("--corpus-interleave", type=int, default=0,
                        dest="corpus_interleave", metavar="N",
                        help="step up to N contracts' analyses in turns in "
                             "ONE process, so sibling queries of different "
                             "contracts share windows and K1 streams; 1 = "
                             "the same slots one contract at a time, 0 = "
                             "off; MYTHRIL_GPU_CORPUS_INTERLEAVE wins over "
                             "it")
    parser.add_argument("--solver-backend", default="gpu",
                        choices=["gpu", "cpu"],
                        help="satisfiability backend: gpu (default) sends "
                             "batched windows through the router to the "
                             "circuit-SLS kernel on the device; cpu is the "
                             "host CDCL alone")
    parser.add_argument("--torch-device", dest="torch_device", default=None,
                        help="torch device of the gpu backend (default: the "
                             "current CUDA device, an error without one; "
                             "cpu runs the kernels' plain PyTorch versions)")
    parser.add_argument("--solve-cache", dest="solve_cache",
                        default="memory", choices=["off", "memory", "disk"],
                        help="solve-result cache tiers: memory (default) is "
                             "the in-process term-keyed tier and the "
                             "quick-sat probe; disk adds the persistent "
                             "cross-run result store and the persisted "
                             "calibration under MYTHRIL_GPU_CACHE_DIR; off "
                             "disables result caching")
    parser.add_argument("--no-preanalysis", action="store_true",
                        dest="no_preanalysis",
                        help="disable the static bytecode pre-analysis "
                             "passes (CFG recovery, detector gating, fork "
                             "hint pruning, CNF preprocessing); env "
                             "override: MYTHRIL_GPU_PREANALYSIS=0|1")
    parser.add_argument("--no-aig-opt", action="store_true",
                        dest="no_aig_opt",
                        help="disable the AIG structural optimization "
                             "passes over blasted solver instances "
                             "(strashing, constant sweeping, per-component "
                             "root projection); env override: "
                             "MYTHRIL_GPU_AIG_OPT=0|1")
    parser.add_argument("--no-incremental-prep", action="store_true",
                        dest="no_incremental_prep",
                        help="disable incremental cross-query preparation "
                             "(prefix-memoized lowering and the session "
                             "strash table over sibling solver queries); "
                             "env override: MYTHRIL_GPU_INCR_PREP=0|1")
    parser.add_argument("--no-vmap-frontier", action="store_true",
                        dest="no_vmap_frontier",
                        help="disable the batched symbolic-execution "
                             "frontier (sibling machine states stepping "
                             "straight-line opcode runs as one step, on "
                             "the card by default) and step one state at "
                             "a time; env override: "
                             "MYTHRIL_GPU_VMAP_FRONTIER=0|1 (step backend: "
                             "MYTHRIL_GPU_FRONTIER_BACKEND=auto|numpy|"
                             "torch|cuda)")
    parser.add_argument("--no-ragged", action="store_true",
                        dest="no_ragged",
                        help="disable the ragged dispatch (one flat stream "
                             "a window, K1) and the cube second pass, "
                             "restoring the level-bucketed padded dispatch "
                             "with the per-query round K3; env override: "
                             "MYTHRIL_GPU_RAGGED=0|1")
    parser.add_argument("--no-frontier-fork", action="store_true",
                        dest="no_frontier_fork",
                        help="disable batched forking of symbolic JUMPI "
                             "inside the frontier (sibling feasibility as "
                             "one fork bundle through the router); env "
                             "override: MYTHRIL_GPU_FRONTIER_FORK=0|1")
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="write a Chrome-trace-event / Perfetto span "
                             "timeline of the whole pipeline (analyze, "
                             "LASER exec, frontier, solver prepare, "
                             "router, device pack/ship/kernel, CDCL "
                             "settle, cache tiers, scheduler flushes) to "
                             "PATH; env equivalent: MYTHRIL_GPU_TRACE")
    parser.add_argument("--heartbeat", metavar="PATH", default=None,
                        help="append periodic live-metrics snapshots "
                             "(counters, occupancies, roofline, "
                             "resilience events; schema_version + git "
                             "rev + platform stamped) as JSON lines to "
                             "PATH while the run is in flight; cadence "
                             "via MYTHRIL_GPU_HEARTBEAT_INTERVAL "
                             "(default 10 s), Prometheus text file via "
                             "MYTHRIL_GPU_PROM; env equivalent: "
                             "MYTHRIL_GPU_HEARTBEAT")
    parser.add_argument("--inject-fault", metavar="SPEC", default=None,
                        dest="inject_fault",
                        help="arm the deterministic fault-injection harness "
                             "(resilience/faults.py): a comma-separated "
                             "list of site:kind:trigger plans, e.g. "
                             "device.dispatch:raise:n1,disk.entry:corrupt:* "
                             "— kinds raise|hang|delay|corrupt|exit, "
                             "triggers n<k> (k-th crossing), r<p> (seeded "
                             "rate, MYTHRIL_GPU_FAULT_SEED) or * (every "
                             "crossing); env equivalent: MYTHRIL_GPU_FAULTS")
    parser.add_argument("--disable-mutation-pruner", action="store_true")
    parser.add_argument("--disable-coverage-strategy", action="store_true")
    parser.add_argument("--disable-dependency-pruning", action="store_true")
    parser.add_argument("--disable-iprof", action="store_true")
    parser.add_argument("--transaction-sequences",
                        help="pinned function sequences, e.g. [[0xa9059cbb],[-1]]")


def add_output_args(parser) -> None:
    parser.add_argument("-o", "--outform", default="text",
                        choices=["text", "markdown", "json", "jsonv2"])


def configure_logging(verbosity: int) -> None:
    levels = {
        0: logging.NOTSET,
        1: logging.CRITICAL,
        2: logging.ERROR,
        3: logging.WARNING,
        4: logging.INFO,
        5: logging.DEBUG,
    }
    logging.basicConfig(
        level=levels.get(verbosity, logging.ERROR),
        format="%(levelname)s: %(message)s",
    )


def load_code(parsed) -> List[tuple]:
    """(hex blob, contract name) pairs to analyze, one per contract
    (repeatable -f). Single-input runs keep the reference's MAIN name;
    multi-file corpus runs name each contract by its file basename so
    per-contract findings stay attributable (the cross-contract bench
    leg compares findings per contract, and a corpus of MAINs would be
    indistinguishable)."""
    if parsed.code:
        return [(parsed.code, None)]
    if parsed.codefile:
        blobs = []
        multi = len(parsed.codefile) > 1
        for path in parsed.codefile:
            with open(path) as handle:
                blobs.append((handle.read().strip(),
                              os.path.basename(path) if multi else None))
        return blobs
    raise CliError("no input: provide -c <hex> or -f <file>")


def execute_command(parsed) -> int:
    command = parsed.command
    if command in (None, "version"):
        print(f"mythril_tpu_torch {__version__}")
        return 0

    if command == "list-detectors":
        from mythril_tpu_torch.analysis.module import ModuleLoader

        for module in ModuleLoader().get_detection_modules():
            print(f"{module.name}: {module.description}")
        return 0

    if command == "analyze":
        from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError

        disassembler = MythrilDisassembler()
        for blob, name in load_code(parsed):
            disassembler.load_from_bytecode(
                blob, bin_runtime=parsed.bin_runtime, name=name)
        strategy = parsed.strategy
        if getattr(parsed, "beam_width", None):
            strategy = "beam-search"
        analyzer = MythrilAnalyzer(
            disassembler, cmd_args=parsed, strategy=strategy)
        modules = parsed.modules.split(",") if parsed.modules else None
        try:
            report = analyzer.fire_lasers(
                modules=modules, transaction_count=parsed.transaction_count
            )
        except (NoDeviceError, DeviceFault) as error:
            raise CliError(str(error))
        outform = parsed.outform
        if outform == "text":
            print(report.as_text())
        elif outform == "markdown":
            print(report.as_markdown())
        elif outform == "json":
            print(report.as_json())
        else:
            print(report.as_swc_standard_format())
        if report.exceptions:
            # an exception cut a contract's analysis short: the report is
            # partial, and "no issues" would be a claim it cannot make
            return 2
        return 1 if report.issues else 0

    if command == "serve":
        return serve_command(parsed)

    raise CliError(f"unknown command {command!r}")


def serve_command(parsed) -> int:
    """`serve` (reference cli.py:454-493): the analysis flags go into the
    args singleton as an analyze run's would (every request inherits
    them); one process runs the daemon, --shards N > 1 the fleet."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.fleet import fleet_shards
    from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
    from mythril_tpu_torch.serve.daemon import (
        DEFAULT_PORT,
        PORT_ENV,
        ServeDaemon,
        serve_forever,
    )

    MythrilAnalyzer(MythrilDisassembler(), cmd_args=parsed)
    port = parsed.port
    if port is None:
        port = int(os.environ.get(PORT_ENV) or DEFAULT_PORT)
    modules = parsed.modules.split(",") if parsed.modules else None
    try:
        shards = fleet_shards(parsed.shards)
        if shards > 1:
            from mythril_tpu_torch.fleet.supervisor import (
                FleetSupervisor,
                serve_forever_fleet,
            )

            return serve_forever_fleet(FleetSupervisor(
                shards, tx_count=parsed.transaction_count,
                modules=modules, http_port=port))
        return serve_forever(ServeDaemon(
            tx_count=parsed.transaction_count, modules=modules,
            http_port=port))
    except (NoDeviceError, DeviceFault) as error:
        raise CliError(str(error))


if __name__ == "__main__":
    main()
