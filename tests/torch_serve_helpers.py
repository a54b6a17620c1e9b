"""Shared set-up of the port's serve and fleet tests
(tests/test_torch_serve*.py, test_torch_fleet*.py, test_torch_chaos_serve.py):
a full reset of the port's solve and engine state, the in-process daemon
on the device backend with `--torch-device cpu` (K1's plain version;
the frontier steps on numpy there), the sequential oracle, and small HTTP
helpers with their own timeouts."""

import json
import urllib.error
import urllib.request
from types import SimpleNamespace

from mythril_tpu_torch.resilience import deadline as deadline_mod
from mythril_tpu_torch.resilience import faults
from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
from mythril_tpu_torch.support.args import args

# every request, drain and HTTP call of these tests is bounded by these
REQUEST_WAIT_S = 240.0
DRAIN_WAIT_S = 120.0
HTTP_TIMEOUT_S = 60.0


def full_reset() -> None:
    """Fresh process-global state: the memory tiers, blasters, router,
    scheduler, store handle and session fuses (clear_caches), the deadline
    runner, the fault plan, and the args singleton."""
    from mythril_tpu_torch.smt.solver import frontend
    from mythril_tpu_torch.support.model import clear_caches

    args.reset()
    clear_caches()
    frontend._global_blaster = None
    deadline_mod.reset()
    faults.configure(None)


def device_args(**overrides) -> None:
    """The device backend on the CPU: K1's plain version behind the seam
    the card takes."""
    args.solver_backend = "gpu"
    args.torch_device = "cpu"
    for key, value in overrides.items():
        setattr(args, key, value)


def fresh_stats() -> SolverStatistics:
    stats = SolverStatistics()
    stats.reset()
    stats.enabled = True
    return stats


def drain(daemon) -> None:
    assert daemon.drain(timeout=DRAIN_WAIT_S), "serve drain hung"


def sorted_issues(issues):
    """Findings as a sorted list of canonical JSON strings (byte level)."""
    return sorted(json.dumps(issue, sort_keys=True) for issue in issues)


def issue_set(issues):
    """Findings at issue granularity: (SWC id, function, address, title)."""
    return sorted((issue.get("swc-id"), issue.get("function"),
                   issue.get("address"), issue.get("title"))
                  for issue in issues)


def solo_issues(code_hex: str, tx_count: int = 1, backend: str = "gpu"):
    """The sequential oracle: one fire_lasers of the contract in this
    process (its report's issues as JSON dicts)."""
    from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler

    saved = dict(args.__dict__)
    try:
        cmd_args = SimpleNamespace(solver_backend=backend,
                                   torch_device="cpu")
        disassembler = MythrilDisassembler()
        disassembler.load_from_bytecode(code_hex)
        report = MythrilAnalyzer(disassembler, cmd_args=cmd_args,
                                 strategy="bfs").fire_lasers(
            transaction_count=tx_count)
        return json.loads(report.as_json())["issues"]
    finally:
        args.__dict__.update(saved)


def http_post(port: int, path: str, payload: dict,
              timeout: float = HTTP_TIMEOUT_S):
    body = json.dumps(payload).encode()
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, json.load(response)
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read() or b"{}")


def http_get(port: int, path: str, timeout: float = HTTP_TIMEOUT_S):
    """(status, body text) of a GET; error statuses are returned too."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()
