"""The serve daemon: a request queue in front of MythrilAnalyzer
(mythril_tpu.serve.daemon on the port's sources).

Request lifecycle:

  submit      admission under one lock: a draining daemon and a full queue
              answer `rejected` at once (bounded queue depth, not unbounded
              latency), and a per-tenant budget caps one tenant's share of
              the queue, so a flood tenant is the one that hears
              `overloaded`.
  batch       the worker pops up to MYTHRIL_GPU_SERVE_BATCH requests,
              round-robin across tenants in arrival order (fault site
              serve.admission: a fault in the fair ordering degrades to
              FIFO for the session, nothing dropped), and runs them as ONE
              interleaved cohort on the coordinator (service/interleave.py)
              with tenant-qualified origins. Their sibling solve queries
              park in the process-wide coalescing window and ride
              mixed-origin K1 streams.
  contexts    per-tenant engine contexts (service/tenancy.py) start warm:
              a tenant's memory tier, quick-sat deque, private blaster and
              prefix snapshots survive across its requests, so a repeat
              request records strictly fewer cdcl_settles. Cross-tenant
              reuse goes only through the replay-verified disk tier.
  deadlines   each batch runs on a dedicated deadline runner
              (resilience/deadline.new_runner; K1's dispatch runner nests
              inside it), bounded by the largest per-request deadline. A
              batch past it is abandoned (serve.worker `deadline`): its
              coordinator is cancelled, and the daemon waits for the
              abandoned body to end (every slot thread joined, the
              coordinator uninstalled) before anything else runs. So at
              most one batch's engine threads live at any time: an
              abandoned body cannot race its successor's launches through
              K1's calibration, the frontier's step buffers or K1's
              deadline runner, and a DeviceFault it meets on its way out
              is seen. Its unfinished requests then requeue once; a
              second failure answers `incomplete`.
  poisoning   serve.request (quarantine): a request that fails alone
              answers `error` by itself; batch siblings keep their
              findings.
  drain       SIGTERM: stop admitting, finish what was admitted, write
              the final heartbeat, stop the listener (serve_drain_wall).

Outcomes resolve when their batch ends, so a batch answers as one.

Differences from the JAX package (the port's rule for device faults):
a DeviceFault or NoDeviceError met inside a request is never quarantined
as that request's `error` and never settled on the host. The request and
every sibling of its batch answer `device_fault` with the fault's reason
(none answers `ok`, none is requeued), every queued request answers it
too, /healthz turns `ok: false` with the reason, the daemon stops
admitting, and serve_forever exits 2 after FAULT_LINGER_S. start()
resolves the device and builds every kernel of the path before the worker
starts (core.build_device_kernels), so no build runs inside a request's
or a dispatch's deadline; without a card and without --torch-device it
raises NoDeviceError.

Knobs (see README "Serve and the fleet"):
  MYTHRIL_GPU_SERVE_QUEUE_MAX      bounded queue depth (64)
  MYTHRIL_GPU_SERVE_TENANT_BUDGET  queued requests a tenant (8)
  MYTHRIL_GPU_SERVE_BATCH          requests an interleaved batch (4)
  MYTHRIL_GPU_SERVE_DEADLINE       a request's hard deadline, seconds (120)
  MYTHRIL_GPU_SERVE_DRAIN_TIMEOUT  drain wait before leftovers answer
                                   `incomplete`, seconds (60); also the
                                   wait for an abandoned batch to end
  MYTHRIL_GPU_SERVE_PORT           the CLI's listener port (8311)
"""

import hashlib
import json
import logging
import threading
import time
from typing import List, Optional

from mythril_tpu_torch.support.env import env_float

log = logging.getLogger(__name__)

QUEUE_MAX_ENV = "MYTHRIL_GPU_SERVE_QUEUE_MAX"
TENANT_BUDGET_ENV = "MYTHRIL_GPU_SERVE_TENANT_BUDGET"
BATCH_ENV = "MYTHRIL_GPU_SERVE_BATCH"
DEADLINE_ENV = "MYTHRIL_GPU_SERVE_DEADLINE"
DRAIN_TIMEOUT_ENV = "MYTHRIL_GPU_SERVE_DRAIN_TIMEOUT"
PORT_ENV = "MYTHRIL_GPU_SERVE_PORT"

DEFAULT_QUEUE_MAX = 64
DEFAULT_TENANT_BUDGET = 8
DEFAULT_BATCH = 4
DEFAULT_DEADLINE_S = 120.0
DEFAULT_DRAIN_TIMEOUT_S = 60.0
DEFAULT_PORT = 8311

# how long serve_forever keeps the listener up after a device fault, so a
# probe of /healthz reads the reason, before it drains and exits 2
FAULT_LINGER_S = 5.0


def _env_int(name: str, default: int) -> int:
    return max(1, int(env_float(name, default)))


class ServeRequest:
    """One tenant's analysis request, resolved to one terminal outcome:

      {"status": "ok", "issues": [...], "exceptions": [...], ...}
      {"status": "error", "reason": ...}         a poisoned request, alone
      {"status": "rejected", "reason": "overloaded" | "draining" | ...}
      {"status": "incomplete", "reason": ...}    answered, never hung
      {"status": "device_fault", "reason": ...}  the device path failed
    """

    _seq = [0]
    _seq_lock = threading.Lock()

    def __init__(self, tenant: str, code: str, name: Optional[str] = None,
                 tx_count: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 bin_runtime: bool = False,
                 modules: Optional[List[str]] = None):
        with self._seq_lock:
            self._seq[0] += 1
            self.request_id = self._seq[0]
        self.tenant = str(tenant)
        self.code = code
        self.name = name
        self.tx_count = tx_count
        self.deadline_s = deadline_s
        self.bin_runtime = bin_runtime
        self.modules = modules
        # tenant-qualified, content-addressed origin: the same tenant
        # sending the same bytecode reuses its warm tiers; two tenants
        # never share one. The tenant id is colon-escaped, so
        # origin_in_session's first-colon split cannot be fooled
        from mythril_tpu_torch.service.tenancy import encode_session

        digest = hashlib.sha256(code.encode()).hexdigest()[:12]
        self.origin = f"{encode_session(self.tenant)}:{digest}"
        self.contract = None          # built at admission
        self.requeues = 0
        self.submitted_at = None      # monotonic, set at admission
        self.wait_s = None            # queue wait, set when its batch pops
        self.result: Optional[dict] = None  # the analysis's outcome, held
        self.outcome: Optional[dict] = None  # until its batch ends
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def resolve(self, outcome: dict) -> bool:
        """The first resolve wins; returns whether this call resolved (a
        terminal stat is counted only then)."""
        if self._done.is_set():
            return False
        outcome.setdefault("request_id", self.request_id)
        outcome.setdefault("tenant", self.tenant)
        if self.wait_s is not None:
            outcome.setdefault("wait_s", round(self.wait_s, 4))
        self.outcome = outcome
        self._done.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> Optional[dict]:
        self._done.wait(timeout)
        return self.outcome


class ServeDaemon:
    def __init__(self, tx_count: int = 1,
                 modules: Optional[List[str]] = None,
                 http_port: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 tenant_budget: Optional[int] = None,
                 batch_max: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        self.tx_count = tx_count
        self.modules = modules
        self.http_port = http_port   # None: no listener (in-process API)
        self.port = None             # the bound port, set by start()
        self.queue_max = queue_max or _env_int(QUEUE_MAX_ENV,
                                               DEFAULT_QUEUE_MAX)
        self.tenant_budget = tenant_budget or _env_int(
            TENANT_BUDGET_ENV, DEFAULT_TENANT_BUDGET)
        self.batch_max = batch_max or _env_int(BATCH_ENV, DEFAULT_BATCH)
        self.deadline_s = deadline_s or env_float(DEADLINE_ENV,
                                                  DEFAULT_DEADLINE_S)
        self.drain_timeout_s = env_float(DRAIN_TIMEOUT_ENV,
                                         DEFAULT_DRAIN_TIMEOUT_S)
        self._cv = threading.Condition()
        self._queue: List[ServeRequest] = []   # arrival order
        self._inflight: List[ServeRequest] = []
        self._evicting: set = set()            # sessions mid-eviction
        self._draining = False
        self._stopping = False
        # why the daemon stopped serving and its health status then:
        # `device_fault`, or `stopped` after an abandoned batch that did
        # not end; serve_forever exits 2 on either
        self.fault: Optional[str] = None
        self.fault_status: Optional[str] = None
        self.drained = threading.Event()
        self._wake = threading.Event()   # drained, or a fault
        self._worker: Optional[threading.Thread] = None
        self._runner = None
        self._templates = None
        self._heartbeat = None
        self._http = None
        self._analyzer = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeDaemon":
        """Resolve the device and build the path's kernels, warm the engine
        plumbing once, and start the worker and the listener."""
        from mythril_tpu_torch import core
        from mythril_tpu_torch.core import MythrilAnalyzer, MythrilDisassembler
        from mythril_tpu_torch.gpu.device import resolve_device
        from mythril_tpu_torch.observe import flightrec, metrics
        from mythril_tpu_torch.resilience import deadline as deadline_mod
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.service import tenancy
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
        from mythril_tpu_torch.support.args import args

        if args.solver_backend == "gpu":
            # NoDeviceError without a card and without a device named; a
            # kernel that does not build raises here, before any request
            if resolve_device(args.torch_device).type == "cuda":
                core.build_device_kernels()
        core.reset_engine_state()
        stats = SolverStatistics()
        stats.enabled = True
        faults.configure_from_env(getattr(args, "inject_fault", None))
        flightrec.install()
        self._heartbeat = metrics.start_heartbeat(
            getattr(args, "heartbeat", None))
        # pristine module templates captured once: batch N's contexts must
        # never inherit batch N-1's module state
        self._templates = tenancy.capture_module_templates()
        self._analyzer = MythrilAnalyzer(MythrilDisassembler())
        self._runner = deadline_mod.new_runner()
        self._worker = threading.Thread(
            target=self._worker_loop, name="mythril-serve-worker",
            daemon=True)
        self._worker.start()
        if self.http_port is not None:
            from mythril_tpu_torch.serve.httpd import ServeHTTP

            self._http = ServeHTTP(self, self.http_port)
            self._http.start()
            self.port = self._http.port
        log.info("serve daemon up: queue_max=%d tenant_budget=%d batch=%d "
                 "deadline=%.0fs port=%s", self.queue_max,
                 self.tenant_budget, self.batch_max, self.deadline_s,
                 self.port)
        return self

    # -- admission -----------------------------------------------------------

    def submit(self, tenant: str, code: str, name: Optional[str] = None,
               tx_count: Optional[int] = None,
               deadline_s: Optional[float] = None,
               bin_runtime: bool = False,
               modules: Optional[List[str]] = None) -> ServeRequest:
        """Admit or reject one request. The request returned always
        resolves; a rejected one already has."""
        from mythril_tpu_torch.service.tenancy import origin_in_session
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        request = ServeRequest(tenant, code, name=name, tx_count=tx_count,
                               deadline_s=deadline_s,
                               bin_runtime=bin_runtime, modules=modules)
        stats = SolverStatistics()
        # parsed before the lock: malformed bytecode is answered now, and a
        # large disassembly does not hold up other admissions
        try:
            request.contract = self._build_contract(request)
        except Exception as error:
            stats.add_serve_admission(False)
            request.resolve({"status": "rejected",
                             "reason": f"bad request: {error}"})
            return request
        with self._cv:
            reason = None
            if self.fault_status is not None:
                reason = self.fault_status
            elif self._draining or self._stopping:
                reason = "draining"
            elif any(origin_in_session(request.origin, session)
                     for session in self._evicting):
                # the tenant's memos are mid-eviction: a live context's
                # save/restore could reinstall them
                reason = "evicting"
            elif len(self._queue) + len(self._inflight) >= self.queue_max:
                reason = "overloaded"
            elif sum(1 for r in self._queue + self._inflight
                     if r.tenant == request.tenant) >= self.tenant_budget:
                reason = "overloaded"
            if reason is not None:
                stats.add_serve_admission(False)
                request.resolve({"status": "rejected", "reason": reason})
                return request
            request.submitted_at = time.monotonic()
            stats.add_serve_admission(True)
            self._queue.append(request)
            self._cv.notify_all()
        return request

    @staticmethod
    def _build_contract(request: ServeRequest):
        from mythril_tpu_torch.ethereum.evmcontract import EVMContract

        name = request.name or "MAIN"
        if request.bin_runtime:
            return EVMContract(code=request.code, name=name)
        return EVMContract(creation_code=request.code, name=name)

    # -- batching ------------------------------------------------------------

    def _next_batch(self) -> List[ServeRequest]:
        """Pop the next cross-request batch (the caller holds the lock).

        Tenants rotate in the arrival order of their oldest queued
        request, one request a tenant a round. Two requests of one origin
        (same tenant, same bytecode) never share a batch: their warm
        context is one object. Fault site serve.admission (disable): a
        fault in the fair ordering degrades to FIFO for the session."""
        from mythril_tpu_torch import resilience
        from mythril_tpu_torch.resilience import maybe_inject

        batch: List[ServeRequest] = []
        if not resilience.fuse_blown("serve.admission"):
            try:
                maybe_inject("serve.admission")
                tenants: List[str] = []
                for request in self._queue:
                    if request.tenant not in tenants:
                        tenants.append(request.tenant)
                taken = set()
                progressed = True
                while len(batch) < self.batch_max and progressed:
                    progressed = False
                    for tenant in tenants:
                        if len(batch) >= self.batch_max:
                            break
                        for request in self._queue:
                            if id(request) in taken \
                                    or request.tenant != tenant:
                                continue
                            if any(request.origin == b.origin
                                   for b in batch):
                                continue
                            batch.append(request)
                            taken.add(id(request))
                            progressed = True
                            break
            except Exception:
                resilience.note_stage_failure("serve.admission")
                batch = []
        if not batch:
            # FIFO (the degradation, and the one-tenant case), distinct
            # origins a batch
            for request in self._queue:
                if len(batch) >= self.batch_max:
                    break
                if any(request.origin == b.origin for b in batch):
                    continue
                batch.append(request)
        for request in batch:
            self._queue.remove(request)
            self._inflight.append(request)
        return batch

    # -- worker --------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait(0.2)
                if self._stopping and not self._queue:
                    return
                batch = self._next_batch()
            if batch:
                try:
                    self._execute_batch(batch)
                finally:
                    with self._cv:
                        for request in batch:
                            if request in self._inflight:
                                self._inflight.remove(request)
                        self._cv.notify_all()

    def _execute_batch(self, batch: List[ServeRequest]) -> None:
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
        from mythril_tpu_torch.resilience import deadline as deadline_mod
        from mythril_tpu_torch.resilience import record_event
        from mythril_tpu_torch.resilience.deadline import (
            StageDeadlineExceeded,
        )
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        now = time.monotonic()
        for request in batch:
            if request.submitted_at is not None and request.wait_s is None:
                request.wait_s = now - request.submitted_at
                stats.add_serve_wait_seconds(request.wait_s)
        deadline = max((r.deadline_s or self.deadline_s) for r in batch)
        shared = {"lock": threading.Lock(), "cancelled": False,
                  "coordinator": None, "entered": False,
                  "exited": threading.Event(), "failure": None}

        def body():
            from mythril_tpu_torch.resilience import maybe_inject

            # the serve.worker crossing sits before any engine state is
            # touched: an injected hang wedges the runner here, and the
            # body, abandoned, returns when it wakes
            maybe_inject("serve.worker")
            self._run_batch_body(batch, shared)

        try:
            self._runner.call(body, deadline)
        except StageDeadlineExceeded:
            record_event("serve.worker", "deadline")
            log.warning("serve batch exceeded its %.1fs deadline; "
                        "abandoning it", deadline)
            self._runner = deadline_mod.new_runner()
            self._settle_abandoned(batch, shared, "deadline")
        except (DeviceFault, NoDeviceError) as error:
            self._device_fault(batch, error)
        except Exception as error:
            log.warning("serve batch failed (%r); requeueing its "
                        "unfinished requests once", error)
            self._settle_abandoned(batch, shared, repr(error))
        else:
            self._resolve_results(batch)
            self._requeue_or_incomplete(batch, "no result")
        finally:
            self._teardown_batch()

    def _abandon(self, shared: dict) -> bool:
        """Stop an abandoned batch and wait for its body to end: the cancel
        flag keeps the body from starting slots, Coordinator.cancel()
        raises BatchCancelled at every slot's next yield point (a K1
        dispatch returns within its own hard deadline), and the body
        joins its slots and uninstalls its coordinator before it sets
        `exited`. False when the body did not end within the drain
        timeout."""
        with shared["lock"]:
            shared["cancelled"] = True
            coordinator = shared["coordinator"]
            entered = shared["entered"]
        if coordinator is not None:
            coordinator.cancel()
        return not entered or shared["exited"].wait(self.drain_timeout_s)

    def _settle_abandoned(self, batch, shared, reason: str) -> None:
        """Abandon the batch and, once its body has ended, answer it: a
        DeviceFault the body met is the batch's answer; otherwise the
        finished requests keep their results and the others requeue once.
        A body that does not end stops the daemon rather than let a batch
        run beside it."""
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError

        if not self._abandon(shared):
            self._stop_serving(
                f"an abandoned batch did not end within "
                f"{self.drain_timeout_s:.0f}s", "incomplete", batch)
            return
        failure = shared["failure"]
        if isinstance(failure, (DeviceFault, NoDeviceError)):
            self._device_fault(batch, failure)
            return
        self._resolve_results(batch)
        self._requeue_or_incomplete(batch, reason)

    def _run_batch_body(self, batch: List[ServeRequest],
                        shared: dict) -> None:
        """Run one admitted batch as an interleaved cohort (on the
        dedicated runner thread). A one-request batch rides the same
        coordinator: the same isolation and code path, no sibling."""
        from mythril_tpu_torch.service import interleave
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
        from mythril_tpu_torch.support.time_handler import time_handler

        coordinator = interleave.Coordinator(
            [(idx, request.contract) for idx, request in enumerate(batch)],
            origins=[request.origin for request in batch],
            warm=True, module_templates=self._templates)
        with shared["lock"]:
            if shared["cancelled"]:
                return
            shared["coordinator"] = coordinator
            shared["entered"] = True
        SolverStatistics().add_serve_batch(
            len(batch), len({r.tenant for r in batch}))
        analyze_one = self._make_analyze_one(batch)
        threads = []
        interleave.install(coordinator)
        try:
            for slot_id in range(len(batch)):
                with shared["lock"]:
                    if shared["cancelled"]:
                        break
                    thread = threading.Thread(
                        target=coordinator.run_slot,
                        args=(slot_id, analyze_one),
                        name=f"mythril-serve-slot-{slot_id}")
                    thread.start()
                threads.append(thread)
            for thread in threads:
                thread.join()
        finally:
            # compare-and-swap: a newer batch's coordinator stays
            interleave.uninstall(keep_tenancy=True, expected=coordinator)
            # no budget outlives the batch (the daemon calls
            # _analyze_one_contract, not fire_lasers, whose finally ends it)
            time_handler.start_execution(None)
            shared["failure"] = coordinator.failure
            shared["exited"].set()
        if coordinator.failure is not None:
            raise coordinator.failure

    def _make_analyze_one(self, batch: List[ServeRequest]):
        def analyze_one(idx, contract):
            self._analyze_request(batch[idx])

        return analyze_one

    def _analyze_request(self, request: ServeRequest) -> None:
        """One request, inside its own engine context (the coordinator
        installed it). Fault site serve.request (quarantine): a host
        failure answers `error` for this request alone. A DeviceFault or
        NoDeviceError propagates: the slot records it as the
        coordinator's failure and the siblings are cancelled."""
        from mythril_tpu_torch import resilience
        from mythril_tpu_torch.analysis.report import Report
        from mythril_tpu_torch.gpu.device import DeviceFault, NoDeviceError
        from mythril_tpu_torch.resilience import maybe_inject
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics
        from mythril_tpu_torch.support.time_handler import time_handler

        stats = SolverStatistics()
        settles_before = stats.cdcl_settles
        memory_before = stats.memory_hits + stats.quick_sat_hits
        try:
            maybe_inject("serve.request")
            issues, exceptions = self._analyzer._analyze_one_contract(
                request.contract, request.modules or self.modules,
                request.tx_count or self.tx_count, stats=stats)
            report = Report(contracts=[request.contract],
                            exceptions=exceptions)
            for issue in issues:
                report.append_issue(issue)
            request.result = {
                "status": "ok",
                "issues": json.loads(report.as_json())["issues"],
                "exceptions": list(exceptions),
                "origin": request.origin,
                # settle and memo deltas of this request (exact for a
                # one-request batch; a mixed batch folds its siblings'
                # settles in)
                "cdcl_settles": stats.cdcl_settles - settles_before,
                "memo_hits": (stats.memory_hits + stats.quick_sat_hits
                              - memory_before),
            }
        except (DeviceFault, NoDeviceError):
            raise
        except Exception as error:
            resilience.record_event("serve.request", "quarantine")
            log.warning("request %d (tenant %s) poisoned: %r; failing it "
                        "alone", request.request_id, request.tenant, error)
            request.result = {"status": "error", "reason": repr(error)}
        finally:
            time_handler.start_execution(None)

    @staticmethod
    def _resolve_results(batch: List[ServeRequest]) -> None:
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        for request in batch:
            if request.result is not None and request.resolve(
                    dict(request.result)):
                stats.add_serve_outcome("completed")

    def _requeue_or_incomplete(self, batch: List[ServeRequest],
                               reason: str) -> None:
        """Every unfinished request of a failed batch goes round once more
        (a fresh batch, a fresh runner); one that already failed a batch
        answers `incomplete`."""
        from mythril_tpu_torch.resilience import record_event
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        for request in batch:
            if request.done:
                continue
            if request.requeues == 0 and not self._stopping:
                request.requeues += 1
                record_event("serve.worker", "worker_requeue")
                stats.add_serve_outcome("requeued")
                with self._cv:
                    if request in self._inflight:
                        self._inflight.remove(request)
                    self._queue.insert(0, request)
                    self._cv.notify_all()
            elif request.resolve({"status": "incomplete",
                                  "reason": reason}):
                record_event("serve.worker", "degraded")
                stats.add_serve_outcome("incomplete")

    def _device_fault(self, batch: List[ServeRequest],
                      error: BaseException) -> None:
        """The port's rule: the batch that met a device fault, and every
        queued request, answer `device_fault`; none answers `ok`, none is
        requeued, and the daemon stops serving."""
        log.error("serve batch met a device fault; the daemon stops: %s",
                  error)
        self._stop_serving(f"device fault: {error}", "device_fault", batch)

    def _stop_serving(self, reason: str, status: str,
                      batch: List[ServeRequest]) -> None:
        """Stop admitting and answer `batch` and the queue with `status`
        (`device_fault` or `incomplete`)."""
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        with self._cv:
            if self.fault is None:
                self.fault = reason
                self.fault_status = ("device_fault"
                                     if status == "device_fault"
                                     else "stopped")
            self._draining = True
            self._stopping = True
            leftovers = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        stats = SolverStatistics()
        for request in list(batch) + leftovers:
            if request.resolve({"status": status, "reason": reason}):
                stats.add_serve_outcome("incomplete")
        self._wake.set()

    @staticmethod
    def _teardown_batch() -> None:
        """Resolve every handle a failed batch left parked in the
        process-wide coalescing window (to unknown), so nothing the next
        batch does waits on a handle nobody will flush."""
        from mythril_tpu_torch.service.scheduler import get_scheduler

        scheduler = get_scheduler()
        if scheduler.pending():
            log.warning("unwinding %d parked scheduler handle(s) of a "
                        "failed serve batch", scheduler.pending())
            scheduler.clear()

    # -- eviction ------------------------------------------------------------

    def evict_tenant(self, tenant: str, wait_timeout: float = 60.0) -> bool:
        """Session-scoped invalidation: drop one tenant's warm memos
        (memory tiers, quick-sat deques, blasters, prefix snapshots) and
        nothing shared. Waits for the tenant's own queued and in-flight
        requests first (a live context's save/restore would reinstall the
        memos). False when the tenant stayed busy past the wait."""
        from mythril_tpu_torch.service.tenancy import (
            encode_session,
            origin_in_session,
        )
        from mythril_tpu_torch.support.model import clear_caches

        session = encode_session(tenant)
        deadline = time.monotonic() + wait_timeout
        with self._cv:
            while any(origin_in_session(request.origin, session)
                      for request in self._queue + self._inflight):
                if time.monotonic() >= deadline:
                    return False
                self._cv.wait(0.2)
            # close admission before the lock is released: a submit landing
            # between the check and the clear would run a live context
            self._evicting.add(session)
        try:
            clear_caches(session=session)
        finally:
            with self._cv:
                self._evicting.discard(session)
                self._cv.notify_all()
        return True

    # -- health and drain ----------------------------------------------------

    def healthz(self) -> dict:
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        stats = SolverStatistics()
        with self._cv:
            queued, inflight = len(self._queue), len(self._inflight)
            draining = self._draining or self._stopping
            fault, fault_status = self.fault, self.fault_status
        if fault is not None:
            status = fault_status
        else:
            status = "draining" if draining else "ok"
        return {
            "status": status,
            "ok": status == "ok",
            "reason": fault,
            "queued": queued,
            "in_flight": inflight,
            "queue_max": self.queue_max,
            "requests": {
                "admitted": stats.serve_requests_admitted,
                "rejected": stats.serve_requests_rejected,
                "requeued": stats.serve_requests_requeued,
                "incomplete": stats.serve_requests_incomplete,
                "completed": stats.serve_requests_completed,
            },
        }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting, finish what was admitted,
        write the final heartbeat, stop the listener. True on a clean
        drain; on timeout the leftovers answer `incomplete`."""
        from mythril_tpu_torch.smt.solver.statistics import SolverStatistics

        start = time.monotonic()
        budget = timeout if timeout is not None else self.drain_timeout_s
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        clean = True
        with self._cv:
            while self._queue or self._inflight:
                if time.monotonic() - start >= budget:
                    clean = False
                    break
                self._cv.wait(0.2)
            self._stopping = True
            self._cv.notify_all()
        if not clean:
            with self._cv:
                leftovers = list(self._queue) + list(self._inflight)
                self._queue.clear()
            stats = SolverStatistics()
            for request in leftovers:
                if request.resolve({"status": "incomplete",
                                    "reason": "drain timeout"}):
                    stats.add_serve_outcome("incomplete")
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        SolverStatistics().add_serve_drain_seconds(time.monotonic() - start)
        if self._heartbeat is not None:
            self._heartbeat.stop(final=True)
            self._heartbeat = None
        if self._http is not None:
            self._http.stop()
            self._http = None
        self.drained.set()
        self._wake.set()
        log.info("serve daemon drained in %.2fs (clean=%s)",
                 time.monotonic() - start, clean)
        return clean


def install_signal_handlers(daemon) -> None:
    """SIGTERM and SIGINT drain (main thread only)."""
    import signal

    def _handler(_signum, _frame):
        threading.Thread(target=daemon.drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def wait_until_stopped(daemon: ServeDaemon) -> int:
    """Block until the daemon drained (0) or stopped serving (2). After a
    device fault the listener keeps answering for FAULT_LINGER_S, so a
    probe of /healthz reads the reason, and then the daemon drains."""
    daemon._wake.wait()
    if daemon.fault is not None:
        log.error("serve daemon stopped: %s", daemon.fault)
        time.sleep(FAULT_LINGER_S)
        daemon.drain()
        return 2
    daemon.drained.wait()
    return 0


def serve_forever(daemon: ServeDaemon) -> int:
    """CLI entry: start, announce the endpoints, block until drained (0)
    or stopped on a device fault (2)."""
    daemon.start()
    install_signal_handlers(daemon)
    print(f"mythril_tpu_torch serve listening on "
          f"http://127.0.0.1:{daemon.port} (POST /analyze, POST /evict, "
          f"GET /healthz, GET /metrics); SIGTERM drains", flush=True)
    return wait_until_stopped(daemon)
