"""Query-count/time singleton (reference laser/smt/solver/solver_statistics.py).

The counters of mythril_tpu.smt.solver.statistics that the port's solve
path touches, under the same names; the Pallas launch counters are named
kernel_* here (one CUDA kernel launch per ragged round). as_dict() is the
stats JSON of core.MythrilAnalyzer (MYTHRIL_GPU_STATS_JSON), with the
JAX package's sections: device, roofline, resilience, kernel_backend,
trace_spans and the per-opcode interpreter wall."""


class SolverStatistics:
    _instance = None

    # every counter the singleton tracks; used by reset/as_dict so a new
    # counter only has to be added in one place
    _COUNTERS = (
        "query_count",
        "batch_query_count",
        # queries that reached the batched device solver, and those it
        # found a host-verified model for
        "device_batch_queries",
        "device_batch_hits",
        "device_ineligible",
        # cones the router turned away from the device (the CDCL settles
        # them); _floor: ones inside the level x cell floor the router
        # promises to admit — must stay 0
        "cap_rejects",
        "cap_rejects_floor",
        # router decisions (gpu/router.py): cones sent straight to the
        # host CDCL, ragged launches with the cones they carried (slots
        # == cones: a stream pads no query axis), and the clause volume
        # of the queries that reached the router
        "router_host_direct",
        # cones the bucketed path's evidence slot cap trimmed from a
        # dispatch (big enough for the device; the evidence budget was not)
        "router_slot_overflow",
        # dispatches whose loop stopped at the window's device budget with
        # streams or buckets still to launch (the host CDCL settles those)
        "router_deadline_stops",
        "device_dispatches",
        "device_dispatched_queries",
        "device_slots",
        "router_dispatched_clauses",
        "crosscheck_runs",
        "crosscheck_cap_skips",
        # result tiers (support/model.py): the in-memory term-keyed tier,
        # the recent-model quick-sat probe, and the persistent disk tier
        # (service/store.py: lookups that hit or missed, entries written,
        # entries rejected by the replay check or quarantined)
        "memory_hits",
        "quick_sat_hits",
        "persistent_hits",
        "persistent_misses",
        "persistent_stores",
        "persistent_verify_rejects",
        # coalescing scheduler windows (service/scheduler.py)
        "window_flushes",
        "coalesced_queries",
        # real host-CDCL solver invocations and the clauses they processed
        "cdcl_settles",
        "cdcl_clauses",
        # pre-analysis (preanalysis/): CNF unit propagation, pure
        # literals and clauses removed; instances the settle split into
        # components
        "cnf_units_propagated",
        "cnf_pure_literals",
        "cnf_clauses_removed",
        "cnf_components_split",
        # propagation rounds of the preprocessed instances (one pass over
        # every literal each)
        "cnf_prep_rounds",
        # the AIG rewrite (preanalysis/aig_opt.py): cone sizes before and
        # after, what each pass removed, the components of the rewritten
        # cones, and the components that rode a device launch alone
        "aig_nodes_before",
        "aig_nodes_after",
        "aig_strash_merges",
        "aig_const_folds",
        "aig_trivial_unsat",
        "aig_components",
        "aig_device_components",
        # components K1 found a model for, and non-trivial components
        # the router planned for its in-router host settle
        "aig_device_component_hits",
        "aig_host_components",
        # queries the router returned a model for: every non-trivial part
        # found by K1 (device_found), at least one component settled on
        # the host CDCL inside the router (host_settled), or every
        # component all-unit (trivial_settled); the three sum to
        # device_batch_hits
        "router_device_found",
        "router_host_settled",
        "router_trivial_settled",
        # incremental preparation (smt/solver/incremental.py): simplify
        # memo hits, prefix resumes (with their summed suffix terms),
        # guarded fallbacks, and gates reused from sibling queries by the
        # session strash table
        "prepare_incremental_hits",
        "prepare_prefix_resumes",
        "prepare_prefix_fallbacks",
        "prepare_suffix_terms",
        "strash_xquery_merges",
        # ragged streams (one kernel round loop per stream), the cones
        # they carried and the assembled stream bytes
        "ragged_windows",
        "ragged_cones_packed",
        "paged_stream_bytes",
        # corpus runs (service/interleave.py): streams whose cones came
        # from two or more contracts and the cones they carried, and disk
        # tier hits served to another contract than the one that stored
        # the entry
        "xcontract_windows",
        "xcontract_cones_packed",
        "xcontract_dedup_hits",
        # the cube-and-conquer second pass: cubes shipped as pinned
        # replicas, and cubes that came back modelless
        "cubes_dispatched",
        "cube_device_refutes",
        # ragged-round kernel launches (gpu/ragged_kernel.py) and the
        # block-aligned gate cells they stepped
        "kernel_launches",
        "kernel_cells_stepped",
        # distinct kernel builds after the process's first: 0 here, since
        # K1, K2 and K3 each build once and take every shape at run time
        "kernel_recompiles",
        # the fork lane: pairs the router tried to pack as one shared cone
        # and pairs it did, and launches that carried fork-side cones
        "fork_pair_pack_attempts",
        "fork_pair_pack_hits",
        "fork_stream_dispatches",
        # resilience events (resilience/): retries, breaker trips and
        # half-open re-probes, quarantined cache entries, degraded stages,
        # hard-deadline trips of K1's dispatch, stale lock breaks and
        # injected faults; the per-site breakdown is the stats JSON
        # "resilience" section
        "resilience_retries",
        "resilience_breaker_trips",
        "resilience_breaker_probes",
        "resilience_quarantines",
        "resilience_degraded",
        "resilience_deadline_trips",
        "resilience_stale_lock_breaks",
        "resilience_faults_injected",
        # requeues of a --jobs pool whose worker died with contracts in
        # flight (core.py): one a requeue
        "resilience_worker_requeues",
        # calls guarded by the deadline runner (resilience/deadline.py)
        "deadline_runner_calls",
        # the serve daemon (serve/daemon.py): admission outcomes, the
        # cross-request batches with the requests and distinct tenants
        # each carried (behind the serve_tenant_window_share gauge), and
        # the requests requeued, answered incomplete and completed
        "serve_requests_admitted",
        "serve_requests_rejected",
        "serve_requests_requeued",
        "serve_requests_incomplete",
        "serve_requests_completed",
        "serve_batches",
        "serve_batch_requests",
        "serve_batch_tenants",
        # the sharded fleet (fleet/): routing decisions, requests re-routed
        # to a surviving shard, crash-only shard restarts, and the shared
        # network tier's entries served, stored and quarantined on read
        "fleet_shard_routes",
        "fleet_requeues",
        "fleet_shard_restarts",
        "net_tier_hits",
        "net_tier_stores",
        "net_tier_verify_rejects",
        # the engine (laser/svm.py, analysis/module/loader.py): detection
        # modules the static reachability gate skipped, fork-prune solves
        # skipped on inert cones, and fork sides pruned on a drained
        # solver verdict
        "modules_gated",
        "queries_avoided",
        # the batched frontier (laser/frontier/): steps, the states they
        # carried and the batch slots (equal on every backend: no step
        # pads), and the states handed back to the per-state interpreter
        # at a batch-capable site — mid-run bails (frontier_batch_bails,
        # a subset) plus rows whose run CUT at an unforked JUMPI /
        # unpromoted RETURN/STOP/CALLDATALOAD and handoffs at lane-capable
        # sites the configuration left unbatched. Always the sum of the
        # per-reason breakdown:
        #   dialect   the batch dialect ends here (cut-at-JUMPI rows with
        #             forking off, cut-at-RETURN/STOP rows with the
        #             symbolic lane off, handoffs at minimal fork sites)
        #   dynamic   mid-run bails (memory beyond the dense window, gas)
        #             and non-symbolic refusals at minimal sites
        #   hook      rows bailed so a conditionally-transparent hook
        #             fires per-state
        #   symbolic  an opaque value where a concrete one is needed,
        #             including cut-at-CALLDATALOAD rows with the lane off
        "frontier_vmap_steps",
        "frontier_states_stepped",
        "frontier_fallback_exits",
        "frontier_fallback_dialect",
        "frontier_fallback_dynamic",
        "frontier_fallback_hook",
        "frontier_fallback_symbolic",
        "frontier_batch_bails",
        "frontier_batch_slots",
        # rows decoded by the symbolic lane's structural replay
        "frontier_symlane_rows",
        # batched symbolic-JUMPI forks: fork steps, the rows that split,
        # materialized successors beyond one per forked row, and sides
        # masked dead on a host-CDCL UNSAT verdict
        "frontier_forks",
        "frontier_fork_rows",
        "frontier_fork_cohort_rows",
        "frontier_fork_infeasible_pruned",
    )
    _TIMERS = (
        "solver_time",
        "route_device_seconds",
        "route_host_seconds",
        "prepare_wall",
        "settle_wall",
        "crosscheck_wall",
        # the interpreter's share of LaserEVM.exec (solver seconds inside
        # instruction handlers subtracted)
        "interp_wall",
        # the batched fork epilogue (pending conditions, the coalesced
        # feasibility bundle, cohort materialization)
        "frontier_fork_wall",
        # the deadline runner's queue hand-offs: each guarded call's wall
        # less the call's own wall on the runner thread
        "deadline_handoff_wall",
        # the serve daemon: summed queue wait of admitted requests, and
        # the drain (stop admitting to the final heartbeat)
        "serve_admission_wall",
        "serve_drain_wall",
    )
    # resilience event name -> the counter it rolls up into
    _RESILIENCE_EVENT_COUNTERS = {
        "retry": "resilience_retries",
        "breaker_trip": "resilience_breaker_trips",
        "breaker_probe": "resilience_breaker_probes",
        "quarantine": "resilience_quarantines",
        "degraded": "resilience_degraded",
        "deadline": "resilience_deadline_trips",
        "stale_break": "resilience_stale_lock_breaks",
        "injected": "resilience_faults_injected",
        "worker_requeue": "resilience_worker_requeues",
    }

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enabled = False
            for name in cls._COUNTERS:
                setattr(cls._instance, name, 0)
            for name in cls._TIMERS:
                setattr(cls._instance, name, 0.0)
            # suffix-length histogram of prefix resumes, opcode ->
            # [count, seconds] over the per-state interpreter, and fault
            # site -> {event: count}: not scalars, so reset and as_dict
            # handle them apart
            cls._instance.prepare_suffix_hist = {}
            cls._instance.interp_opcode_wall = {}
            cls._instance.resilience_events = {}
        return cls._instance

    def _add(self, name: str, count=1) -> None:
        if self.enabled:
            setattr(self, name, getattr(self, name) + count)

    def add_query(self, seconds: float) -> None:
        if self.enabled:
            self.query_count += 1
            self.solver_time += seconds

    def add_batch(self, num_queries: int, seconds: float) -> None:
        """One get_models_batch call covering num_queries sibling queries."""
        if self.enabled:
            self.batch_query_count += num_queries
            self.solver_time += seconds

    def add_device_batch_query(self, hit: bool) -> None:
        """A query that reached the batched device solver (hit = model
        found on device; miss = CDCL settled it)."""
        if self.enabled:
            self.device_batch_queries += 1
            if hit:
                self.device_batch_hits += 1

    def add_device_ineligible(self) -> None:
        """A query that could not take the device path (empty clause)."""
        self._add("device_ineligible")

    def add_cap_reject(self, count: int = 1,
                       under_floor: bool = False) -> None:
        """A cone the router turned away from the device, settled by the
        CDCL instead; `under_floor` marks one inside the admission floor."""
        if self.enabled:
            self.cap_rejects += count
            if under_floor:
                self.cap_rejects_floor += count

    def add_host_direct(self, count: int = 1) -> None:
        """A cone the router sent straight to the host CDCL (too shallow
        to be worth a device slot)."""
        self._add("router_host_direct", count)

    def add_router_deadline_stop(self) -> None:
        """A dispatch loop stopped at the window's device budget with
        streams or buckets left, which the host CDCL then settles."""
        self._add("router_deadline_stops", 1)

    def add_slot_overflow(self, count: int = 1) -> None:
        """Device-worthy cones trimmed from a bucketed dispatch by the
        evidence-mode slot cap, settled by the host CDCL."""
        self._add("router_slot_overflow", count)

    def add_device_dispatch(self, queries: int, slots: int,
                            seconds: float) -> None:
        """One device launch sequence (a ragged stream, or a bucketed
        dispatch whose query axis pads to `slots`) carrying `queries`
        cones in `slots` slots."""
        if self.enabled:
            self.device_dispatches += 1
            self.device_dispatched_queries += queries
            self.device_slots += slots
            self.route_device_seconds += seconds

    def add_router_clauses(self, clauses: int) -> None:
        """CNF clause volume of a query reaching the device router."""
        self._add("router_dispatched_clauses", clauses)

    def add_host_route_seconds(self, seconds: float) -> None:
        self._add("route_host_seconds", seconds)

    def add_crosscheck(self, skipped: bool) -> None:
        """A detection-path UNSAT verdict's second opinion: ran, or was
        skipped by CROSSCHECK_CLAUSE_CAP."""
        self._add("crosscheck_cap_skips" if skipped else "crosscheck_runs")

    def add_memory_hit(self) -> None:
        """A query settled by the in-memory term-keyed result tier."""
        self._add("memory_hits")

    def add_quick_sat_hit(self) -> None:
        """A query settled by the recent-model quick-sat probe."""
        self._add("quick_sat_hits")

    def add_persistent_lookup(self, hit: bool) -> None:
        """A disk-tier probe of a blasted instance fingerprint. A
        verify-rejected or provenance-rejected entry counts as a miss (the
        caller also records the reject)."""
        self._add("persistent_hits" if hit else "persistent_misses")

    def add_persistent_store(self) -> None:
        """One entry written to the disk tier."""
        self._add("persistent_stores")

    def add_persistent_verify_reject(self) -> None:
        """A disk-tier entry that failed its replay check against the
        original constraints, or was quarantined as malformed: a safe
        miss, never a verdict."""
        self._add("persistent_verify_rejects")

    def add_window_flush(self, queries: int) -> None:
        """One coalescing-scheduler flush covering `queries` buffered
        queries (service/scheduler.py)."""
        if self.enabled:
            self.window_flushes += 1
            self.coalesced_queries += queries

    def add_cdcl_settle(self, clauses: int = 0,
                        seconds: float = 0.0) -> None:
        """One real host-CDCL solver invocation (sat_backend terminal
        solve)."""
        if self.enabled:
            self.cdcl_settles += 1
            self.cdcl_clauses += clauses
            self.settle_wall += seconds

    def add_deadline_handoff(self, seconds: float) -> None:
        """One call through the deadline runner and its hand-off cost."""
        if self.enabled:
            self.deadline_runner_calls += 1
            self.deadline_handoff_wall += seconds

    def add_crosscheck_seconds(self, seconds: float) -> None:
        self._add("crosscheck_wall", seconds)

    def add_cnf_preprocess(self, units: int, pures: int,
                           removed_clauses: int, rounds: int = 0) -> None:
        """One blasted instance simplified by the CNF preprocessor
        (preanalysis/cnf_prep.py) in `rounds` propagation rounds."""
        if self.enabled:
            self.cnf_units_propagated += units
            self.cnf_pure_literals += pures
            self.cnf_clauses_removed += removed_clauses
            self.cnf_prep_rounds += rounds

    def add_cnf_split(self, components: int) -> None:
        """One instance the CDCL settled as `components` variable-disjoint
        sub-instances."""
        self._add("cnf_components_split", components)

    def add_aig_opt(self, nodes_before: int, nodes_after: int,
                    strash_merges: int, const_folds: int,
                    trivial_unsat: bool = False) -> None:
        """One blasted cone rewritten by the AIG sweep + strash
        (preanalysis/aig_opt.py)."""
        if self.enabled:
            self.aig_nodes_before += nodes_before
            self.aig_nodes_after += nodes_after
            self.aig_strash_merges += strash_merges
            self.aig_const_folds += const_folds
            if trivial_unsat:
                self.aig_trivial_unsat += 1

    def add_aig_components(self, components: int) -> None:
        """One rewritten cone partitioned into `components` components."""
        self._add("aig_components", components)

    def add_aig_device_components(self, components: int) -> None:
        """Partitioned sub-cones that rode a device launch individually."""
        self._add("aig_device_components", components)

    def add_aig_device_component_hits(self, components: int) -> None:
        """Dispatched components K1 found a model for."""
        self._add("aig_device_component_hits", components)

    def add_aig_host_components(self, components: int) -> None:
        """Non-trivial components planned for the router's host settle
        (too shallow, or past a capacity)."""
        self._add("aig_host_components", components)

    def add_router_model(self, how: str) -> None:
        """A query the router returned a model for, by how it was found:
        "device" (K1 found every non-trivial part), "host" (at least one
        component settled on the host CDCL inside the router) or
        "trivial" (every component all-unit, no solve at all)."""
        self._add("router_" + {"device": "device_found",
                               "host": "host_settled",
                               "trivial": "trivial_settled"}[how])

    def add_prepare_simplify_hits(self, count: int = 1) -> None:
        """Terms whose simplification the cross-query memo served."""
        self._add("prepare_incremental_hits", count)

    @staticmethod
    def _suffix_bucket(suffix_terms: int) -> str:
        if suffix_terms <= 1:
            return str(suffix_terms)
        if suffix_terms <= 4:
            return "2-4"
        if suffix_terms <= 16:
            return "5-16"
        return "17+"

    def add_prefix_resume(self, suffix_terms: int) -> None:
        """One prepare resumed from a sibling query's prefix snapshot;
        only `suffix_terms` new constraints ran the word-level pipeline
        (bucketed in prepare_suffix_hist)."""
        if self.enabled:
            self.prepare_prefix_resumes += 1
            self.prepare_suffix_terms += suffix_terms
            bucket = self._suffix_bucket(suffix_terms)
            self.prepare_suffix_hist[bucket] = (
                self.prepare_suffix_hist.get(bucket, 0) + 1)

    def add_prefix_fallback(self) -> None:
        """A prepare that found a prefix snapshot but had to re-run the
        full pipeline (the resume guard)."""
        self._add("prepare_prefix_fallbacks")

    def add_strash_xquery(self, count: int) -> None:
        """Gates a cone rewrite reused from sibling queries through the
        session strash table."""
        self._add("strash_xquery_merges", count)

    def add_ragged_window(self, cones: int, stream_bytes: int) -> None:
        """One ragged flat stream dispatched, with the assembled
        paged-stream bytes it shipped."""
        if self.enabled:
            self.ragged_windows += 1
            self.ragged_cones_packed += cones
            self.paged_stream_bytes += stream_bytes

    def add_xcontract_window(self, cones: int) -> None:
        """One ragged stream launch whose cones came from two or more
        distinct origins (contracts); `cones` is the stream's whole cone
        count (mythril_tpu/smt/solver/statistics.py:511)."""
        if self.enabled:
            self.xcontract_windows += 1
            self.xcontract_cones_packed += cones

    def add_xcontract_dedup_hit(self, count: int = 1) -> None:
        """A disk-tier entry (whole instance or component sub-model)
        stored by one contract's analysis and served to another
        contract's query in this process (:520)."""
        self._add("xcontract_dedup_hits", count)

    def add_serve_admission(self, admitted: bool) -> None:
        """One admission decision of the serve daemon: admitted into the
        bounded queue, or rejected (the explicit backpressure answer)
        (mythril_tpu/smt/solver/statistics.py:743)."""
        self._add("serve_requests_admitted" if admitted
                  else "serve_requests_rejected")

    def add_serve_wait_seconds(self, seconds: float) -> None:
        """Queue wait of one admitted request (submit to its batch)."""
        self._add("serve_admission_wall", seconds)

    def add_serve_batch(self, requests: int, tenants: int) -> None:
        """One cross-request batch handed to the coordinator: `requests`
        requests of `tenants` distinct tenants share its windows."""
        if self.enabled:
            self.serve_batches += 1
            self.serve_batch_requests += requests
            self.serve_batch_tenants += tenants

    def add_serve_outcome(self, outcome: str) -> None:
        """Terminal disposition of one serve request: completed (ok or
        error), requeued (goes round once more) or incomplete."""
        name = {"completed": "serve_requests_completed",
                "requeued": "serve_requests_requeued",
                "incomplete": "serve_requests_incomplete"}.get(outcome)
        if name is not None:
            self._add(name)

    def add_serve_drain_seconds(self, seconds: float) -> None:
        self._add("serve_drain_wall", seconds)

    def add_fleet_route(self, count: int = 1) -> None:
        """One digest-keyed routing decision (fleet/router.py)."""
        self._add("fleet_shard_routes", count)

    def add_fleet_requeue(self, count: int = 1) -> None:
        """A fleet request re-routed to a surviving shard after its first
        shard died or faulted mid-proxy."""
        self._add("fleet_requeues", count)

    def add_fleet_shard_restart(self, count: int = 1) -> None:
        """One crash-only shard restart by the fleet supervisor."""
        self._add("fleet_shard_restarts", count)

    def add_net_tier_hit(self, count: int = 1) -> None:
        """A shared network-tier entry served to this process (stored by
        any shard, replay-verified before it is trusted)."""
        self._add("net_tier_hits", count)

    def add_net_tier_store(self, count: int = 1) -> None:
        """An entry this process published into the shared network tier."""
        self._add("net_tier_stores", count)

    def add_net_tier_verify_reject(self, count: int = 1) -> None:
        """A shared entry that failed verification on the reading shard and
        was quarantined there as a safe miss."""
        self._add("net_tier_verify_rejects", count)

    @property
    def serve_tenant_window_share(self) -> float:
        """Mean requests each tenant contributed a serve batch (1.0: every
        batch held one request a tenant) (:861)."""
        if not self.serve_batch_tenants:
            return 0.0
        return self.serve_batch_requests / self.serve_batch_tenants

    def add_cube_dispatch(self, cubes: int, refuted: int = 0) -> None:
        """One cube-and-conquer pass: `cubes` pinned replicas of a hard
        cone rode a ragged stream; `refuted` came back modelless
        (candidate refutations: only the host CDCL proves UNSAT)."""
        if self.enabled:
            self.cubes_dispatched += cubes
            self.cube_device_refutes += refuted

    def add_kernel_launch(self, cells: int) -> None:
        """One ragged-round kernel launch (CUDA, or its plain version on
        the CPU) stepping `cells` block-aligned real-gate cells."""
        if self.enabled:
            self.kernel_launches += 1
            self.kernel_cells_stepped += cells

    def add_fork_pair_pack(self, hit: bool) -> None:
        """One fork pair the router tried to pack as a shared cone; `hit`
        = it did, and both sides ride one page set."""
        if self.enabled:
            self.fork_pair_pack_attempts += 1
            if hit:
                self.fork_pair_pack_hits += 1

    def add_fork_stream_dispatch(self, count: int = 1) -> None:
        """One ragged stream that carried fork-side feasibility cones."""
        self._add("fork_stream_dispatches", count)

    def add_resilience_event(self, site: str, event: str,
                             count: int = 1) -> None:
        """One fault-containment event at `site` (resilience/): bumps the
        matching resilience_* counter and the per-site breakdown behind
        the stats JSON "resilience" section."""
        if self.enabled:
            counter = self._RESILIENCE_EVENT_COUNTERS.get(event)
            if counter is not None:
                setattr(self, counter, getattr(self, counter) + count)
            per_site = self.resilience_events.setdefault(site, {})
            per_site[event] = per_site.get(event, 0) + count

    def add_prepare_seconds(self, seconds: float) -> None:
        """Wall spent inside Solver._prepare (simplify + substitution +
        lowering + blasting + AIG rewrite + CNF preprocessing)."""
        self._add("prepare_wall", seconds)

    def add_module_gated(self, count: int = 1) -> None:
        """A detection module the static reachability gate skipped."""
        self._add("modules_gated", count)

    def add_queries_avoided(self, count: int = 1) -> None:
        """Fork-pruning feasibility solves skipped because pre-analysis
        proved the state's remaining cone inert."""
        self._add("queries_avoided", count)

    def add_fork_pruned(self, count: int = 1) -> None:
        """Fork sides dropped on a host-CDCL UNSAT verdict when a pending
        bundle drained."""
        self._add("frontier_fork_infeasible_pruned", count)

    def add_frontier_step(self, states: int, slots: int,
                          fallback_exits: int = 0,
                          cut_exits: int = 0,
                          hook_exits: int = 0,
                          symbolic_exits: int = 0,
                          symbolic_cuts: int = 0,
                          sym_rows: int = 0) -> None:
        """One batched frontier step: `states` sibling machine states
        executed a straight-line run as one step over `slots` batch
        slots. Mid-run bails back to the per-state interpreter are split
        by reason: `fallback_exits` dynamic bails (memory-window overflow,
        gas exhaustion), `hook_exits` rows bailed so a conditionally-
        transparent hook fires per-state, `symbolic_exits` symbolic-operand
        bails. `cut_exits` / `symbolic_cuts` are completed rows whose run
        cut at an unforked JUMPI / unpromoted RETURN/STOP (dialect) or at a
        CALLDATALOAD the symbolic lane was off for (symbolic) — they leave
        the batch dialect but, unlike bails, also count as stepped rows.
        `sym_rows` completed rows decoded via the symbolic lane's
        structural replay (counted inside `states` too)."""
        if self.enabled:
            self.frontier_vmap_steps += 1
            self.frontier_states_stepped += states
            self.frontier_batch_slots += slots
            bails = fallback_exits + hook_exits + symbolic_exits
            self.frontier_batch_bails += bails
            self.frontier_fallback_exits += bails + cut_exits \
                + symbolic_cuts
            self.frontier_fallback_dynamic += fallback_exits
            self.frontier_fallback_hook += hook_exits
            self.frontier_fallback_symbolic += symbolic_exits \
                + symbolic_cuts
            self.frontier_fallback_dialect += cut_exits
            self.frontier_symlane_rows += sym_rows

    def add_fork_site_exit(self, count: int = 1,
                           reason: str = "dialect") -> None:
        """A state handed to the per-state interpreter at a lane-capable
        site the configuration left unbatched (fork or symbolic-lane
        feature off, hook-gated, depth-capped, or unencodable at the
        minimal run). `reason` names the breakdown bucket (dialect /
        dynamic / symbolic)."""
        if self.enabled:
            self.frontier_fallback_exits += count
            counter = f"frontier_fallback_{reason}"
            setattr(self, counter, getattr(self, counter) + count)

    def add_frontier_fork(self, rows: int, seconds: float = 0.0,
                          cohort_rows: int = 0) -> None:
        """One batched fork: `rows` live sibling rows reached a symbolic
        JUMPI and split into taken/fall-through cohorts; `seconds` is the
        fork epilogue's wall; `cohort_rows` the materialized successors
        beyond one per forked row (credited to the batch occupancy)."""
        if self.enabled:
            self.frontier_forks += 1
            self.frontier_fork_rows += rows
            self.frontier_fork_wall += seconds
            self.frontier_fork_cohort_rows += cohort_rows

    @property
    def frontier_batch_occupancy(self) -> float:
        """Live dense rows per frontier batch slot: stepped rows, mid-run
        bails and the extra fork-cohort rows over the slots (may exceed
        1.0 on fork-dense batches). Handoffs that never took a slot are
        not counted."""
        if not self.frontier_batch_slots:
            return 0.0
        return (self.frontier_states_stepped + self.frontier_batch_bails
                + self.frontier_fork_cohort_rows) \
            / self.frontier_batch_slots

    def add_interp_seconds(self, seconds: float) -> None:
        """Wall spent stepping states in LaserEVM.exec — the interpreter
        component of the wall split."""
        self._add("interp_wall", seconds)

    def add_interp_opcode_wall(self, opcode: str, seconds: float) -> None:
        """One per-state instruction execution (its handler's wall, solver
        seconds inside it subtracted): the per-opcode histogram."""
        if self.enabled:
            record = self.interp_opcode_wall.get(opcode)
            if record is None:
                self.interp_opcode_wall[opcode] = [1, seconds]
            else:
                record[0] += 1
                record[1] += seconds

    def interp_opcode_wall_top(self, n: int = 10) -> dict:
        """Top-`n` per-state opcodes by cumulative wall:
        {opcode: [count, seconds]} (the frontier promotion shortlist)."""
        ranked = sorted(self.interp_opcode_wall.items(),
                        key=lambda item: item[1][1], reverse=True)
        return {op: [count, round(seconds, 4)]
                for op, (count, seconds) in ranked[:n]}

    @property
    def coalesce_occupancy(self) -> float:
        """Mean queries per coalescing-window flush."""
        if not self.window_flushes:
            return 0.0
        return self.coalesced_queries / self.window_flushes

    @property
    def device_occupancy(self) -> float:
        """Mean fraction of device slots holding live queries (1.0 on the
        ragged path: a stream pads no query axis)."""
        if not self.device_slots:
            return 0.0
        return self.device_dispatched_queries / self.device_slots

    @staticmethod
    def device_stats() -> dict:
        """Per-stage counters of the router's device backend (pack, ship,
        solve seconds, launches), or {} before the router first ran."""
        from mythril_tpu_torch.gpu import router

        if router._router is None:
            return {}
        return router._router.backend.stats()

    def reset(self) -> None:
        for name in self._COUNTERS:
            setattr(self, name, 0)
        for name in self._TIMERS:
            setattr(self, name, 0.0)
        self.prepare_suffix_hist = {}
        self.interp_opcode_wall = {}
        self.resilience_events = {}

    def as_dict(self) -> dict:
        """Plain-data snapshot: the MYTHRIL_GPU_STATS_JSON artifact."""
        out = {name: getattr(self, name) for name in self._COUNTERS}
        out.update(
            {name: round(getattr(self, name), 4) for name in self._TIMERS})
        out["device_occupancy"] = round(self.device_occupancy, 4)
        out["coalesce_occupancy"] = round(self.coalesce_occupancy, 4)
        out["frontier_batch_occupancy"] = round(
            self.frontier_batch_occupancy, 4)
        out["serve_tenant_window_share"] = round(
            self.serve_tenant_window_share, 4)
        out["prepare_suffix_hist"] = dict(self.prepare_suffix_hist)
        out["interp_opcode_wall"] = {
            op: [count, round(seconds, 4)]
            for op, (count, seconds) in self.interp_opcode_wall.items()}
        out["interp_opcode_wall_top"] = self.interp_opcode_wall_top()
        device = self.device_stats()
        out["device"] = device
        # per-stage attained vs attainable and the reconciled solver-wall
        # decomposition (observe/roofline.py)
        from mythril_tpu_torch.observe import roofline

        out["roofline"] = roofline.build(self)
        # per-site resilience events, every registered site present
        # (zero-filled, so the section's shape is stable for the lint and
        # for diffing runs), and the armed fault-injection spec ('' when
        # disarmed)
        from mythril_tpu_torch.resilience import faults, registry

        sites = {name: dict(self.resilience_events.get(name, {}))
                 for name in registry.FAULT_SITES}
        for site, events in self.resilience_events.items():
            sites.setdefault(site, dict(events))
        out["resilience"] = {
            "sites": sites,
            "faults_active": faults.active_spec(),
        }
        # the kernel mode that produced the device figures
        # (MYTHRIL_GPU_KERNEL: "pallas" or "xla"), as mythril_tpu stamps
        # it; the device itself is in the "device" section
        from mythril_tpu_torch.gpu.ragged_kernel import kernel_mode

        out["kernel_backend"] = kernel_mode()
        from mythril_tpu_torch.observe.tracer import Tracer

        tracer = Tracer._instance
        out["trace_spans"] = (
            tracer.summary() if tracer is not None and tracer.enabled
            else {})
        return out

    def absorb(self, snapshot: dict) -> None:
        """Fold a --jobs worker's as_dict() into this (the parent's)
        singleton (mythril_tpu/smt/solver/statistics.py:984): every
        counter and timer, the port's own device keys among them
        (kernel_launches and kernel_cells_stepped, the frontier's
        counters, the deadline runner's calls and hand-off wall), the
        suffix histogram, the per-opcode wall and the per-site
        resilience events. The device backend's stats stay per process:
        the backend never crosses the spawn boundary."""
        if not self.enabled or not snapshot:
            return
        for name in self._COUNTERS:
            setattr(self, name, getattr(self, name)
                    + int(snapshot.get(name, 0)))
        for name in self._TIMERS:
            setattr(self, name, getattr(self, name)
                    + float(snapshot.get(name, 0.0)))
        for bucket, count in (snapshot.get("prepare_suffix_hist")
                              or {}).items():
            self.prepare_suffix_hist[bucket] = (
                self.prepare_suffix_hist.get(bucket, 0) + int(count))
        for op, (count, seconds) in (snapshot.get("interp_opcode_wall")
                                     or {}).items():
            record = self.interp_opcode_wall.setdefault(op, [0, 0.0])
            record[0] += int(count)
            record[1] += float(seconds)
        sites = (snapshot.get("resilience") or {}).get("sites") or {}
        for site, events in sites.items():
            per_site = self.resilience_events.setdefault(site, {})
            for event, count in events.items():
                per_site[event] = per_site.get(event, 0) + int(count)

    def __repr__(self):
        out = (f"Solver statistics: query count: {self.query_count}, "
               f"solver time: {self.solver_time:.3f}")
        if self.batch_query_count:
            out += (f", batched queries: {self.batch_query_count}"
                    f", device-eligible: {self.device_batch_queries}"
                    f" (hits: {self.device_batch_hits})"
                    f", device-ineligible: {self.device_ineligible}")
        if self.device_dispatches:
            out += (f", device dispatches: {self.device_dispatches}"
                    f" (occupancy {self.device_occupancy:.2f},"
                    f" {self.route_device_seconds:.2f}s device"
                    f"/{self.route_host_seconds:.2f}s host settle)")
        if self.router_host_direct or self.cap_rejects:
            out += (f", routed host-direct: {self.router_host_direct}"
                    f", cap-rejects: {self.cap_rejects}")
        if self.memory_hits or self.quick_sat_hits or self.persistent_hits \
                or self.persistent_misses:
            out += (f", cache tiers: memory {self.memory_hits}"
                    f"/quick-sat {self.quick_sat_hits}"
                    f"/persistent {self.persistent_hits}"
                    f" (misses {self.persistent_misses},"
                    f" verify-rejects {self.persistent_verify_rejects},"
                    f" stores {self.persistent_stores})")
        if self.window_flushes:
            out += (f", coalesce windows: {self.window_flushes}"
                    f" flushes ({self.coalesced_queries} queries,"
                    f" occupancy {self.coalesce_occupancy:.2f})")
        if self.cdcl_settles:
            out += (f", cdcl settles: {self.cdcl_settles}"
                    f" ({self.cdcl_clauses} clauses,"
                    f" {self.settle_wall:.2f}s wall)")
        if self.modules_gated or self.queries_avoided \
                or self.cnf_units_propagated or self.cnf_pure_literals \
                or self.cnf_components_split:
            out += (f", preanalysis: {self.modules_gated} modules gated"
                    f"/{self.queries_avoided} queries avoided"
                    f"/{self.cnf_units_propagated} units"
                    f"+{self.cnf_pure_literals} pures propagated"
                    f" ({self.cnf_clauses_removed} clauses removed,"
                    f" {self.cnf_components_split} components split)")
        if self.prepare_wall or self.prepare_prefix_resumes \
                or self.prepare_incremental_hits:
            out += (f", prepare: {self.prepare_wall:.2f}s wall"
                    f" ({self.prepare_incremental_hits} simplify hits,"
                    f" {self.prepare_prefix_resumes} prefix resumes"
                    f"/{self.prepare_prefix_fallbacks} fallbacks,"
                    f" {self.prepare_suffix_terms} suffix terms,"
                    f" {self.strash_xquery_merges} cross-query strash)")
        if self.frontier_vmap_steps or self.interp_wall:
            out += (f", frontier: {self.frontier_vmap_steps} vmap steps"
                    f" ({self.frontier_states_stepped} states,"
                    f" {self.frontier_symlane_rows} symlane rows,"
                    f" {self.frontier_fallback_exits} fallback exits,"
                    f" occupancy {self.frontier_batch_occupancy:.2f}),"
                    f" interp {self.interp_wall:.2f}s wall")
        if self.aig_nodes_before:
            out += (f", aig opt: {self.aig_nodes_before}"
                    f"->{self.aig_nodes_after} nodes"
                    f" ({self.aig_strash_merges} strash merges,"
                    f" {self.aig_const_folds} const folds,"
                    f" {self.aig_trivial_unsat} trivially unsat,"
                    f" {self.aig_components} components"
                    f"/{self.aig_device_components} on device)")
        if self.ragged_windows:
            out += (f", ragged: {self.ragged_windows} windows"
                    f" ({self.ragged_cones_packed} cones,"
                    f" {self.paged_stream_bytes} stream bytes,"
                    f" {self.cubes_dispatched} cubes"
                    f"/{self.cube_device_refutes} device refutes,"
                    f" {self.kernel_launches} kernel launches)")
        if self.xcontract_windows or self.xcontract_dedup_hits:
            out += (f", cross-contract: {self.xcontract_windows} mixed"
                    f" windows ({self.xcontract_cones_packed} cones,"
                    f" {self.xcontract_dedup_hits} dedup hits)")
        if self.resilience_events:
            out += (f", resilience: {self.resilience_retries} retries"
                    f"/{self.resilience_degraded} degraded"
                    f"/{self.resilience_quarantines} quarantines"
                    f"/{self.resilience_breaker_trips} breaker trips"
                    f"/{self.resilience_breaker_probes} probes"
                    f"/{self.resilience_deadline_trips} deadline trips"
                    f"/{self.resilience_stale_lock_breaks} stale lock"
                    f" breaks/{self.resilience_faults_injected} injected")
        if self.crosscheck_runs or self.crosscheck_cap_skips:
            out += (f", unsat crosschecks: {self.crosscheck_runs}"
                    f" (+{self.crosscheck_cap_skips} cap-skipped)")
        device = self.device_stats()
        if device:
            out += (f", device pack/ship/solve: {device['pack_seconds']}"
                    f"/{device['ship_seconds']}/{device['solve_seconds']} s"
                    f" (pack cache {device['pack_hits']} hits"
                    f"/{device['pack_misses']} misses,"
                    f" {device['cap_rejects']} cap-rejects)")
        return out
