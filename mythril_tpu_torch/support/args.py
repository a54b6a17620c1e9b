"""Process-global analysis flags (reference mythril/support/support_args.py:31).

Populated by the analyzer frontend from CLI flags; read by the engine,
plugins, detection modules, and solver glue. Separate from the JAX
package's flags: setting one never steers the other."""


class _Args:
    def __init__(self):
        self.solver_timeout = 25000            # ms per query
        self.execution_timeout = 86400         # s per contract
        self.create_timeout = 10               # s for creation tx
        self.max_depth = 128
        self.loop_bound = 3
        self.transaction_count = 2
        self.pruning_factor = None             # None -> auto
        self.call_depth_limit = 3
        self.use_integer_module = True
        self.disable_dependency_pruning = False
        self.disable_mutation_pruner = False
        self.disable_coverage_strategy = False
        self.disable_iprof = False
        # gpu: batched windows go through the router to K1 on the device
        # (torch_device below); cpu: the host CDCL alone
        self.solver_backend = "gpu"            # gpu | cpu
        # torch device of the gpu backend: None = "cuda" (raises without a
        # card); "cpu" runs every kernel's plain PyTorch version
        self.torch_device = None
        self.solve_cache = "memory"            # off | memory | disk
        self.no_preanalysis = False            # pre-analysis master switch
        self.no_aig_opt = False                # the AIG rewrite alone
        self.no_incremental_prep = False       # the prefix resume alone
        self.no_vmap_frontier = False          # --no-vmap-frontier
        self.no_frontier_fork = False          # --no-frontier-fork
        self.beam_width = 8                    # --beam-search WIDTH
        self.transaction_sequences = None      # e.g. "[[0xa9059cbb],[-1]]"
        self.trace = None                      # --trace PATH (span tracer
        #   Perfetto export; MYTHRIL_GPU_TRACE is the env equivalent)
        self.heartbeat = None                  # --heartbeat PATH (live
        #   metrics JSONL; MYTHRIL_GPU_HEARTBEAT is the env equivalent)
        self.inject_fault = None               # --inject-fault SPEC (the
        #   fault-injection harness; MYTHRIL_GPU_FAULTS wins over it)

    def reset(self):
        self.__init__()


args = _Args()
