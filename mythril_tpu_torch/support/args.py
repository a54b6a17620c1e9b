"""Process-global analysis flags (reference support_args.py:31).

The subset of mythril_tpu.support.args that the solve path reads.
Separate from the JAX package's flags: setting one never steers the other."""


class _Args:
    def __init__(self):
        self.solver_timeout = 25000            # ms per query
        self.solver_backend = "cpu"            # cpu | gpu
        # torch device of the gpu backend: None = "cuda" (raises without a
        # card); "cpu" runs every kernel's plain PyTorch version
        self.torch_device = None
        self.solve_cache = "memory"            # off | memory (disk: later)
        self.no_preanalysis = False            # pre-analysis master switch
        self.no_aig_opt = False                # the AIG rewrite alone
        self.no_incremental_prep = False       # the prefix resume alone

    def reset(self):
        self.__init__()


args = _Args()
