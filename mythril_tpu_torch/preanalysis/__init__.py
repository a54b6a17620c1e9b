"""Static passes over blasted instances ahead of the device solve.

  aig_opt        constant sweep + session strash rewrite of each prepared
                 cone (smt/solver/frontend._prepare)
  aig_partition  variable-disjoint components of a rewritten cone, each
                 dispatched on its own by the router (gpu/router.py)
  cnf_prep       unit propagation + pure literals over the CNF, and the
                 component split at the host-CDCL settle
  cubes          the cube-and-conquer plans of the device's second pass

MYTHRIL_GPU_PREANALYSIS=0 (or `args.no_preanalysis`) turns the subsystem
off; MYTHRIL_GPU_PREANALYSIS=1 force-enables it over the flag. The JAX
package's bytecode passes (CFG recovery, effect summaries, module gating,
fork-prune hints) belong to the engine and are not ported yet.
"""

import os


def enabled() -> bool:
    """Master switch: env override first, then the no_preanalysis flag."""
    env = os.environ.get("MYTHRIL_GPU_PREANALYSIS", "")
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "true"):
        return True
    from mythril_tpu_torch.support.args import args

    return not getattr(args, "no_preanalysis", False)


def reset_caches() -> None:
    """Drop the rewrite cache, the session strash table and the partition
    cache (support/model.clear_caches)."""
    from mythril_tpu_torch.preanalysis import aig_opt, aig_partition

    aig_opt.reset_cache()
    aig_partition.reset_cache()
