"""Solve service in front of the solver seam (support/model.py).

  store.py        persistent on-disk result tier keyed by a canonical
                  content fingerprint of the blasted instance
                  (fingerprint.py); SAT entries are replay-verified on
                  every hit, UNSAT entries carry crosscheck provenance
  scheduler.py    coalescing solve scheduler: a submit() -> handle facade
                  and the solve_batch / solve_fork_batch seams, flushing
                  buffered queries as ONE get_models_batch call (one
                  router dispatch)
  calibration.py  persistent router micro-calibration cache, written only
                  under solve_cache "disk"
  tenancy.py /    the per-origin blaster registry and the ambient origin
  interleave.py   of the interleaved corpus driver (whose coordinator is
                  not ported: the origin is always None here)

Tier selection rides `args.solve_cache`:
  off     no result caching at all
  memory  the in-memory term-keyed tier and the quick-sat probe (default)
  disk    the memory tier plus the persistent result store and the
          persisted calibration, under MYTHRIL_GPU_CACHE_DIR
"""

import os

from mythril_tpu_torch.support.args import args

_MODES = ("off", "memory", "disk")


def solve_cache_mode() -> str:
    mode = getattr(args, "solve_cache", "memory")
    return mode if mode in _MODES else "memory"


def memory_tier_enabled() -> bool:
    return solve_cache_mode() != "off"


def disk_tier_enabled() -> bool:
    return solve_cache_mode() == "disk"


def cache_dir() -> str:
    """Root of every persistent service artifact (MYTHRIL_GPU_CACHE_DIR,
    else ~/.cache/mythril_tpu_torch)."""
    return os.environ.get("MYTHRIL_GPU_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "mythril_tpu_torch")


def reset_service_state() -> None:
    """Discard buffered scheduler state (unresolved handles degrade to
    unknown) and release the store handle, so the next access re-opens
    from disk; clear_caches() calls this so tests start clean."""
    from mythril_tpu_torch.service.scheduler import reset_scheduler
    from mythril_tpu_torch.service.store import reset_result_store

    reset_scheduler()
    reset_result_store()
