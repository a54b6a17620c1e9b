"""Per-origin engine contexts and blasters
(mythril_tpu.service.tenancy, the part the interleaved corpus run calls).

  origins        an origin tag is one analysis's identity in an
                 interleaved corpus run: `"{idx}:{name}"`, minted by the
                 coordinator (service/interleave.py), index-qualified
                 because contracts loaded from bytecode share a name.
  blasters       the per-origin private blaster registry. The shared
                 strashed AIG assigns node ids in first-use order and the
                 dense CNF sorts by id, so a process-wide blaster would
                 make the CDCL's branching, and so the model it returns,
                 depend on which sibling analysis blasted a common
                 subterm first. Per-origin blasters reproduce the solo
                 process's id space: interleaved reports are byte-identical
                 to the sequential ones, witnesses included.
  EngineContext  one origin's slice of the process-global engine state,
                 switched at every baton hand-off.

Process-global state of the port that EngineContext does not swap, and
why the schedule cannot reach the findings through it:

  the recorded DeviceFault (gpu/device.py)  a fault stops the whole run
      (the coordinator cancels every slot and re-raises it on the
      caller's thread), so which slot records or re-raises it changes
      nothing but the thread;
  SignatureDB (support/signatures.py)  read-only during an analysis:
      the built-in table and the signature file, never written;
  the frontier's step buffers (gpu/frontier_kernel.py)  thread-local, so
      each slot thread packs into its own pinned buffer, and every step
      synchronises before it returns (no launch is in flight across a
      hand-off); the `kernel.on_cuda_step` observer only watches;
  the execution budget (support/time_handler.py)  swapped here, paused
      while the origin is off the baton, and ended by fire_lasers'
      finally once every slot is done.

The session helpers of the JAX package (encode_session,
origin_in_session, evict_session) and its warm start (install_fresh's
preserve_caches) serve only its serve daemon, and come with it.
"""

import copy
import time
from typing import Dict, Tuple

# origin -> (Blaster or None, term generation): each analysis's private
# blaster/AIG (None = lazily recreated on first use).
_blasters: Dict[str, Tuple[object, int]] = {}


def install_blaster(origin) -> None:
    """Install `origin`'s private blaster over the process globals."""
    from mythril_tpu_torch.smt.solver import frontend

    (frontend._global_blaster,
     frontend._global_blaster_generation) = _blasters.get(origin,
                                                          (None, -1))


def stash_blaster(origin) -> None:
    """Capture the live process-global blaster as `origin`'s."""
    from mythril_tpu_torch.smt.solver import frontend

    _blasters[origin] = (frontend._global_blaster,
                         frontend._global_blaster_generation)


def reset_blaster(origin) -> None:
    """Give `origin` an empty blaster (a cold start) and install it
    (mythril_tpu/service/tenancy.py:96)."""
    from mythril_tpu_torch.smt.solver import frontend

    _blasters[origin] = (None, -1)
    frontend._global_blaster = None
    frontend._global_blaster_generation = -1


def clear_blasters() -> None:
    _blasters.clear()


def capture_module_templates():
    """Pristine per-module state, taken once when the run starts (right
    after every module was reset; :109): each origin's fresh install
    copies from these, so a module attribute one origin adds mid-run
    never leaks into another's."""
    from mythril_tpu_torch.analysis.module import ModuleLoader

    return [
        (module, {key: copy.copy(value)
                  for key, value in module.__dict__.items()})
        for module in ModuleLoader().get_detection_modules()
    ]


class EngineContext:
    """One origin's slice of the process-global engine state
    (mythril_tpu/service/tenancy.py:123-241): the execution budget, the
    transaction ids, the keccak and exponent function managers, every
    detection module's state, the memory tier and quick-sat deque, the
    detection-context flag and the blaster.

    install_fresh() gives a starting analysis the state a solo process
    would give it; save() captures the live globals when the origin loses
    the baton; restore() puts them back when it gets the baton again.
    Singletons that other modules hold references to (the function
    managers, the detection modules) are swapped by replacing their
    __dict__; support.model's memory tiers by rebinding the module
    attributes its call sites re-read."""

    def __init__(self, origin: str, module_templates):
        self.origin = origin
        self._templates = module_templates
        self._saved = None

    def install_fresh(self) -> None:
        from mythril_tpu_torch.laser.function_managers import (
            exponent_function_manager,
            keccak_function_manager,
        )
        from mythril_tpu_torch.laser.transaction.models import tx_id_manager
        from mythril_tpu_torch.support import model as model_mod
        from mythril_tpu_torch.support.time_handler import time_handler

        time_handler._start = None
        time_handler._timeout = None
        tx_id_manager._next = 0
        reset_blaster(self.origin)
        keccak_function_manager.__dict__ = (
            type(keccak_function_manager)().__dict__)
        exponent_function_manager.__dict__ = (
            type(exponent_function_manager)().__dict__)
        for module, template in self._templates:
            module.__dict__ = {key: copy.copy(value)
                               for key, value in template.items()}
        # the origin's memory tiers live in model.py's per-origin registry
        # (get_models_batch resolves them per query in a mixed flush);
        # installed in the module globals they serve the ambient call
        # sites (get_model, the engine's quick-sat probes) while this
        # origin holds the baton. A stale pair is dropped: the analysis
        # starts as cold as a solo process would
        model_mod._origin_caches.pop(self.origin, None)
        tier, quick_cache = model_mod.caches_for_origin(self.origin)
        model_mod._result_cache = tier
        model_mod.model_cache = quick_cache
        model_mod._in_detection_context = False

    def save(self) -> None:
        from mythril_tpu_torch.laser.function_managers import (
            exponent_function_manager,
            keccak_function_manager,
        )
        from mythril_tpu_torch.laser.transaction.models import tx_id_manager
        from mythril_tpu_torch.support import model as model_mod
        from mythril_tpu_torch.support.time_handler import time_handler

        # the execution budget pauses while the origin is off the baton:
        # keep the elapsed time, not the start, so siblings' turns do not
        # burn this contract's budget
        elapsed = (time.monotonic() - time_handler._start
                   if time_handler._start is not None else None)
        stash_blaster(self.origin)
        self._saved = {
            "time": (elapsed, time_handler._timeout),
            "txid": tx_id_manager._next,
            "keccak": keccak_function_manager.__dict__,
            "exponent": exponent_function_manager.__dict__,
            "modules": [module.__dict__ for module, _t in self._templates],
            "result_cache": model_mod._result_cache,
            "model_cache": model_mod.model_cache,
            "detection": model_mod._in_detection_context,
        }

    def restore(self) -> None:
        from mythril_tpu_torch.laser.function_managers import (
            exponent_function_manager,
            keccak_function_manager,
        )
        from mythril_tpu_torch.laser.transaction.models import tx_id_manager
        from mythril_tpu_torch.support import model as model_mod
        from mythril_tpu_torch.support.time_handler import time_handler

        saved, self._saved = self._saved, None
        elapsed, timeout = saved["time"]
        time_handler._timeout = timeout
        time_handler._start = (time.monotonic() - elapsed
                               if elapsed is not None else None)
        tx_id_manager._next = saved["txid"]
        install_blaster(self.origin)
        keccak_function_manager.__dict__ = saved["keccak"]
        exponent_function_manager.__dict__ = saved["exponent"]
        for (module, _t), state in zip(self._templates, saved["modules"]):
            module.__dict__ = state
        model_mod._result_cache = saved["result_cache"]
        model_mod.model_cache = saved["model_cache"]
        model_mod._in_detection_context = saved["detection"]
