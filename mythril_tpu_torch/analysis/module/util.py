"""Hook-table construction for detection modules
(reference analysis/module/util.py:13-43)."""

from collections import defaultdict
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.support.opcodes import BY_NAME


def expand_hook_opcodes(names) -> frozenset:
    """Expand a hook-name list (exact names + the reference's PREFIX*
    wildcards, e.g. 'PUSH' -> PUSH1..32) into concrete opcode names."""
    out = set()
    for op_name in names:
        if op_name in BY_NAME:
            out.add(op_name)
        else:
            out.update(n for n in BY_NAME if n.startswith(op_name))
    return frozenset(out)


def module_trigger_opcodes(module: DetectionModule) -> frozenset:
    """The opcodes that must be executable for `module` to ever raise an
    issue: its declared trigger_opcodes, defaulting to the union of its
    hook opcodes (wildcards expanded). Used by the loader's static
    reachability gate."""
    triggers = getattr(module, "trigger_opcodes", None)
    if triggers is None:
        triggers = list(module.pre_hooks) + list(module.post_hooks)
    return expand_hook_opcodes(triggers)


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type: str = "pre"
) -> Dict[str, List[Callable]]:
    """Build opcode -> [module.execute] tables. Supports the reference's
    PREFIX* wildcard hook names (e.g. 'PUSH' matching PUSH1..32)."""
    hook_dict = defaultdict(list)
    prehook = hook_type == "pre"

    def bind(module, op_name):
        def hook(state, _m=module, _n=op_name, _p=prehook):
            return _m.execute(state, opcode=_n, prehook=_p)

        # conditional frontier transparency: a module may declare a
        # per-opcode value predicate under which its hook is provably
        # inert for batched straight-line runs (laser/frontier/stepper
        # consumes the attribute off the BOUND hook — registration and
        # gating must see the same object)
        predicate = getattr(module, "frontier_transparent_unless",
                            {}).get(op_name)
        if predicate is not None:
            hook.frontier_transparent_unless = predicate
        return hook

    for module in modules:
        if module.entry_point != EntryPoint.CALLBACK:
            continue
        hooks = module.pre_hooks if prehook else module.post_hooks
        for op_name in hooks:
            # one expansion rule for registration AND the gating trigger
            # sets (module_trigger_opcodes): the two must never diverge
            for name in sorted(expand_hook_opcodes([op_name])):
                hook_dict[name].append(bind(module, name))
    return dict(hook_dict)


def reset_callback_modules(module_names: Optional[List[str]] = None):
    for module in ModuleLoader().get_detection_modules(
        white_list=module_names
    ):
        if module.entry_point == EntryPoint.CALLBACK:
            module.reset_module()
