"""Run POST modules + collect callback issues
(reference analysis/security.py:45)."""

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module import EntryPoint, ModuleLoader
from mythril_tpu_torch.analysis.module.util import reset_callback_modules

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None) -> List:
    issues = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        issues.extend(module.issues)
    reset_callback_modules(module_names=white_list)
    return issues


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List:
    """Execute POST modules over the statespace, then gather everything."""
    issues = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.POST, white_list=white_list
    ):
        log.info("running POST module %s", module.name)
        module.execute(statespace)
        issues.extend(module.issues)
        module.reset_module()
    issues.extend(retrieve_callback_issues(white_list))
    return issues
