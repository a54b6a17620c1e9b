"""Issue + Report rendering (reference mythril/analysis/report.py:411).

Formats: text / markdown / json / jsonv2 (SWC standard format)."""

import json
import logging
from typing import Dict, List, Optional

from mythril_tpu_torch.analysis.swc_data import SWC_TO_TITLE
from mythril_tpu_torch.version import __version__

log = logging.getLogger(__name__)


class Issue:
    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode,
        severity: str,
        description_head: str = "",
        description_tail: str = "",
        gas_used=(None, None),
        transaction_sequence: Optional[Dict] = None,
    ):
        self.contract = contract
        self.function = function_name
        self.address = address
        self.title = title
        self.severity = severity
        self.swc_id = swc_id
        self.description_head = description_head
        self.description_tail = description_tail
        self.min_gas_used, self.max_gas_used = gas_used
        self.filename = ""
        self.code = ""
        self.lineno = None
        self.source_mapping = None
        self.discovery_time = 0
        self.transaction_sequence = transaction_sequence
        if isinstance(bytecode, bytes):
            self.bytecode = bytecode.hex()
        elif isinstance(bytecode, (tuple, list)):
            # code with deploy-time-patched symbolic bytes: hash/report the
            # concrete projection
            from mythril_tpu_torch.disasm.disassembly import _concrete_projection

            self.bytecode = _concrete_projection(bytecode).hex()
        else:
            self.bytecode = str(bytecode or "")
        try:
            from mythril_tpu_torch.utils.keccak import keccak256

            self.bytecode_hash = "0x" + keccak256(
                bytes.fromhex(self.bytecode) if self.bytecode else b""
            ).hex()
        except ValueError:
            self.bytecode_hash = ""

    @property
    def description(self) -> str:
        tail = f"\n{self.description_tail}" if self.description_tail else ""
        return f"{self.description_head}{tail}"

    @property
    def transaction_sequence_users(self):
        """Exploit steps rendered for reports."""
        return self.transaction_sequence

    def as_dict(self) -> Dict:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "tx_sequence": self.transaction_sequence,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
            "sourceMap": self.source_mapping,
            "filename": self.filename,
            "code": self.code,
            "lineno": self.lineno,
        }
        return issue

    def add_code_info(self, contract) -> None:
        """Attach source mapping when the contract carries solidity sources."""
        if not hasattr(contract, "get_source_info"):
            return
        try:
            source_info = contract.get_source_info(
                self.address, constructor=self.function == "constructor"
            )
        except Exception:
            return
        if source_info is None:
            return
        self.filename = source_info.filename
        self.code = source_info.code
        self.lineno = source_info.lineno
        self.source_mapping = source_info.solc_mapping

    def resolve_function_name(self, sig_db=None) -> None:
        """_function_0xselector -> human signature via the signature DB."""
        if not self.function.startswith("_function_0x") or sig_db is None:
            return
        selector = self.function[len("_function_"):]
        matches = sig_db.get(selector)
        if matches:
            self.function = matches[0]


class Report:
    environment = {}

    def __init__(self, contracts=None, exceptions=None,
                 execution_info=None):
        self.issues: Dict[str, Issue] = {}
        self.contracts = contracts or []
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []

    def append_issue(self, issue: Issue) -> None:
        # function is part of the key: distinct functions can share a
        # revert/panic block address (reference report.py:302-309)
        key = (
            f"{issue.contract}-{issue.function}-{issue.address}-"
            f"{issue.swc_id}-{issue.title}"
        )
        self.issues[key] = issue

    def sorted_issues(self) -> List[Issue]:
        return sorted(
            self.issues.values(), key=lambda i: (i.contract, i.address, i.swc_id)
        )

    def as_text(self) -> str:
        if not self.issues:
            return "The analysis was completed successfully. No issues were detected.\n"
        blocks = []
        for issue in self.sorted_issues():
            lines = [
                f"==== {issue.title} ====",
                f"SWC ID: {issue.swc_id}",
                f"Severity: {issue.severity}",
                f"Contract: {issue.contract}",
                f"Function name: {issue.function}",
                f"PC address: {issue.address}",
                f"Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                lines.append(f"In file: {issue.filename}:{issue.lineno}")
            if issue.code:
                lines.append(f"\n{issue.code}\n")
            if issue.transaction_sequence:
                lines.append("")
                lines.append("Transaction Sequence:")
                lines.append(
                    json.dumps(issue.transaction_sequence, indent=4)
                )
            blocks.append("\n".join(lines))
        return "\n\n".join(blocks) + "\n\n"

    def as_markdown(self) -> str:
        if not self.issues:
            return "# Analysis results\n\nThe analysis was completed successfully. No issues were detected.\n"
        blocks = ["# Analysis results"]
        for issue in self.sorted_issues():
            block = [
                f"## {issue.title}",
                f"- SWC ID: {issue.swc_id}",
                f"- Severity: {issue.severity}",
                f"- Contract: {issue.contract}",
                f"- Function name: `{issue.function}`",
                f"- PC address: {issue.address}",
                f"- Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                "",
                "### Description",
                issue.description,
            ]
            if issue.filename and issue.lineno:
                block.append(f"\nIn file: {issue.filename}:{issue.lineno}")
            blocks.append("\n".join(block))
        return "\n\n".join(blocks) + "\n"

    def as_json(self) -> str:
        result = {
            "success": True,
            "error": None,
            "issues": [issue.as_dict() for issue in self.sorted_issues()],
        }
        return json.dumps(result, default=str, sort_keys=True)

    def as_swc_standard_format(self) -> str:
        """jsonv2: one result object per analyzed bytecode."""
        results = []
        by_bytecode: Dict[str, List[Issue]] = {}
        for issue in self.sorted_issues():
            by_bytecode.setdefault(issue.bytecode_hash, []).append(issue)
        for bytecode_hash, issues in by_bytecode.items():
            result_issues = []
            for issue in issues:
                result_issues.append(
                    {
                        "swcID": f"SWC-{issue.swc_id}",
                        "swcTitle": SWC_TO_TITLE.get(issue.swc_id, ""),
                        "description": {
                            "head": issue.description_head,
                            "tail": issue.description_tail,
                        },
                        "severity": issue.severity,
                        "locations": [
                            {"bytecode": {"bytecodeOffset": issue.address}}
                        ],
                        "extra": {
                            "discoveryTime": issue.discovery_time,
                            "testCases": [issue.transaction_sequence]
                            if issue.transaction_sequence
                            else [],
                        },
                    }
                )
            results.append(
                {
                    "issues": result_issues,
                    "sourceType": "raw-bytecode",
                    "sourceFormat": "evm-byzantium-bytecode",
                    "sourceList": [bytecode_hash],
                    "meta": {
                        "toolName": "mythril_tpu_torch",
                        "toolVersion": __version__,
                    },
                }
            )
        return json.dumps(results, default=str, sort_keys=True)
