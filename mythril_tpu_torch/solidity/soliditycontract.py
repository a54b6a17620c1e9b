"""SolidityContract — compile .sol files with solc and carry srcmaps
(reference mythril/solidity/soliditycontract.py:395; solc invocation as in
mythril/ethereum/util.py get_solc_json).

The solc binary itself is an external tool (SURVEY §2.9: out of scope to
rebuild); it is located via $SOLC or PATH and its standard-json output is
parsed here. Everything downstream (srcmap decoding, instruction-offset ->
source-line resolution for reports) is implemented locally.
"""

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional

from mythril_tpu_torch.ethereum.evmcontract import EVMContract


class SolcError(Exception):
    pass


class NoContractFoundError(Exception):
    pass


def find_solc(solc_binary: Optional[str] = None) -> str:
    binary = solc_binary or os.environ.get("SOLC") or shutil.which("solc")
    if not binary or not (os.path.exists(binary) or shutil.which(binary)):
        raise ImportError(
            "solc binary not found (install solc or set $SOLC)"
        )
    return binary


def find_solc_version(version: str) -> str:
    """Resolve a specific compiler version (reference `--solv`): looks for
    `solc-vVERSION` on PATH, in $SOLC_DIR and in the port's data
    directory's solc/ (support/config.py: MYTHRIL_GPU_DIR, else
    ~/.mythril_tpu_torch). Nothing is downloaded: a missing version is a
    clear error, not a fetch."""
    name = f"solc-v{version.lstrip('v')}"
    candidates = [shutil.which(name)]
    data_dir = os.environ.get("MYTHRIL_GPU_DIR") or os.path.join(
        os.path.expanduser("~"), ".mythril_tpu_torch")
    for root in (os.environ.get("SOLC_DIR"),
                 os.path.join(data_dir, "solc")):
        if root:
            candidates.append(os.path.join(root, name))
    for candidate in candidates:
        if candidate and os.path.exists(candidate):
            return candidate
    raise ImportError(
        f"solc {version} not found (looked for {name} on PATH, in "
        "$SOLC_DIR and in the data directory's solc/; nothing is "
        "downloaded)"
    )


def get_solc_json(file_path: str, solc_binary: Optional[str] = None,
                  solc_args: Optional[List[str]] = None) -> dict:
    """Run `solc --standard-json` on one file; returns the parsed output.

    solc rejects most CLI options in standard-json mode, so the common
    compile flags (--optimize, --optimize-runs N) are translated into the
    standard-json settings; path options pass through on the command line."""
    binary = find_solc(solc_binary)
    with open(file_path) as handle:
        source = handle.read()
    optimizer: dict = {"enabled": False}
    cli_args: List[str] = []
    args_iter = iter(solc_args or [])
    for arg in args_iter:
        if arg == "--optimize":
            optimizer["enabled"] = True
        elif arg == "--optimize-runs" or arg.startswith("--optimize-runs="):
            optimizer["enabled"] = True
            raw = (arg.split("=", 1)[1] if "=" in arg
                   else next(args_iter, "200"))
            try:
                optimizer["runs"] = int(raw)
            except ValueError:
                raise SolcError(
                    f"--optimize-runs expects a number, got {raw!r}"
                ) from None
        else:
            cli_args.append(arg)
    standard_input = {
        "language": "Solidity",
        "sources": {file_path: {"content": source}},
        "settings": {
            "outputSelection": {
                "*": {
                    "*": [
                        "evm.bytecode.object",
                        "evm.bytecode.sourceMap",
                        "evm.deployedBytecode.object",
                        "evm.deployedBytecode.sourceMap",
                        "abi",
                    ],
                    "": ["ast"],
                }
            },
            "optimizer": optimizer,
        },
    }
    proc = subprocess.run(
        [binary, "--standard-json", "--allow-paths", "."] + cli_args,
        input=json.dumps(standard_input),
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise SolcError(f"solc failed: {proc.stderr[:500]}")
    output = json.loads(proc.stdout)
    errors = [e for e in output.get("errors", [])
              if e.get("severity") == "error"]
    if errors:
        raise SolcError(errors[0].get("formattedMessage",
                                      errors[0].get("message", "solc error")))
    return output


class SourceInfo:
    __slots__ = ("filename", "code", "lineno", "solc_mapping")

    def __init__(self, filename: str, code: str, lineno: Optional[int],
                 solc_mapping: str):
        self.filename = filename
        self.code = code
        self.lineno = lineno
        self.solc_mapping = solc_mapping


def decode_srcmap(srcmap: str) -> List[List[str]]:
    """solc srcmap run-length decoding: empty fields inherit the previous
    entry's value."""
    entries = []
    prev = ["0", "0", "0", "-", "0"]
    for item in srcmap.split(";"):
        fields = item.split(":")
        entry = list(prev)
        for i, field in enumerate(fields):
            if field:
                entry[i] = field
        entries.append(entry)
        prev = entry
    return entries


def _strip_placeholders(bytecode: str) -> str:
    """Unlinked library placeholders (__$...$__) become zero addresses."""
    out = []
    i = 0
    while i < len(bytecode):
        if bytecode.startswith("__", i):
            end = bytecode.find("__", i + 2)
            span = (end + 2 - i) if end != -1 else 40
            out.append("0" * span)
            i += span
        else:
            out.append(bytecode[i])
            i += 1
    return "".join(out)


class SolidityContract(EVMContract):
    def __init__(self, input_file: str, name: str, solc_output: dict,
                 source_text: Optional[str] = None):
        contracts = solc_output["contracts"][input_file]
        data = contracts[name]
        evm = data["evm"]
        super().__init__(
            code=_strip_placeholders(evm["deployedBytecode"]["object"]),
            creation_code=_strip_placeholders(evm["bytecode"]["object"]),
            name=name,
        )
        self.input_file = input_file
        self.solc_indices = self._build_source_index(solc_output)
        self.srcmap = decode_srcmap(
            evm["deployedBytecode"].get("sourceMap", ""))
        self.creation_srcmap = decode_srcmap(
            evm["bytecode"].get("sourceMap", ""))
        self.abi = data.get("abi", [])
        self.solc_ast = solc_output.get("sources", {}).get(
            input_file, {}).get("ast")  # feeds laser/tx_prioritiser.py
        if source_text is None:
            with open(input_file) as handle:
                source_text = handle.read()
        self.source_text = source_text

    @staticmethod
    def _build_source_index(solc_output: dict) -> Dict[int, str]:
        indices = {}
        for path, meta in solc_output.get("sources", {}).items():
            indices[meta.get("id", 0)] = path
        return indices

    def _mapping_at(self, address: int, constructor: bool):
        disassembly = (self.creation_disassembly if constructor
                       else self.disassembly)
        srcmap = self.creation_srcmap if constructor else self.srcmap
        index = disassembly.index_of_address(address)
        if index is None or index >= len(srcmap):
            return None
        return srcmap[index]

    def get_source_info(self, address: int,
                        constructor: bool = False) -> Optional[SourceInfo]:
        entry = self._mapping_at(address, constructor)
        if entry is None:
            return None
        offset, length, file_index = (int(entry[0]), int(entry[1]),
                                      int(entry[2]))
        if file_index < 0:  # autogenerated code (no source)
            return None
        filename = self.solc_indices.get(file_index, self.input_file)
        snippet = self.source_text[offset: offset + length]
        lineno = self.source_text[:offset].count("\n") + 1
        return SourceInfo(
            filename=filename,
            code=snippet,
            lineno=lineno,
            solc_mapping=f"{offset}:{length}:{file_index}",
        )


def get_contracts_from_file(
    input_file: str,
    solc_binary: Optional[str] = None,
    solc_args: Optional[List[str]] = None,
) -> List[SolidityContract]:
    """All deployable contracts in a file, file-order, skipping interfaces
    (empty bytecode)."""
    output = get_solc_json(input_file, solc_binary, solc_args)
    contracts = []
    for name, data in output.get("contracts", {}).get(input_file, {}).items():
        if not data.get("evm", {}).get("deployedBytecode", {}).get("object"):
            continue
        contracts.append(SolidityContract(input_file, name, output))
    if not contracts:
        raise NoContractFoundError(
            f"no deployable contract found in {input_file}"
        )
    return contracts


def get_contracts_from_foundry(build_info: dict) -> List[SolidityContract]:
    """All deployable contracts in one `forge build --build-info` artifact
    (reference soliditycontract.py:141 get_contracts_from_foundry +
    mythril_disassembler.py:160 load_from_foundry). The build-info JSON
    carries solc standard-json "input" (with source text) and "output"
    (bytecode + srcmaps), so no file reads or solc invocation is needed."""
    if build_info.get("input", {}).get("language", "Solidity") != "Solidity":
        raise NotImplementedError("only Solidity foundry projects supported")
    output = build_info["output"]
    sources_in = build_info.get("input", {}).get("sources", {})
    contracts = []
    for input_file, per_file in output.get("contracts", {}).items():
        source_text = sources_in.get(input_file, {}).get("content", "")
        for name, data in per_file.items():
            if not data.get("evm", {}).get(
                    "deployedBytecode", {}).get("object"):
                continue
            contracts.append(SolidityContract(
                input_file, name, output, source_text=source_text))
    return contracts
