"""Lint: every MYTHRIL_GPU_* knob named in mythril_tpu_torch/ has a row in
the README's port knob table (tools/check_env_docs.py does the same for
the JAX package's MYTHRIL_TPU_* knobs)."""

import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a whole knob name: a trailing underscore marks a family prefix in prose
# ("the MYTHRIL_GPU_RAGGED_* knobs"), not a knob
KNOB = re.compile(r"MYTHRIL_GPU_[A-Z0-9_]*[A-Z0-9]\b")
ROW = re.compile(r"^\|\s*`(MYTHRIL_GPU_[A-Z0-9_]+)`\s*\|")


def _named_in_port():
    names = set()
    for folder, _dirs, files in os.walk(os.path.join(ROOT,
                                                     "mythril_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(folder, name),
                          encoding="utf-8") as handle:
                    names.update(KNOB.findall(handle.read()))
    return names


def _documented():
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as handle:
        return {match.group(1) for match in map(ROW.match, handle)
                if match}


def test_every_port_knob_is_documented():
    named = _named_in_port()
    assert "MYTHRIL_GPU_PREANALYSIS" in named
    missing = sorted(named - _documented())
    assert not missing, f"README port knob table lacks {missing}"


def test_no_documented_knob_is_stale():
    stale = sorted(_documented() - _named_in_port())
    assert not stale, f"README documents knobs the port never names: {stale}"


def test_the_pattern_reads_whole_names():
    assert KNOB.findall("os.environ.get('MYTHRIL_GPU_CUBE_VARS')") == [
        "MYTHRIL_GPU_CUBE_VARS"]
    assert KNOB.findall("the MYTHRIL_GPU_RAGGED_* knobs") == []
    assert not ROW.match("| `MYTHRIL_TPU_CUBE_VARS` | 7 | width |")
