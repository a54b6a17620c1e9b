"""Declarative knob space of the autotune search (mythril_tpu.tune.space).

Every tunable the device path reads through support/env is registered
here as a typed Knob: its env name, kind, built-in default, the roofline
stage it moves (so the search is gap-directed: it seeds where the
baseline's `sol_gap_s` ranking says the recoverable seconds are) and the
values the search may try. The registry serves three readers:

  search.py         proposes (knob, value) candidates in gap order;
  resolved_config() stamps every run's resolved configuration (value and
                    source tier) into the stats JSON and the heartbeat;
  tests/test_torch_env_docs.py  every knob has a README table row.

A knob's `default` is the value its consumer uses when the knob is unset;
None marks a default the consumer derives (the cube split width is 3 on
the CPU and 7 on a card; the kernel mode "auto" is "pallas"): the stamp
then reports None with source "default". `stage` names a roofline stage
(observe/roofline.STAGES) where the knob moves one, or a subsystem tag
("serve") where it does not.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

from mythril_tpu_torch.support.env import resolve_source

MIB = 1024 * 1024


class Knob(NamedTuple):
    env: str            # MYTHRIL_GPU_* variable (support/env resolution)
    kind: str           # "int" | "float" | "str" (categorical)
    default: Optional[object]  # the consumer's default; None = derived
    stage: str          # roofline stage the knob moves (or subsystem tag)
    candidates: Tuple   # non-default values the search may evaluate
    help: str


KNOBS: Tuple[Knob, ...] = (
    # kernel stage: what one device round costs and how much work it does
    Knob("MYTHRIL_GPU_ROUND_BUDGET", "float", 4.0, "kernel",
         (2.0, 8.0), "target seconds per kernel round"),
    Knob("MYTHRIL_GPU_RESTARTS", "int", 64, "kernel",
         (16, 32, 128), "restart lanes per query"),
    Knob("MYTHRIL_GPU_CIRCUIT_STEPS", "int", 64, "kernel",
         (32, 128), "SLS steps per kernel round"),
    # derived: 3 on the CPU (evidence mode), 7 on a card
    Knob("MYTHRIL_GPU_CUBE_VARS", "int", None, "kernel",
         (2, 4), "cube-and-conquer split width k (2^k cubes)"),
    Knob("MYTHRIL_GPU_CUBE_MIN_LEVELS", "int", 64, "kernel",
         (32, 128), "min cone depth for the cube second pass"),
    Knob("MYTHRIL_GPU_CPU_DISPATCH_CAP", "int", 2, "kernel",
         (1, 4), "evidence-mode bucketed dispatches per process"),
    # derived: "auto" is "pallas" (K1, K2 past its capacities) on every
    # device (gpu/ragged_kernel.kernel_mode); "xla" runs K2 for every
    # stream
    Knob("MYTHRIL_GPU_KERNEL", "str", None, "kernel",
         ("xla", "pallas"), "ragged device-kernel backend "
         "(xla | pallas | auto)"),
    # ragged stage: stream assembly, admission and window formation
    Knob("MYTHRIL_GPU_RAGGED_STREAM_BYTES", "int", 48 * MIB, "ragged",
         (24 * MIB, 96 * MIB), "memory budget per assembled flat stream"),
    Knob("MYTHRIL_GPU_RAGGED_CHUNK_CONES", "int", 0, "ragged",
         (2, 4), "cones per mixed-origin stream in xla mode (0 = auto: 2 "
         "on the CPU, no cap on a card)"),
    Knob("MYTHRIL_GPU_RAGGED_WINDOW_CAP", "int", 4, "ragged",
         (2, 8), "evidence-mode ragged stream launches per process"),
    Knob("MYTHRIL_GPU_COALESCE_MS", "float", 6.0, "ragged",
         (2.0, 12.0), "coalescing window in milliseconds"),
    # derived: 16 on the host backend and the bucketed path, 64 on the
    # ragged path (scheduler.DEFAULT_COALESCE_MAX[_RAGGED])
    Knob("MYTHRIL_GPU_COALESCE_MAX", "int", None, "ragged",
         (16, 32, 64), "max queries buffered per coalescing window"),
    # settle stage: the host CDCL's share of the round trip
    # derived: 6 s on a card, 2.5 s on the CPU
    Knob("MYTHRIL_GPU_DEVICE_DEADLINE", "float", None, "settle",
         (1.0, 5.0), "device budget per dispatch (host-fallback deadline)"),
    Knob("MYTHRIL_GPU_PREFIX_MEMO_MAX", "int", 32, "settle",
         (16, 64), "prefix-snapshot memo entries per session"),
    Knob("MYTHRIL_GPU_SNAPSHOT_NODE_CAP", "int", 200_000, "settle",
         (100_000, 400_000), "max lowering-cache nodes worth snapshotting"),
    # frontier.fork stage: the batched frontier's symbolic-value lane and
    # the fork epilogue's re-batching
    Knob("MYTHRIL_GPU_FRONTIER_SYMLANE", "int", 1, "frontier.fork",
         (0,), "symbolic-value lanes in the batched frontier (0 = "
         "concrete lanes only: no CALLDATALOAD promotion, no RETURN/"
         "STOP terminals, no structural-replay decode)"),
    Knob("MYTHRIL_GPU_FRONTIER_MULTIPC", "int", 2, "frontier.fork",
         (0, 4), "cross-fork re-batching width: fork-cohort groups "
         "chained through their next dense run per fork step (0 = "
         "every cohort re-enters the worklist)"),
    # serve: the cross-request batch
    Knob("MYTHRIL_GPU_SERVE_BATCH", "int", 4, "serve",
         (2, 8), "requests per interleaved serve batch"),
)

_BY_ENV = {knob.env: knob for knob in KNOBS}


def knob(env: str) -> Optional[Knob]:
    return _BY_ENV.get(env)


def knob_names() -> Tuple[str, ...]:
    return tuple(_BY_ENV)


def validate_knobs(mapping) -> bool:
    """True iff every (name, value) pair names a registered knob with a
    plausible value for its kind: the tuned-profile apply gate. Numeric
    knobs take int or float; "str" (categorical) knobs one of their
    registered candidate strings."""
    if not isinstance(mapping, dict) or not mapping:
        return False
    for name, value in mapping.items():
        registered = _BY_ENV.get(name)
        if registered is None:
            return False
        if registered.kind == "str":
            if not isinstance(value, str) or value not in registered.candidates:
                return False
        elif isinstance(value, bool) or not isinstance(value, (int, float)):
            return False
    return True


def resolved_config() -> dict:
    """{env name: {"value": resolved, "source": env|cli|tuned|default}}
    for every registered knob: the configuration stamp the stats JSON and
    the heartbeat snapshots carry, so every run names the schedule that
    produced it."""
    out = {}
    for entry in KNOBS:
        value, source = resolve_source(entry.env, entry.default, entry.kind)
        out[entry.env] = {"value": value, "source": source}
    return out


def gap_ordered(stages: Sequence[str]) -> Tuple[Knob, ...]:
    """Knobs reordered by the given roofline gap ranking: knobs whose stage
    appears in `stages` first (in that stage order, registry order within
    a stage), every other after them in registry order."""
    rank = {stage: idx for idx, stage in enumerate(stages)}
    return tuple(sorted(
        KNOBS, key=lambda k: (rank.get(k.stage, len(rank)),
                              KNOBS.index(k))))
