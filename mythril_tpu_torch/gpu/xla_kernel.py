"""K2, the XLA-semantics ragged round: a CUDA kernel for Hopper and its
plain PyTorch version.

Replaces mythril_tpu/tpu/circuit.py `run_round_ragged` (:557, with
`_walk_ragged` :517 and `_simulate` :398). That is an XLA program, not a
Pallas kernel: the JAX package's round over a window's cones in one
RaggedStream padded to its 1.5x shape bucket, which it runs by default off
a TPU and falls back to past the Pallas round's capacities. Here it is the
round of the xla kernel mode (MYTHRIL_GPU_KERNEL=xla) and the fallback of
the pallas mode for a stream past one of K1's capacities. K2 has no
capacities: any V1, cone slots, roots per cone, levels (up to MAX_LEVELS)
and row width.

Operands (XlaStream, built once per stream by device_stream): the
RaggedStream's tensors, int32 and contiguous on x's device: out_idx,
a_var, a_neg, b_var, b_neg [L, W]; ga_var, ga_neg, gb_var, gb_neg,
is_gate [V1]; root_var, root_neg, root_mask [C, R]; level_rows [L], the
columns of each level up to its last real gate (0 for a level of padding
alone); and the kernel's per-cone tables (xla_layout). x is [lanes, V1]
int32 in {0, 1}.

Per step and restart lane, the reference's semantics: x[:, 0] = 0;
simulate level by level (a cell whose out_idx is 0 is padding, which
writes 0 into var 0: skipped); per cone, found |= no violated root
(sticky); pick one violated root; a found cone parks its walk on var 0;
walk back from the root with want = 1 ^ root_neg for at most walk_depth
gates; then one flip per (lane, cone), written only after every walk of
the lane has read x. A final reset, simulate and check make the returned
x gate-consistent. Returns (x [lanes, V1] int32, found [lanes, C] bool).

The cones of a stream are variable-disjoint pages that share only var 0,
so one combined round is exactly one round per cone over its own page.
The kernel runs it so (csrc/xla_round.cu); xla_layout raises on a stream
where the split would not compute the same.

Randomness: the reference's categorical pick and bernoulli coins are
threefry draws the port cannot reproduce. Both come from K1's counter hash
(ragged_kernel._hash32 and its salts) instead: the pick is the violated
root of maximal hashed key (seed, step, lane, cone, root), the lowest on
ties, which is uniform over the violated roots; the coin at a depth is
the low bit of the hash of (seed, step, lane, cone, depth). The kernel and
its plain version therefore agree bit for bit; models may differ from the
reference's.

  run_round_xla_kernel  the wrapper: checks its operands and, for CUDA
                  tensors, launches csrc/xla_round.cu (built with nvcc at
                  first use into mythril_tpu_torch/_build/). For CPU
                  tensors, and only for those, it runs
  run_round_xla_plain   the same round written with torch tensor ops.
  xla_layout      the kernel's per-cone tables, built on the device once
                  per stream by device_stream (see its note).
  cone_shape      a cone's tier and lanes a word for its page.
  launch_arguments      the kernel's arguments in its order, as the
                  wrapper passes them (the CPU tests read them back the
                  way the kernel does).
"""

import ctypes
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from mythril_tpu_torch.gpu.circuit import TENSOR_KEYS
from mythril_tpu_torch.gpu.circuit_kernel import (
    CHUNK_BYTES,
    CHUNK_STEPS,
    ENTRY_BYTES,
    RING,
    SMEM_CAP,
    STEP_GATES,
    TIERS,
    LaunchShape,
    _align,
    _require,
    _signed,
    launch_shape,
    slot_quads,
)
from mythril_tpu_torch.gpu.ragged_kernel import (
    _C_COIN,
    _C_CONE,
    _C_DEPTH,
    _C_LANE,
    _C_ROOT,
    _C_STEP,
    _hash32,
    _mul32,
    nvcc_library,
)
from mythril_tpu_torch.observe import transfers

LEVEL_KEYS = ("out_idx", "a_var", "a_neg", "b_var", "b_neg")
VAR_KEYS = ("ga_var", "ga_neg", "gb_var", "gb_neg", "is_gate")
ROOT_KEYS = ("root_var", "root_neg", "root_mask")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "xla_round.cu")

# The kernel's launch, mirrored in csrc/xla_round.cu: a block of THREADS
# threads (its 16 warps pack the cone's page of x in and out, warp 0 runs
# the round) serves one cone and one group of restart lanes, bit-sliced
# into a word per variable. The stream's slots, the ring and the tiers are
# K3's (circuit_kernel). A second kernel of COPY_THREADS threads a block
# copies the variables past the last page through, resets var 0 and marks
# the padding cone slots found.
THREADS = 512
COPY_THREADS = 256
# a cone's row of the layout's header: csrc/xla_round.cu's struct Cone
CONE_FIELDS = ("base", "v1", "v1p", "tier", "lanes_per_word", "resident",
               "rec_off", "stream_off", "stream_steps", "chunks",
               "root_off", "root_count")
# the kernel's arguments, in order: the layout's tables, x in and out,
# found, the global tier's x words, then the sizes
POINTER_ARGS = ("cones", "records", "stream_table", "roots", "x_in",
                "x_out", "found", "x_work")
INT_ARGS = ("lanes", "v1", "num_cones", "cone_slots", "page_end", "blocks",
            "smem_bytes", "steps", "walk_depth")
# seed (an unsigned int), then the cudaStream_t
ARG_ORDER = POINTER_ARGS + INT_ARGS + ("seed", "stream")
_FIELD = {name: k for k, name in enumerate(CONE_FIELDS)}

# kernel launches since the last reset (the plain version never counts)
launches = 0


class XlaLayout(NamedTuple):
    """xla_layout's tables on the stream's device, and what a launch needs
    of them on the host."""
    cones: torch.Tensor    # int32 [cones, CONE_FIELDS]: the header
    records: torch.Tensor  # int32 [words]: every cone's, concatenated
    stream: torch.Tensor   # int32 [steps, 2, 32, 4]: every cone's
    roots: torch.Tensor    # int32 [roots]: every cone's
    header: np.ndarray     # int64 [cones, CONE_FIELDS]: cones, on the host
    page_end: int          # one past the last page's last variable
    smem_bytes: int        # a block's dynamic shared memory: the most a
                           # cone needs

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (
            self.cones, self.records, self.stream, self.roots)))


class XlaStream(NamedTuple):
    """One RaggedStream's tensors on a device, as K2 reads them."""

    tensors: dict             # circuit.TENSOR_KEYS
    level_rows: torch.Tensor  # int32 [L]
    num_cones: int            # live cones (the rest of C is padding slots)
    layout: XlaLayout = None  # the kernel's tables (device_stream)

    @property
    def nbytes(self) -> int:
        """Bytes of the stream's tables and of the kernel's layout on the
        device."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.tensors.values())
                   + self.level_rows.numel() * 4
                   + (self.layout.nbytes if self.layout else 0))


def level_rows(out_idx: np.ndarray) -> np.ndarray:
    """Per level, the columns up to and including its last real gate
    (out_idx > 0); 0 for a level of padding alone."""
    live = np.asarray(out_idx) > 0
    width = live.shape[1]
    last = width - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


# -- the kernel's layout ------------------------------------------------------


def cone_shape(v1: int, stream_steps: int, widest: int = 32) -> LaunchShape:
    """A cone's tier for its page of `v1` local variables (var 0 and the
    page) and a stream of `stream_steps` steps (a multiple of
    CHUNK_STEPS): K3's (circuit_kernel.launch_shape) with at most `widest`
    lanes a word. A word narrower than the tier's keeps x alone in shared
    memory (xshared), the records in global memory."""
    shape = launch_shape(v1, stream_steps)
    if shape.lanes_per_word <= widest or shape.tier == "global":
        return shape
    x_bytes = _align(_align(max(v1, 1), 4) * widest // 8, 16)
    stream = stream_steps * STEP_GATES * ENTRY_BYTES
    resident = x_bytes + stream <= SMEM_CAP
    return LaunchShape("xshared", widest, resident, x_bytes + (
        stream if resident else RING * CHUNK_BYTES))


def xla_layout(tensors: dict, pages, widest: int = 32) -> XlaLayout:
    """The kernel's tables of one stream, built on its device: the stream
    split into its cones, each over its own page with its variables
    renumbered (combined base + v - 1 is local v; var 0 stays 0). Per
    cone, at its offsets into the concatenated tables (its header row,
    CONE_FIELDS):

      records  a record per local variable, K3's (circuit_layout): 16-bit
               literal pairs in one int32 a variable (v1p of them) in the
               shared32 and shared16 tiers, int32 pairs past them; a
               variable that is not a gate points at itself (is_gate
               folded in); each cone's records start on 16 bytes;
      stream   the real-gate stream in K3's slots, in local variables:
               the levels that hold a live cell of this cone paired in
               order, each pair's cells in steps of STEP_GATES, padded
               with empty steps to whole chunks (CHUNK_STEPS); byte
               offsets into x at the cone's word;
      roots    up to the cone's last live root (one at least), var << 2
               | neg << 1 | live in local variables, 0 for a masked one.

    The tier (cone_shape) is the cone's own, at most `widest` lanes a
    word. The bucket's padding and the padding cone slots are never
    read. Raises ValueError on a stream the per-cone rounds would not
    compute exactly: a live cell, a gate's record or a live root that
    leaves its cone's page (var 0 apart), a gate outside every page, a
    padding cone slot with a live root, and K3's checks (indices in
    range, negations 0 or 1, a cell equal to its out variable's record,
    one live cell an out variable, a cell reading only lower levels, a
    gate's first child not itself)."""
    out_idx = tensors["out_idx"]
    device = out_idx.device
    levels = out_idx.shape[0]
    v1 = tensors["is_gate"].shape[0]
    slots = tensors["root_var"].shape[0]
    count = len(pages)
    if not 0 < count <= slots:
        raise ValueError(f"xla_layout: {count} pages for {slots} cone "
                         f"slots")
    page_end = 1
    for base, size in pages:
        if base != page_end or size < 0 or size >= 1 << 27:
            raise ValueError(f"xla_layout: the pages {list(pages)} do not "
                             f"tile the variables from 1 (under 2^27 a "
                             f"page)")
        page_end += size
    if page_end > v1:
        raise ValueError(f"xla_layout: the pages end at {page_end}, past "
                         f"V1 {v1}")
    cone_ids = torch.arange(count, device=device)
    var_ids = torch.arange(v1, device=device)
    paged = var_ids[1:page_end]
    cone_of = torch.full((v1,), -1, dtype=torch.long, device=device)
    cone_of[1:page_end] = torch.repeat_interleave(cone_ids, torch.tensor(
        [size for _base, size in pages], device=device))
    page_base = torch.tensor([base for base, _size in pages], device=device)
    local_of = torch.zeros((v1,), dtype=torch.long, device=device)
    local_of[1:page_end] = paged + 1 - page_base[cone_of[1:page_end]]

    li, wi = (out_idx > 0).nonzero(as_tuple=True)
    cell = {key: tensors[key][li, wi].long() for key in LEVEL_KEYS}
    o, a, b = cell["out_idx"], cell["a_var"], cell["b_var"]
    an, bn = cell["a_neg"], cell["b_neg"]
    is_gate = tensors["is_gate"] == 1
    ga, gb = tensors["ga_var"].long(), tensors["gb_var"].long()
    gan, gbn = tensors["ga_neg"].long(), tensors["gb_neg"].long()
    root_live = tensors["root_mask"] == 1
    root_var = tensors["root_var"].long()
    root_neg = tensors["root_neg"].long()

    def in_range(t):
        return (t >= 0) & (t < v1)

    def is_bit(t):
        return (t == 0) | (t == 1)

    # the ranges first: the gathers below index with these values
    _require([
        ("a live cell's variables lie in [0, V1)",
         in_range(o) & in_range(a) & in_range(b)),
        ("a live cell's negations are 0 or 1", is_bit(an) & is_bit(bn)),
        ("a gate's children lie in [0, V1), its negations are 0 or 1",
         ~is_gate | (in_range(ga) & in_range(gb) & is_bit(gan)
                     & is_bit(gbn))),
        ("a live root's variable lies in [0, V1), its negation is 0 or 1",
         ~root_live | (in_range(root_var) & is_bit(root_neg))),
        ("a padding cone slot has no live root", ~root_live[count:]),
    ], "xla_layout")
    cc = cone_of[o]  # each live cell's cone

    def own_page(var, cone):
        return (cone_of[var] == cone) | (var == 0)

    level_of = torch.full((v1,), -1, dtype=torch.long, device=device)
    level_of[o] = li
    _require([
        ("a live cell's out variable lies in a cone's page", cc >= 0),
        ("a live cell reads only its own cone's page and var 0",
         own_page(a, cc) & own_page(b, cc)),
        ("a gate lies in a cone's page", ~is_gate | (cone_of >= 0)),
        ("a gate's children lie in its own cone's page or are var 0",
         ~is_gate | (own_page(ga, cone_of) & own_page(gb, cone_of))),
        ("a live root lies in its own cone's page or is var 0",
         ~root_live[:count] | own_page(root_var[:count], cone_ids[:, None])),
        ("a live cell's out variable is a gate (is_gate 1)", is_gate[o]),
        ("a live cell's children equal its out variable's gate record",
         (ga[o] == a) & (gan[o] == an) & (gb[o] == b) & (gbn[o] == bn)),
        ("an out variable has one live cell",
         torch.bincount(o, minlength=v1) <= 1),
        ("a cell reads only variables of lower levels",
         (level_of[a] < li) & (level_of[b] < li)),
        ("a gate's first child is not itself", ~is_gate | (ga != var_ids)),
    ], "xla_layout")

    # the records in local variables: a gate's two literals, a non-gate
    # pointing at itself
    lit_a = torch.where(is_gate, 2 * local_of[ga] + gan, 2 * local_of)
    lit_b = torch.where(is_gate, 2 * local_of[gb] + gbn, 2 * local_of)

    # the stream: each cone's levels with a live cell paired in order; a
    # cell's rank within its (cone, pair) -> (step, slot)
    has = torch.zeros((count, levels), dtype=torch.bool, device=device)
    has[cc, li] = True
    real = torch.cumsum(has.long(), 1) - 1  # rank among the cone's levels
    own = real[cc, li]
    second = own % 2
    group = cc * levels + own // 2
    # by (cone, pair), then by level and column: a pair's first level first
    order = torch.sort(group, stable=True).indices
    li, o, a, b, an, bn, cc, own, second, group = (
        t[order] for t in (li, o, a, b, an, bn, cc, own, second, group))
    counts = torch.bincount(group, minlength=count * levels)
    rank = torch.arange(len(group), device=device) \
        - (torch.cumsum(counts, 0) - counts)[group]
    per_pair = ((counts + STEP_GATES - 1) // STEP_GATES).reshape(
        count, levels)
    ends = torch.cumsum(per_pair, 1)
    # a cone's roots run to its last live one, and hold one at least: a
    # lane that walks nothing still reads its cone's first root
    root_rows = root_live[:count]
    last = torch.where(root_rows, torch.arange(
        1, root_rows.shape[1] + 1, device=device), 0).amax(1).clamp(min=1)
    steps_of, last_of = transfers.to_list(torch.stack((ends[:, -1], last)),
                                          "xla.shape")

    # each cone's shape, offsets and header row, on the host
    header = np.zeros((count, len(CONE_FIELDS)), dtype=np.int64)
    rec_at = stream_at = root_at = smem = 0
    for c, ((base, size), steps, roots) in enumerate(
            zip(pages, steps_of, last_of)):
        page_v1 = size + 1
        v1p = _align(page_v1, 4)
        padded = _align(steps, CHUNK_STEPS)
        shape = cone_shape(page_v1, padded, widest)
        smem = max(smem, shape.smem_bytes)
        header[c] = (base, page_v1, v1p, TIERS.index(shape.tier),
                     shape.lanes_per_word, int(shape.resident), rec_at,
                     stream_at, steps, padded // CHUNK_STEPS, root_at, roots)
        narrow = shape.tier in ("shared32", "shared16")
        rec_at += _align(v1p if narrow else 2 * page_v1, 4)
        stream_at += padded
        root_at += roots
    column = {name: torch.as_tensor(header[:, k], device=device)
              for name, k in _FIELD.items()}

    step = column["stream_off"][cc] + (ends - per_pair).reshape(-1)[group] \
        + rank // STEP_GATES
    slot = rank % STEP_GATES

    def operand(child):
        """The two local literals whose AND is the child's value: its
        gate's own inputs where the child lies on the first level of this
        second-level cell's pair, else the child's variable twice."""
        at = level_of[child]
        first = (second == 1) & (at >= 0) \
            & (real[cc, at.clamp(min=0)] == own - 1)
        itself = 2 * local_of[child]
        return (torch.where(first, lit_a[child], itself),
                torch.where(first, lit_b[child], itself))

    # K3's slots at the cone's word
    stream = torch.zeros((max(stream_at, 1), 2, STEP_GATES, 4),
                         dtype=torch.long, device=device)
    stream[step, 0, slot], stream[step, 1, slot] = slot_quads(
        column["lanes_per_word"][cc] // 8, local_of[o],
        2 * local_of[a] + an, 2 * local_of[b] + bn, operand(a), operand(b),
        second)
    pair_end = (column["stream_off"][:, None] + ends - 1)[per_pair > 0]
    stream[pair_end, 0, :, 0] |= 1 << 30
    stream = _signed(stream, 32).to(torch.int32)

    # the records at each cone's offset: local var u at rec_off + u
    # (narrow) or rec_off + 2u (wide); each cone's var 0 stays 0 (itself)
    records = torch.zeros((max(rec_at, 4),), dtype=torch.long, device=device)
    owner = cone_of[1:page_end]
    narrow = column["tier"][owner] < TIERS.index("xshared")
    at = column["rec_off"][owner] + torch.where(
        narrow, local_of[paged], 2 * local_of[paged])
    pa, pb = lit_a[paged], lit_b[paged]
    records[at[narrow]] = (pa | pb << 16)[narrow]
    records[at[~narrow]] = pa[~narrow]
    records[at[~narrow] + 1] = pb[~narrow]
    records = _signed(records, 32).to(torch.int32)

    # the roots up to each cone's last live one, in cone order; a masked
    # root is 0
    take = torch.arange(root_rows.shape[1], device=device)[None, :] \
        < last[:, None]
    roots = torch.where(root_rows, local_of[root_var[:count]] << 2
                        | root_neg[:count] << 1 | 1, 0)[take]
    return XlaLayout(torch.as_tensor(header, dtype=torch.int32).to(device),
                     records.contiguous(), stream.contiguous(),
                     roots.to(torch.int32).contiguous(), header, page_end,
                     smem)


def launch_blocks(layout: XlaLayout, lanes: int):
    """(blocks, x_work words) of a launch at `lanes` restart lanes: a block
    a (cone, group of a word's lanes) in cone order, and v1p words a block
    of the global tier, as the kernel counts them."""
    header = layout.header
    groups = -(-lanes // header[:, _FIELD["lanes_per_word"]])
    work = groups * header[:, _FIELD["v1p"]] * (
        header[:, _FIELD["tier"]] == TIERS.index("global"))
    return int(groups.sum()), int(work.sum())


def device_stream(stream, device, widest: int = 32) -> XlaStream:
    """Upload one assembled RaggedStream once, and build the kernel's
    layout beside it (xla_layout, at most `widest` lanes a word); rounds
    then reuse the resident tables."""
    tensors = {key: torch.as_tensor(np.ascontiguousarray(
        stream.tensors[key], dtype=np.int32)).to(device)
        for key in TENSOR_KEYS}
    rows = torch.as_tensor(level_rows(stream.tensors["out_idx"])).to(device)
    return XlaStream(tensors=tensors, level_rows=rows,
                     num_cones=int(stream.num_cones),
                     layout=xla_layout(tensors, stream.pages, widest))


# -- the plain PyTorch version ----------------------------------------------


def run_round_xla_plain(xs: XlaStream, x: torch.Tensor, seed: int,
                        steps: int, walk_depth: int, walks=None):
    """The round written with torch tensor ops on x's device: `steps`
    iterations of simulate, per-cone check and pick, justification walk
    and one flip per (lane, cone); then a final simulate and check.
    Returns (x [lanes, V1] int32, found [lanes, C] bool).

    `walks`, when a list, gets one (gates descended [lanes, C] int64,
    walked [lanes, C] bool) pair a step: the length of each cone's walk
    in each lane, and whether it walked (the cone was not found). Nothing
    else changes."""
    tensors = xs.tensors
    lanes = x.shape[0]
    device = x.device
    levels = []
    for level, rows in enumerate(transfers.to_list(xs.level_rows,
                                                   "xla.rows")):
        if not rows:
            continue
        live = tensors["out_idx"][level, :rows] > 0
        cells = {key: tensors[key][level, :rows][live] for key in LEVEL_KEYS}
        levels.append((cells["out_idx"].long(), cells["a_var"].long(),
                       cells["a_neg"], cells["b_var"].long(),
                       cells["b_neg"]))
    ga_var, gb_var = tensors["ga_var"].long(), tensors["gb_var"].long()
    ga_neg, gb_neg = tensors["ga_neg"], tensors["gb_neg"]
    is_gate = tensors["is_gate"]
    root_var = tensors["root_var"].long()
    root_neg = tensors["root_neg"]
    root_mask = tensors["root_mask"]
    cones, roots = root_var.shape
    lane_cone_salt = (
        _mul32(torch.arange(lanes, device=device, dtype=torch.int64),
               _C_LANE)[:, None]
        ^ _mul32(torch.arange(cones, device=device, dtype=torch.int64),
                 _C_CONE)[None, :])                              # [L, C]
    root_salt = _mul32(torch.arange(roots, device=device,
                                    dtype=torch.int64), _C_ROOT)  # [R]
    seed32 = int(seed) & 0x7FFFFFFF

    def simulate(x):
        x[:, 0] = 0
        for out, a, an, b, bn in levels:
            x[:, out] = (x[:, a] ^ an) & (x[:, b] ^ bn)

    def violated(x):
        vals = x[:, root_var.reshape(-1)].reshape(lanes, cones, roots)
        return ((vals ^ root_neg) == 0) & (root_mask == 1)

    x = x.clone()
    found = torch.zeros((lanes, cones), dtype=torch.bool, device=device)
    for step in range(steps):
        simulate(x)
        viol = violated(x)
        found |= ~viol.any(dim=2)
        step_key = _hash32(seed32 ^ _mul32(step, _C_STEP))
        keys = _hash32(step_key ^ lane_cone_salt[:, :, None] ^ root_salt)
        keyed = torch.where(viol, keys >> 1, torch.full_like(keys, -1))
        choice = keyed.argmax(dim=2, keepdim=True)  # first max: lowest root
        start_var = root_var.expand(lanes, -1, -1).gather(2, choice)[..., 0]
        start_neg = root_neg.expand(lanes, -1, -1).gather(2, choice)[..., 0]
        # found cones park their walk on var 0 (not a gate)
        cur = torch.where(found, torch.zeros_like(start_var), start_var)
        want = 1 ^ start_neg
        done = torch.zeros_like(found)
        length = torch.zeros_like(cur)
        coin_base = (step_key ^ _C_COIN) ^ lane_cone_salt
        for depth in range(walk_depth):
            is_g = (is_gate[cur] == 1) & ~done
            av_i, bv_i = ga_var[cur], gb_var[cur]
            an, bn = ga_neg[cur], gb_neg[cur]
            av = x.gather(1, av_i) ^ an
            bv = x.gather(1, bv_i) ^ bn
            justified = (av & bv) == want
            coin = (_hash32(coin_base ^ _mul32(depth, _C_DEPTH)) & 1) == 1
            choose_b1 = ((av == 1) & (bv == 0)) | ((av == 0) & (bv == 0)
                                                   & coin)
            choose_b0 = ((av == 0) & (bv == 1)) | ((av == 1) & (bv == 1)
                                                   & coin)
            choose_b = torch.where(want == 1, choose_b1, choose_b0)
            active = is_g & ~justified
            length += active
            cur = torch.where(active, torch.where(choose_b, bv_i, av_i), cur)
            want = torch.where(active,
                               want ^ torch.where(choose_b, bn, an), want)
            done = done | ~is_g | justified
            # every walk has ended: later depths change nothing
            if depth % 8 == 7 and bool(done.all()):
                break
        if walks is not None:
            walks.append((length, ~found))
        # every walk read x before any flip; a flip of var 0 is reset
        # before anything reads it
        new_val = torch.where(found, x.gather(1, cur), want)
        x.scatter_(1, cur, new_val)
    simulate(x)
    found |= ~violated(x).any(dim=2)
    return x, found


# -- the CUDA kernel ----------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def build_kernel() -> dict:
    """Compile csrc/xla_round.cu with nvcc into _build/ (skipped when the
    library is newer than its source) and load it. Returns {"seconds":
    build wall, "ptxas": the compiler's resource report}."""
    global _lib
    with _lib_lock:
        start = time.monotonic()
        so_path, ptxas = nvcc_library(KERNEL_SOURCE, "xla_round")
        if _lib is None:
            lib = ctypes.CDLL(so_path)
            ptr = ctypes.c_void_p
            lib.xla_round_launch.restype = ctypes.c_int
            lib.xla_round_launch.argtypes = (
                [ptr] * len(POINTER_ARGS) + [ctypes.c_int] * len(INT_ARGS)
                + [ctypes.c_uint, ptr])
            lib.xla_round_error_string.restype = ctypes.c_char_p
            lib.xla_round_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return {"seconds": time.monotonic() - start, "ptxas": ptxas}


def _check_operands(xs: XlaStream, x: torch.Tensor):
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int32 [lanes, V1] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    lanes, v1 = x.shape
    if not lanes or v1 < 2:
        raise ValueError(f"x of shape {tuple(x.shape)} holds no variable")
    if x.numel() >= 1 << 31:
        raise ValueError(f"x of {x.numel()} cells is too large")
    levels, width = xs.tensors["out_idx"].shape
    cones, roots = xs.tensors["root_var"].shape
    shapes = {key: (levels, width) for key in LEVEL_KEYS}
    shapes.update({key: (v1,) for key in VAR_KEYS})
    shapes.update({key: (cones, roots) for key in ROOT_KEYS})
    arrays = dict(xs.tensors, level_rows=xs.level_rows)
    shapes["level_rows"] = (levels,)
    for key, shape in shapes.items():
        array = arrays.get(key)
        if not isinstance(array, torch.Tensor) or array.device != x.device \
                or array.dtype != torch.int32 or not array.is_contiguous() \
                or tuple(array.shape) != shape:
            raise ValueError(
                f"{key} must be a contiguous int32 {shape} tensor on "
                f"{x.device} (device_stream)")
    if not levels or not width or not cones or not roots:
        raise ValueError(f"empty tables: levels {levels}, width {width}, "
                         f"cones {cones}, roots {roots}")
    if not 0 <= xs.num_cones <= cones:
        raise ValueError(f"{xs.num_cones} live cones of {cones} slots")
    layout = xs.layout
    if layout is not None and (
            not isinstance(layout, XlaLayout)
            or layout.cones.device != x.device
            or tuple(layout.cones.shape) != (xs.num_cones, len(CONE_FIELDS))
            or layout.page_end > v1):
        raise ValueError(f"layout must be the xla_layout of these tables "
                         f"({xs.num_cones} cones, V1 {v1}) on {x.device}")


def launch_arguments(xs: XlaStream, x: torch.Tensor, x_out: torch.Tensor,
                     found: torch.Tensor, x_work, seed: int, steps: int,
                     walk_depth: int, stream=None) -> dict:
    """The kernel's arguments by name, in ARG_ORDER: data pointers (x_work
    None: no cone of the global tier), then the sizes the kernel indexes
    with (x's and found's row strides are `v1` and `cone_slots`; the
    layout's offsets are in its header, `cones`), the blocks and shared
    memory of the launch (launch_blocks, the layout's smem_bytes), the
    seed and the CUDA stream (None: the default stream)."""
    layout = xs.layout
    blocks, _work = launch_blocks(layout, x.shape[0])
    pointers = {"cones": layout.cones, "records": layout.records,
                "stream_table": layout.stream, "roots": layout.roots,
                "x_in": x, "x_out": x_out, "found": found}
    args = {key: tensor.data_ptr() for key, tensor in pointers.items()}
    args.update(x_work=None if x_work is None else x_work.data_ptr(),
                lanes=x.shape[0], v1=x.shape[1], num_cones=xs.num_cones,
                cone_slots=xs.tensors["root_var"].shape[0],
                page_end=layout.page_end, blocks=blocks,
                smem_bytes=layout.smem_bytes, steps=max(int(steps), 0),
                walk_depth=max(int(walk_depth), 0),
                seed=int(seed) & 0x7FFFFFFF, stream=stream)
    return {key: args[key] for key in ARG_ORDER}


def run_round_xla_kernel(xs: XlaStream, x: torch.Tensor, seed: int,
                         steps: int, walk_depth: int):
    """Advance the restart lanes of one uploaded stream by `steps`
    sim+flip iterations. Returns (x [lanes, V1] int32, found [lanes, C]
    bool): slice found[:, :num_cones].

    CPU tensors run run_round_xla_plain; CUDA tensors launch the CUDA
    kernel on the current stream over the stream's layout, and a kernel
    that fails to build or to launch raises."""
    global launches
    _check_operands(xs, x)
    if x.device.type == "cpu":
        return run_round_xla_plain(xs, x, seed, steps, walk_depth)
    if x.device.type != "cuda":
        raise ValueError(f"no xla round for device {x.device}")
    if xs.layout is None:
        raise ValueError("the stream has no kernel layout: upload it with "
                         "device_stream")
    if _lib is None:
        build_kernel()
    lanes = x.shape[0]
    x_out = torch.empty_like(x)
    found = torch.empty((lanes, xs.tensors["root_var"].shape[0]),
                        dtype=torch.bool, device=x.device)
    _blocks, work = launch_blocks(xs.layout, lanes)
    x_work = torch.empty((work,), dtype=torch.int32, device=x.device) \
        if work else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.xla_round_launch(*launch_arguments(
            xs, x, x_out, found, x_work, seed, steps, walk_depth,
            stream).values())
    if status != 0:
        raise RuntimeError("xla_round launch failed: "
                           + _lib.xla_round_error_string(status).decode())
    launches += 1
    return x_out, found


def reset_launches() -> None:
    global launches
    launches = 0
