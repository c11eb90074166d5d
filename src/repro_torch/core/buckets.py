"""Bucketed ZeRO-1 (`repro/core/buckets.py`): kernel-block-aligned,
shard-divisible row buckets over an ArenaLayout, so that the data-parallel
engine (core/dp_shardmap.py) reduce-scatters each micro-batch's gradient
one bucket at a time instead of packing the whole gradient arena first.

A bucket is a contiguous arena row range whose row count splits into
`n_shards` equal ROW_ALIGN-aligned slices. The reduce-scatter of a
bucket's gradient slab hands rank k the fully reduced slice k; rank k folds
it into its owned state block at the bucket's `own_offset` with one slice
fold (kernels/fused_step.arena_fold_slice), and the slab is dead. The
live packed gradient is one bucket, not the arena.

Ownership (the partition order): rank k owns slice k OF EVERY BUCKET, so
its state block holds, at shard-local row `bucket.own_offset`, arena rows

    [bucket.start + k * slice_rows, bucket.start + (k + 1) * slice_rows).

The ranks' blocks in rank order are therefore a fixed permutation of
arena row order; `partition_index` records it, `unpermute_rows` and
`unpermute_state` undo it (the engine unpermutes the all-gathered params
into the leaves, so params and losses equal the full-pack schedule's bit
for bit; only the resident order of the sharded state differs).

Bucket granularity:
  stacks   one bucket per layer: the unit Algorithm 2 emits in its
           backward. build_layout pads layer_rows to region_grain(n_shards),
           so a layer always divides.
  rest     size-capped buckets (the embedding and lm_head are large) cut at
           shard-divisible rows, a cut inside a leaf allowed.
  padding  the tail past the rest region: owned (so the offsets tile a
           shard) but never folded, zero gradients into zero state being a
           bitwise no-op.

The reference's `pack_bucket_fp8` belongs to the fp8 wire's quantized
collectives (ROADMAP queue 1, item 10.3).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core.arena import ROW_ALIGN, ArenaLayout
from repro_torch.kernels.fused_step import BLOCK_ROWS, LANES

# the default rest-region bucket cap: 4096 rows = 16 MiB of fp32 slab
DEFAULT_BUCKET_ROWS = 4096


@dataclass(frozen=True)
class Bucket:
    """One contiguous arena row range of the schedule."""
    start: int           # first arena row
    rows: int            # rows % (n_shards * ROW_ALIGN) == 0
    slice_rows: int      # rows // n_shards: what each rank receives
    own_offset: int      # shard-local row where this bucket's slice lands
    kind: str            # "stack" | "rest" | "pad"
    name: str = ""       # the stack's name for kind == "stack"
    layer_lo: int = -1   # stack buckets: layers [layer_lo, layer_hi)
    layer_hi: int = -1
    has_grad: bool = True  # False: padding, never folded
    # the slice fold's row block for this bucket: the largest divisor of
    # slice_rows and own_offset, at most BLOCK_ROWS (per bucket: one odd
    # rest bucket would otherwise shrink every fold's block)
    fold_block: int = ROW_ALIGN

    @property
    def stop(self) -> int:
        return self.start + self.rows


@dataclass(frozen=True)
class BucketPlan:
    """The static schedule: the buckets tile [0, layout.rows) in arena
    order, their own_offsets [0, shard_rows) in the same order.
    `tp_shards > 1` is the reference's plan for a dp x tp mesh (each
    slice splits into tp_shards aligned sub-slices, `tp_subslice`); no
    engine of the port takes one (ROADMAP queue 1, item 10.4)."""
    layout: ArenaLayout
    n_shards: int
    buckets: Tuple[Bucket, ...]
    tp_shards: int = 1

    @property
    def shard_rows(self) -> int:
        return self.layout.rows // self.n_shards

    def tp_subslice(self, b: Bucket, t: int) -> Tuple[int, int]:
        """(shard-local row offset, rows) of tp sub-slice `t` of a rank's
        slice of bucket `b`."""
        if not 0 <= t < self.tp_shards:
            raise IndexError(f"tp sub-slice {t} out of range "
                             f"[0, {self.tp_shards})")
        sub = b.slice_rows // self.tp_shards
        return b.own_offset + t * sub, sub

    def grad_buckets(self) -> Tuple[Bucket, ...]:
        return tuple(b for b in self.buckets if b.has_grad)

    @property
    def max_grad_bucket_rows(self) -> int:
        return max((b.rows for b in self.grad_buckets()), default=0)

    @property
    def max_grad_bucket_bytes(self) -> int:
        """The largest fp32 slab that enters a reduce-scatter: the
        schedule's live packed-gradient peak."""
        return self.grad_peak_bytes(4)

    def grad_peak_bytes(self, wire_itemsize: int = 4) -> int:
        """The live packed-gradient peak for a wire of `wire_itemsize`
        bytes (bf16 halves it)."""
        return self.max_grad_bucket_rows * LANES * wire_itemsize

    def stack_slice(self, name: str) -> Tuple[int, int, int]:
        """(own_offset of layer 0's slice, slice rows per layer, fold
        block) of a stack: Algorithm 2 folds layer j's slice at own_offset
        + j * slice_rows. The block is the same for every layer:
        gcd(s, base + j*s) == gcd(s, base)."""
        for b in self.buckets:
            if b.kind == "stack" and b.name == name and b.layer_lo == 0:
                return b.own_offset, b.slice_rows, b.fold_block
        raise KeyError(name)


def plan_buckets(layout: ArenaLayout, n_shards: int, *,
                 max_bucket_rows: Optional[int] = None,
                 tp_shards: int = 1) -> BucketPlan:
    """The bucket schedule of `layout` over `n_shards` ranks (and
    `tp_shards`: the cut unit becomes ROW_ALIGN * n_shards * tp_shards).

    Raises ValueError when the layout was not built for this mesh; the fix
    is `build_layout(tree, n_shards=..., tp_shards=...)`, which pads every
    region stride to the mesh's grain."""
    from repro_torch.core.zero import shard_rows
    if tp_shards < 1:
        raise ValueError(f"tp_shards must be >= 1, got {tp_shards}")
    shard_rows(layout, n_shards * tp_shards)  # the total's alignment
    unit = ROW_ALIGN * n_shards * tp_shards
    cap = max_bucket_rows if max_bucket_rows else DEFAULT_BUCKET_ROWS
    cap = max(unit, cap - cap % unit)

    buckets = []
    own = 0

    def add(start, rows, kind, name="", lo=-1, hi=-1, grad=True):
        nonlocal own
        assert rows % unit == 0, (kind, start, rows, unit)
        srows = rows // n_shards
        blk = math.gcd(math.gcd(BLOCK_ROWS, srows), own)
        buckets.append(Bucket(start, rows, srows, own, kind, name,
                              lo, hi, grad, blk))
        own += srows

    for s in layout.stacks:
        if s.layer_rows % unit or s.row % unit:
            raise ValueError(
                f"stack {s.name!r} (layer_rows={s.layer_rows}, row={s.row}) "
                f"is not divisible into {n_shards}x{tp_shards} aligned slices; "
                f"rebuild the layout with build_layout(tree, "
                f"n_shards={n_shards}, tp_shards={tp_shards})")
        for j in range(s.n_layers):
            add(s.row + j * s.layer_rows, s.layer_rows, "stack", s.name,
                j, j + 1)
    rest = layout.rest
    if rest.rows:
        if rest.row % unit or rest.rows % unit:
            raise ValueError(
                f"rest region (row={rest.row}, rows={rest.rows}) is not "
                f"divisible into {n_shards}x{tp_shards} aligned slices; rebuild "
                f"the layout with build_layout(tree, "
                f"n_shards={n_shards}, tp_shards={tp_shards})")
        pos = rest.row
        while pos < rest.row + rest.rows:
            take = min(cap, rest.row + rest.rows - pos)
            add(pos, take, "rest")
            pos += take
    end = rest.row + rest.rows
    if end < layout.rows:
        add(end, layout.rows - end, "pad", grad=False)

    assert own == layout.rows // n_shards, (own, layout.rows, n_shards)
    return BucketPlan(layout, n_shards, tuple(buckets), tp_shards)


# ---------------------------------------------------------------------------
# Gradient slabs, owned rows, and the partition permutation
# ---------------------------------------------------------------------------


def pack_bucket(tree, layout: ArenaLayout, b: Bucket,
                dtype=torch.float32) -> torch.Tensor:
    """One bucket's new (b.rows, LANES) `dtype` slab of a tree: rows
    [b.start, b.stop) of `arena.pack(tree, layout, dtype)`, bit for bit,
    without the rest of the arena."""
    if b.kind == "stack":
        return arena_mod.pack_stack_layers(tree[b.name], layout.stack(b.name),
                                           b.layer_lo, b.layer_hi,
                                           dtype=dtype)
    if b.kind == "rest":
        _, rest_tree = arena_mod.split_tree(tree)
        return arena_mod.pack_rest_rows(rest_tree, layout, b.start, b.stop,
                                        dtype=dtype)
    device = arena_mod.tree_flatten(tree)[0][0].device
    return torch.zeros((b.rows, LANES), dtype=dtype, device=device)


def gather_owned_rows(x: torch.Tensor, plan: BucketPlan,
                      rank: int) -> torch.Tensor:
    """Rank `rank`'s owned rows of an arena-ordered (rows, ...) tensor, in
    partition order: its slice of every bucket, concatenated (new)."""
    return torch.cat([x[b.start + rank * b.slice_rows:
                        b.start + (rank + 1) * b.slice_rows]
                      for b in plan.buckets])


def pack_owned_rows(tree, plan: BucketPlan, rank: int,
                    dtype=torch.float32) -> torch.Tensor:
    """`gather_owned_rows(arena.pack(tree, layout, dtype), plan, rank)`,
    bit for bit, packed one bucket at a time: the whole arena is never
    built, only one bucket beside the (shard_rows, LANES) result."""
    lay = plan.layout
    device = arena_mod.tree_flatten(tree)[0][0].device
    out = torch.zeros((plan.shard_rows, LANES), dtype=dtype, device=device)
    for b in plan.grad_buckets():
        lo = rank * b.slice_rows
        out[b.own_offset:b.own_offset + b.slice_rows] = pack_bucket(
            tree, lay, b, dtype)[lo:lo + b.slice_rows]
    return out


def unpermute_into_(tree, x: torch.Tensor, plan: BucketPlan) -> None:
    """The leaves of `tree` <- their rows of the partition-ordered (rows,
    LANES) `x` (every rank's owned rows in rank order, as an all-gather
    of them gives), in place, one bucket at a time: bit for bit
    `arena.unpack(unpermute_rows(x, plan))`, with no arena-order copy of
    `x` (a bucket's rows are gathered, or viewed at one rank)."""
    lay = plan.layout
    stack_items, rest_tree = arena_mod.split_tree(tree)
    stacks = dict(stack_items)
    s_rows, m = plan.shard_rows, plan.n_shards
    for b in plan.grad_buckets():
        parts = [x[k * s_rows + b.own_offset:
                   k * s_rows + b.own_offset + b.slice_rows]
                 for k in range(m)]
        rows = parts[0] if m == 1 else torch.cat(parts)
        if b.kind == "stack":
            arena_mod.unpack_stack_layers_(stacks[b.name],
                                           lay.stack(b.name), b.layer_lo,
                                           rows)
        else:
            arena_mod.unpack_rest_rows_(rest_tree, lay, b.start, rows)


@functools.lru_cache(maxsize=32)
def partition_index(plan: BucketPlan) -> np.ndarray:
    """perm[arena_row] = partition-order row, partition order being the
    concatenation over ranks k of rank k's owned slices in bucket order
    (what an all-gather of `gather_owned_rows` gives)."""
    perm = np.empty(plan.layout.rows, np.int32)
    s_rows = plan.shard_rows
    for b in plan.buckets:
        for k in range(plan.n_shards):
            a0 = b.start + k * b.slice_rows
            p0 = k * s_rows + b.own_offset
            perm[a0:a0 + b.slice_rows] = np.arange(
                p0, p0 + b.slice_rows, dtype=np.int32)
    perm.flags.writeable = False        # cached: every caller shares it
    return perm


@functools.lru_cache(maxsize=32)
def arena_index(plan: BucketPlan) -> np.ndarray:
    """inv[partition_row] = arena row: the inverse of partition_index."""
    inv = np.argsort(partition_index(plan)).astype(np.int32)
    inv.flags.writeable = False
    return inv


def _take(x: torch.Tensor, index: np.ndarray) -> torch.Tensor:
    return x.index_select(0, torch.from_numpy(index.astype(np.int64))
                          .to(x.device))


def unpermute_rows(x: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    """Partition-order (rows, ...) tensor -> arena order (new; data
    movement only, bit for bit)."""
    return _take(x, partition_index(plan))


def permute_rows(x: torch.Tensor, plan: BucketPlan) -> torch.Tensor:
    """Arena-order (rows, ...) tensor -> partition order, the exact inverse
    of `unpermute_rows`: the resident order of every row-indexed column of
    a bucketed run's state."""
    return _take(x, arena_index(plan))


def _map_rows(state, plan: BucketPlan, row_fn):
    """A new state dict whose arenas' and moments' global row-indexed
    columns (leading dim layout.rows) are row_fn of them; shared columns,
    the step and the scaler pass through."""
    from repro_torch.core.arena import Arena
    from repro_torch.core.state_store import MomentState
    rows = plan.layout.rows

    def fix(x):
        return row_fn(x, plan) if x.ndim >= 1 and x.shape[0] == rows else x

    out = dict(state)
    for k, x in state.items():
        if isinstance(x, Arena):
            out[k] = Arena(fix(x.data), x.layout)
        elif isinstance(x, MomentState):
            out[k] = MomentState(tuple(fix(p) for p in x.parts), x.layout,
                                 x.codec, x.moment)
    return out


def unpermute_state(state, plan: BucketPlan):
    """A bucketed run's GLOBAL state (each row-indexed column whole: every
    rank's rows in rank order) from partition order back to arena order,
    as the full-pack schedule stores it (new columns)."""
    return _map_rows(state, plan, unpermute_rows)


def permute_state(state, plan: BucketPlan):
    """The inverse of `unpermute_state`: arena-order global state -> the
    bucketed schedule's partition order."""
    return _map_rows(state, plan, permute_rows)
