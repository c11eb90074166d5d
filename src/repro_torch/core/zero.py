"""ZeRO-1 over the arena (`repro/core/zero.py`, its row-range half): the
flat (rows, LANES) arena makes ZeRO-1 a shard of one buffer. `shard_rows`
splits it into equal, kernel-block-aligned row ranges; rank k of M owns
rows [k*R/M, (k+1)*R/M) of every row-indexed state column (m, the v
payload and every codec's scale column, core/state_store.py), so the
collectives are one gradient reduce-scatter per fold and one param
all-gather per apply over the same ranges (core/dp_shardmap.py).

The bucketed form (`zero1_bucket_plan`, core/buckets.py; the engine's
default): instead of packing the whole gradient arena for one
reduce-scatter, the schedule streams per-layer and size-capped buckets;
rank k then owns slice k of every bucket rather than one contiguous range,
and the live packed gradient drops from the arena to one bucket. The
buckets tile the same rows, so the volume is the same, less the padding
bucket, which is never sent.

With AdamA this is the paper's Table-3 "ZeRO-S1 + AdamA": activations
1/N (micro-batching), gradients transient (the fold), optimizer state 1/M.

The reference's GSPMD helpers (`zero1_state_sharding`,
`zero1_arena_pspec`) are ROADMAP queue 1, item 10.4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.arena import ROW_ALIGN
from repro_torch.kernels.fused_step import BLOCK_ROWS


@dataclass(frozen=True)
class RowShard:
    """One rank's contiguous row range of the arena (and of every other
    row-indexed state column)."""
    index: int
    start: int
    rows: int

    @property
    def stop(self) -> int:
        return self.start + self.rows


def shard_rows(layout, n_shards: int) -> Tuple[RowShard, ...]:
    """Split the arena into `n_shards` equal, kernel-block-aligned row
    ranges. Each range keeps the fold and apply kernels' divisibility
    contract on its own, so a shard is an arena in its own right: rank k
    runs the ordinary fold and apply over rows [k*R/M, (k+1)*R/M).

    Raises ValueError when the layout was not built for this shard count;
    the fix is `build_layout(tree, n_shards=M)`, which pads the tail."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rows = layout.rows
    if rows % n_shards:
        raise ValueError(
            f"arena rows ({rows}) not divisible into {n_shards} equal "
            f"shards; rebuild the layout with build_layout(tree, "
            f"n_shards={n_shards}) to pad the tail")
    per = rows // n_shards
    if per % ROW_ALIGN or (per > BLOCK_ROWS and per % BLOCK_ROWS):
        raise ValueError(
            f"shard size {per} violates kernel block alignment "
            f"(ROW_ALIGN={ROW_ALIGN}, BLOCK_ROWS={BLOCK_ROWS}); rebuild the "
            f"layout with build_layout(tree, n_shards={n_shards})")
    return tuple(RowShard(k, k * per, per) for k in range(n_shards))


def zero1_bucket_plan(layout, n_shards: int, max_bucket_rows: int = 0,
                      tp_shards: int = 1):
    """The bucket schedule over a layout built for `n_shards` (x
    `tp_shards`) ranks: a bucket per layer of each stacked region, size-
    capped buckets over the rest region (`max_bucket_rows=0`: the default
    cap, core/buckets.py). Raises ValueError, as `shard_rows` does, when
    the layout was not built with build_layout(tree, n_shards=...,
    tp_shards=...)."""
    from repro_torch.core.buckets import plan_buckets
    return plan_buckets(layout, n_shards,
                        max_bucket_rows=max_bucket_rows or None,
                        tp_shards=tp_shards)
