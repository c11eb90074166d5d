"""Flat optimizer-state arena: every leaf of a param tree packed once into
one contiguous (rows, LANES) fp32 buffer with a static layout table, so the
AdamA fold and apply each run as ONE kernel over the whole model. A
gradient tree packs the same way into the gradient wire's dtype (fp32, or
bf16 for the bf16 wire).

The layout is the reference's (`repro/core/arena.py::build_layout`) row for
row, so an arena packed here and one packed there hold the same values at
the same rows:

  [ stack "blocks":   layer 0 | layer 1 | ... | layer L-1 ]
  [ rest: embed | final_norm_* | lm_head | ... ]
  [ tail padding to a BLOCK_ROWS multiple ]

- Leaves are visited in sorted-key order at every level of the dict tree
  (the order `jax.tree.flatten` gives a dict).
- Stacked subtrees (leading layer axis) are packed LAYER-MAJOR: layer j of
  a stack lives at rows `row + j * layer_rows`.
- Each leaf starts on a fresh row; the tail lanes of its last row are zero.
- Every region is padded to `region_grain()` rows, and the total to a
  BLOCK_ROWS multiple once it exceeds BLOCK_ROWS; a layout built for
  ZeRO-1's `n_shards` row ranges is padded further (`build_layout`).

A tree is a nested dict of tensors; a bare tensor is a tree of one leaf.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.kernels.fused_step import BLOCK_ROWS, LANES

# top-level keys holding per-layer stacked subtrees (leading dim = layer)
STACK_KEYS = ("blocks", "dense_blocks", "enc_blocks")

ROW_ALIGN = 8        # every region is 8-row aligned
MIN_SLICE_BLOCK = 64  # minimum row block of the per-layer slice fold

Path = Tuple[str, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(n: int, mult: int) -> int:
    return _cdiv(n, mult) * mult


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def region_grain(n_shards: int = 1) -> int:
    """Row granularity of every region boundary and stride in a layout
    built with `build_layout(tree, n_shards=...)`: the lcm of the
    slice-fold block minimum and the ZeRO-1 scatter unit, n_shards x
    ROW_ALIGN (the reference's `region_grain`)."""
    return _lcm(MIN_SLICE_BLOCK, ROW_ALIGN * max(1, n_shards))


# ---------------------------------------------------------------------------
# Dict trees
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Tuple[Path, ...]]:
    """(leaves, paths) in sorted-key order at every level."""
    if not isinstance(tree, dict):
        return [tree], ((),)
    leaves, paths = [], []
    for k in sorted(tree):
        sub_leaves, sub_paths = tree_flatten(tree[k])
        leaves += sub_leaves
        paths += [(k,) + p for p in sub_paths]
    return leaves, tuple(paths)


def tree_unflatten(paths: Tuple[Path, ...], leaves):
    if paths == ((),):
        return leaves[0]
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def flatten_up_to(tree, paths: Tuple[Path, ...]) -> List[torch.Tensor]:
    leaves, got = tree_flatten(tree)
    if got != paths:
        raise ValueError(f"tree structure {got} does not match the layout's "
                         f"{paths}")
    return leaves


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafSpec:
    """One leaf's slot inside its region (per-layer shape for stacked leaves)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype           # restored on unpack
    row: int                     # row offset inside the region
    rows: int                    # whole rows occupied (= ceil(size/LANES))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class StackSpec:
    name: str
    paths: Tuple[Path, ...]      # leaf paths of the stacked subtree
    n_layers: int
    leaves: Tuple[LeafSpec, ...]
    layer_rows: int              # region_grain-aligned rows per layer
    row: int                     # arena row of layer 0

    @property
    def rows(self) -> int:
        return self.n_layers * self.layer_rows


@dataclass(frozen=True)
class RestSpec:
    paths: Tuple[Path, ...]      # leaf paths of the non-stacked remainder
    leaves: Tuple[LeafSpec, ...]
    row: int
    rows: int                    # region_grain-aligned


@dataclass(frozen=True)
class ArenaLayout:
    stacks: Tuple[StackSpec, ...]
    rest: RestSpec
    rows: int                    # total, padded

    def stack(self, name: str) -> StackSpec:
        for s in self.stacks:
            if s.name == name:
                return s
        raise KeyError(name)

    def slice_block(self, spec) -> int:
        """Row block of the slice fold over `spec` (a StackSpec or the
        RestSpec): it divides the region's stride and every row offset in
        it, so each slice fold's offset and row count are multiples of it.
        Layouts from build_layout pad every region to a region_grain()
        multiple, which keeps it >= MIN_SLICE_BLOCK; a hand-made layout may
        fall below, which is correct but warned about, as the reference
        does."""
        stride = spec.layer_rows if isinstance(spec, StackSpec) else spec.rows
        blk = math.gcd(math.gcd(stride, spec.row), BLOCK_ROWS)
        if blk < MIN_SLICE_BLOCK:
            warnings.warn(f"slice_block={blk} < MIN_SLICE_BLOCK="
                          f"{MIN_SLICE_BLOCK} for the region at row "
                          f"{spec.row} (stride {stride})", stacklevel=2)
        return blk


def _leaf_specs(shapes_dtypes) -> Tuple[Tuple[LeafSpec, ...], int]:
    specs = []
    row = 0
    for shape, dtype in shapes_dtypes:
        rows = max(1, _cdiv(math.prod(shape), LANES))
        specs.append(LeafSpec(tuple(shape), dtype, row, rows))
        row += rows
    return tuple(specs), row


def split_tree(tree):
    """(stack_items, rest_tree): the STACK_KEYS subtrees of a dict tree and
    the remainder; any other tree is entirely rest."""
    if isinstance(tree, dict):
        stack_items = [(k, tree[k]) for k in STACK_KEYS if k in tree]
        rest = {k: v for k, v in tree.items() if k not in STACK_KEYS}
        return stack_items, rest
    return [], tree


def build_layout(tree, n_shards: int = 1, tp_shards: int = 1) -> ArenaLayout:
    """The packed layout of `tree`, the reference's row for row.
    `n_shards > 1` pads it for ZeRO-1 (core/zero.py::shard_rows): every
    region to `region_grain(n_shards)` rows, and the total so that it
    splits into `n_shards` equal ROW_ALIGN-multiple ranges, each a
    BLOCK_ROWS multiple once the total passes BLOCK_ROWS, so that every
    range is an arena the fold and apply kernels take on their own. The
    layout depends only on the product n_shards x `tp_shards` (the
    reference's dp x tp arithmetic; no engine of the port takes tp > 1)."""
    if n_shards < 1 or tp_shards < 1:
        raise ValueError(f"n_shards and tp_shards must be >= 1, got "
                         f"{n_shards} and {tp_shards}")
    n_shards *= tp_shards
    grain = region_grain(n_shards)
    stack_items, rest_tree = split_tree(tree)
    row = 0
    stacks = []
    for name, sub in stack_items:
        leaves, paths = tree_flatten(sub)
        n_layers = int(leaves[0].shape[0])
        for p, x in zip(paths, leaves):
            if x.shape[0] != n_layers:
                raise ValueError(f"stacked leaf {name}/{'/'.join(p)} has "
                                 f"leading dim {x.shape[0]} != {n_layers}")
        specs, used = _leaf_specs([(tuple(x.shape[1:]), x.dtype)
                                   for x in leaves])
        layer_rows = max(grain, _align(used, grain))
        stacks.append(StackSpec(name, paths, n_layers, specs, layer_rows, row))
        row += n_layers * layer_rows
    rleaves, rpaths = tree_flatten(rest_tree)
    rspecs, rused = _leaf_specs([(tuple(x.shape), x.dtype) for x in rleaves])
    rest_rows = _align(rused, grain)
    rest = RestSpec(rpaths, rspecs, row, rest_rows)
    row += rest_rows
    total = _align(row, BLOCK_ROWS) if row > BLOCK_ROWS else max(row, ROW_ALIGN)
    if n_shards > 1:
        per = _align(_cdiv(total, n_shards), ROW_ALIGN)
        if per * n_shards > BLOCK_ROWS:
            per = _align(per, BLOCK_ROWS)
        total = per * n_shards
    return ArenaLayout(tuple(stacks), rest, total)


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------


def _device_of(tree) -> torch.device:
    return tree_flatten(tree)[0][0].device


def _check_pack_dtype(dtype) -> None:
    """The pack helpers CAST (round to nearest even, as XLA's convert
    does). A raw cast to e4m3 (range +-448, 3 mantissa bits) flushes most
    of a gradient to zero or saturates it, so packing straight to fp8 is
    refused, as the reference refuses it (the fp8 wire packs fp32 and then
    encodes codes with per-row scales: ROADMAP queue 1, item 7.5)."""
    if dtype == torch.float8_e4m3fn:
        raise TypeError(
            "cannot pack a tree directly to float8_e4m3fn: an unscaled "
            "cast destroys the gradient. The fp8 wire packs fp32 and then "
            "encodes codes + a per-row scale column (not ported: ROADMAP "
            "queue 1, item 7.5)")


def _fill_region(region: torch.Tensor, leaves, specs) -> None:
    """Copy each leaf (cast to the region's dtype) to its slot of a zeroed
    region, flattened to (..., region_rows * LANES); a leading dim is the
    layer."""
    lead = region.shape[:-1]
    for x, ls in zip(leaves, specs):
        region[..., ls.row * LANES:ls.row * LANES + ls.size].copy_(
            x.reshape(lead + (-1,)))


def pack(tree, layout: ArenaLayout, dtype=torch.float32) -> torch.Tensor:
    """Whole tree -> new (layout.rows, LANES) `dtype` arena on the tree's
    device (leaves cast to `dtype`, layer-major stacks, zero padding).
    `dtype` is the gradient wire's: float32, or bfloat16 for the bf16
    wire, whose slab equals the reference's bit for bit."""
    _check_pack_dtype(dtype)
    stack_items, rest_tree = split_tree(tree)
    arena = torch.zeros((layout.rows, LANES), dtype=dtype,
                        device=_device_of(tree))
    for (name, sub), spec in zip(stack_items, layout.stacks):
        assert name == spec.name, (name, spec.name)
        _fill_region(arena[spec.row:spec.row + spec.rows].view(
            spec.n_layers, spec.layer_rows * LANES),
            flatten_up_to(sub, spec.paths), spec.leaves)
    rest = layout.rest
    if rest.rows:
        _fill_region(arena[rest.row:rest.row + rest.rows].view(-1),
                     flatten_up_to(rest_tree, rest.paths), rest.leaves)
    return arena


def _pack_region(leaves, specs, rows: int, dtype) -> torch.Tensor:
    _check_pack_dtype(dtype)
    region = torch.zeros((rows, LANES), dtype=dtype, device=leaves[0].device)
    _fill_region(region.view(-1), leaves, specs)
    return region


def pack_layer(layer_tree, spec: StackSpec,
               dtype=torch.float32) -> torch.Tensor:
    """One layer's (un-stacked) subtree -> new (layer_rows, LANES) `dtype`
    slab: rows [spec.row + j*layer_rows, ...) of `pack` for that layer j."""
    return _pack_region(flatten_up_to(layer_tree, spec.paths), spec.leaves,
                        spec.layer_rows, dtype)


def pack_rest(rest_tree, layout: ArenaLayout,
              dtype=torch.float32) -> torch.Tensor:
    """The non-stacked remainder -> new (rest.rows, LANES) `dtype` slab:
    rows [rest.row, rest.row + rest.rows) of `pack`."""
    rest = layout.rest
    return _pack_region(flatten_up_to(rest_tree, rest.paths), rest.leaves,
                        rest.rows, dtype)


def pack_stack_layers(stack_tree, spec: StackSpec, j0: int, j1: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Layers [j0, j1) of a stacked subtree -> new ((j1-j0)*layer_rows,
    LANES) `dtype` slab: rows [spec.row + j0*layer_rows, spec.row +
    j1*layer_rows) of `pack`, bit for bit, without the other layers."""
    if not 0 <= j0 < j1 <= spec.n_layers:
        raise ValueError(f"layers [{j0}, {j1}) outside the stack's "
                         f"{spec.n_layers}")
    _check_pack_dtype(dtype)
    leaves = [x[j0:j1] for x in flatten_up_to(stack_tree, spec.paths)]
    region = torch.zeros((j1 - j0, spec.layer_rows * LANES), dtype=dtype,
                         device=leaves[0].device)
    _fill_region(region, leaves, spec.leaves)
    return region.view(-1, LANES)


def _rest_cuts(layout: ArenaLayout, row_lo: int, row_hi: int):
    """(leaf index, leaf element range, range row offset) of each rest leaf
    that arena rows [row_lo, row_hi) of the rest region cut: the leaf's
    elements [e0, e1) lie at element (a - row_lo) * LANES of the range,
    a its first row inside it. A cut may fall inside a leaf."""
    rest = layout.rest
    lo, hi = row_lo - rest.row, row_hi - rest.row
    if not 0 <= lo < hi <= rest.rows:
        raise ValueError(f"rows [{row_lo}, {row_hi}) outside the rest "
                         f"region [{rest.row}, {rest.row + rest.rows})")
    for i, ls in enumerate(rest.leaves):
        a, b = max(ls.row, lo), min(ls.row + ls.rows, hi)
        e0, e1 = (a - ls.row) * LANES, min(ls.size, (b - ls.row) * LANES)
        if a < b and e0 < e1:
            yield i, e0, e1, (a - lo) * LANES


def pack_rest_rows(rest_tree, layout: ArenaLayout, row_lo: int, row_hi: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Arena rows [row_lo, row_hi) of the rest region's pack -> new
    (row_hi - row_lo, LANES) `dtype` slab, bit for bit those rows of
    `pack_rest`, touching only the leaves the range cuts (the bucketed
    ZeRO-1 schedule packs the rest region one size-capped bucket at a
    time)."""
    _check_pack_dtype(dtype)
    leaves = flatten_up_to(rest_tree, layout.rest.paths)
    out = torch.zeros((row_hi - row_lo, LANES), dtype=dtype,
                      device=leaves[0].device)
    flat = out.view(-1)
    for i, e0, e1, at in _rest_cuts(layout, row_lo, row_hi):
        flat[at:at + e1 - e0].copy_(leaves[i].reshape(-1)[e0:e1])
    return out


def unpack_stack_layers_(stack_tree, spec: StackSpec, j0: int,
                         rows: torch.Tensor) -> None:
    """The inverse of `pack_stack_layers`, in place: layers [j0, j0 + n) of
    the stacked leaves <- their slots of the (n * layer_rows, LANES)
    `rows`."""
    n = rows.shape[0] // spec.layer_rows
    region = rows.reshape(n, spec.layer_rows * LANES)
    for x, ls in zip(flatten_up_to(stack_tree, spec.paths), spec.leaves):
        x[j0:j0 + n].copy_(region[:, ls.row * LANES:ls.row * LANES + ls.size]
                           .reshape((n,) + ls.shape))


def unpack_rest_rows_(rest_tree, layout: ArenaLayout, row_lo: int,
                      rows: torch.Tensor) -> None:
    """The inverse of `pack_rest_rows`, in place: every rest leaf's
    elements that arena rows [row_lo, row_lo + len(rows)) hold <- them."""
    leaves = flatten_up_to(rest_tree, layout.rest.paths)
    flat = rows.reshape(-1)
    for i, e0, e1, at in _rest_cuts(layout, row_lo, row_lo + rows.shape[0]):
        leaves[i].view(-1)[e0:e1].copy_(flat[at:at + e1 - e0])


def unpack(arena: torch.Tensor, layout: ArenaLayout, dtype=None):
    """Arena -> tree. Leaves take their recorded dtypes (or a forced
    `dtype`); a leaf whose dtype is the arena's is a VIEW of `arena`."""
    out: Dict[str, Any] = {}
    for spec in layout.stacks:
        region = arena[spec.row:spec.row + spec.rows].reshape(
            spec.n_layers, spec.layer_rows * LANES)
        leaves = [region[:, ls.row * LANES:ls.row * LANES + ls.size]
                  .reshape((spec.n_layers,) + ls.shape)
                  .to(dtype or ls.dtype) for ls in spec.leaves]
        out[spec.name] = tree_unflatten(spec.paths, leaves)
    rest = layout.rest
    region = arena[rest.row:rest.row + rest.rows].reshape(-1)
    leaves = [region[ls.row * LANES:ls.row * LANES + ls.size]
              .reshape(ls.shape).to(dtype or ls.dtype) for ls in rest.leaves]
    rest_tree = tree_unflatten(rest.paths, leaves)
    if not layout.stacks:
        return rest_tree
    out.update(rest_tree)
    return out


@dataclass
class Arena:
    """A (rows, LANES) buffer and its static layout: fp32 (moments, the
    master params), or bf16 for the working-param cache."""
    data: torch.Tensor
    layout: ArenaLayout

    @classmethod
    def zeros(cls, layout: ArenaLayout, device, rows=None) -> "Arena":
        """A zeroed fp32 arena of `rows` rows (default layout.rows; a ZeRO-1
        rank holds its shard of them, core/zero.py)."""
        rows = layout.rows if rows is None else rows
        return cls(torch.zeros((rows, LANES), dtype=torch.float32,
                               device=device), layout)
