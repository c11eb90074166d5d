"""Checkpoints in the reference's format (`repro/train/checkpoint.py`):
a tree -> <dir>/step_%08d/{arrays.npz, structure.json}, written atomically,
checksummed, restored in place.

The format is the reference's, so a checkpoint either one writes restores
into the other:

- `arrays.npz` (`np.savez`) holds the leaves a0..aN in the reference's
  flatten order: dict keys sorted at every level, an Arena one leaf (its
  data), a MomentState its parts in order, None no leaf. bf16 goes as its
  uint16 view; a host int (the port's `step`) as a 0-d int32, the
  reference's step leaf.
- `structure.json` holds `step`, `n_leaves`, `meta` (per leaf its dtype and
  the crc32 of its C-order bytes), `regions` (the dict's top-level keys,
  sorted), and, when the tree holds an Arena, `arena_regions` (per leaf the
  Arena's region boundaries, null for any other leaf). `treedef` is null:
  the reference accepts a null there, and refuses any string but its own
  repr of a JAX treedef. The port records its own structure under keys
  the reference ignores: `paths` (each leaf's key path) and `codecs` (the
  codec of each arena-backed moment).

A save writes into a `.tmp_` directory, fsyncs the files and the directory
and then renames it to `step_%08d` (a crash leaves the old set or the new
one, never a torn one), and keeps the newest `keep` steps.

`restore` takes a live tree (torch has no abstract trees) and checks, in
order: every crc32 before anything is copied; the top-level regions, with
the reference's message; the leaf count; each leaf's shape and dtype; the
Arena leaves' region boundaries; the moments' codecs and the key paths,
where the checkpoint records them. Then it copies each leaf in place into
the target's tensor, on its device (allocating nothing there), and returns
the tree with its host ints restored. Elastic restores and bucketed
residency (`elastic=`, `bucket_plan=`) wait for the distributed engines
(ROADMAP queue 1, item 10), as does a checkpoint of a layout padded for
more than one shard.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
import zlib
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import state_store

ITEM_10 = ("waits for checkpoints of sharded state (ROADMAP queue 1, item "
           "10.2: ZeRO-1 layouts and bucketed residency; item 10.4: elastic "
           "restore)")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint on disk failed an integrity check (unreadable archive,
    truncated file, or per-array checksum mismatch). The message names the
    file and the check that failed."""


class MissingMasterRegionError(RuntimeError):
    """Working-param export was asked of a checkpoint whose optimizer state
    carries no fp32 master region ("p"). Exporting the model params instead
    would silently serve other weights, so this refuses by name; train with
    master_params=True or read tree["params"] explicitly."""


# ---------------------------------------------------------------------------
# Flatten in the reference's order
# ---------------------------------------------------------------------------


def _is_host_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _flatten(tree, path=()) -> List[Tuple[Tuple[str, ...], Any, Any]]:
    """[(key path, leaf, owner)] in `jax.tree.flatten`'s order for the
    reference's counterpart of `tree`; `owner` is the Arena or MomentState
    a leaf belongs to, else None."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (str(k),))
        return out
    if isinstance(tree, arena_mod.Arena):
        return [(path, tree.data, tree)]
    if isinstance(tree, state_store.MomentState):
        return [(path + (str(i),), x, tree) for i, x in enumerate(tree.parts)]
    if isinstance(tree, torch.Tensor) or _is_host_int(tree):
        return [(path, tree, None)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{'/'.join(path) or '<root>'}: a tree is nested dicts "
                    f"of tensors, host ints, Arenas and MomentStates")


def tree_leaves(tree) -> list:
    """The leaves a checkpoint of `tree` holds, a0..aN in order: tensors
    and host ints."""
    return [leaf for _, leaf, _ in _flatten(tree)]


def _rebuild(tree, values):
    """`tree` with each host-int leaf replaced by the next of `values` (an
    iterator over every leaf's restored value, in flatten order); tensors,
    Arenas and MomentStates are kept (restored in place)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _rebuild(tree[k], values) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, state_store.MomentState):
        for _ in tree.parts:
            next(values)
        return tree
    value = next(values)
    return value if _is_host_int(tree) else tree


def _dtype_name(leaf) -> str:
    """The name the reference's meta gives a leaf's dtype."""
    if _is_host_int(leaf):
        return "int32"
    return str(leaf.dtype).replace("torch.", "")


def _shape(leaf) -> Tuple[int, ...]:
    return () if _is_host_int(leaf) else tuple(leaf.shape)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the reference writes it: bf16 as its uint16 view, a host
    int as a 0-d int32."""
    if _is_host_int(leaf):
        return np.asarray(leaf, dtype=np.int32)
    x = leaf.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


def _crc32(arr: np.ndarray) -> int:
    """zlib.crc32 of the array's C-order bytes (`tobytes()`), read in place
    when the array is contiguous."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _arena_region_table(nodes) -> List[Optional[dict]]:
    """Per-leaf region boundaries of the Arena leaves (stack name, row,
    layer count and per-layer stride; the rest region's row span), None
    for every other leaf: the reference's `_arena_region_table`."""
    table = []
    for _, _, owner in nodes:
        if isinstance(owner, arena_mod.Arena):
            lay = owner.layout
            table.append({"stacks": [[s.name, s.row, s.n_layers,
                                      s.layer_rows] for s in lay.stacks],
                          "rest": [lay.rest.row, lay.rest.rows]})
        else:
            table.append(None)
    return table


def _region_mismatch(sv, tgt) -> str:
    """First human-readable difference between two region fingerprints."""
    if len(sv["stacks"]) != len(tgt["stacks"]):
        saved = [s[0] for s in sv["stacks"]]
        want = [s[0] for s in tgt["stacks"]]
        return f"stacked regions {saved} vs target {want}"
    for a, b in zip(sv["stacks"], tgt["stacks"]):
        if a != b:
            return (f"stack {a[0]!r} saved (row={a[1]}, layers={a[2]}, "
                    f"layer_rows={a[3]}) vs target ({b[0]!r}, row={b[1]}, "
                    f"layers={b[2]}, layer_rows={b[3]})")
    if sv["rest"] != tgt["rest"]:
        return (f"rest region saved (row={sv['rest'][0]}, "
                f"rows={sv['rest'][1]}) vs target (row={tgt['rest'][0]}, "
                f"rows={tgt['rest'][1]})")
    return "region boundaries differ"


def _codecs(tree, path=()) -> dict:
    """{key path: codec name} of every arena-backed moment ("m" or "v")."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            sub = tree[k]
            if k in ("m", "v") and state_store.is_arena_backed(sub):
                out["/".join(path + (k,))] = state_store.codec_of(
                    sub, k).name
            else:
                out.update(_codecs(sub, path + (str(k),)))
    return out


def _fsync_path(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# Save, retention, latest step
# ---------------------------------------------------------------------------


def save(ckpt_dir, step: int, tree: Any, *, keep: int = 3,
         bucket_plan=None) -> str:
    """Atomically save `tree` under <ckpt_dir>/step_%08d/ and keep the
    newest `keep` steps. Returns the step's directory."""
    if bucket_plan is not None:
        raise NotImplementedError(f"save(bucket_plan=) {ITEM_10}")
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    nodes = _flatten(tree)
    arrays, meta = {}, []
    for i, (_, leaf, _) in enumerate(nodes):
        arr = _to_numpy(leaf)
        meta.append({"dtype": _dtype_name(leaf), "crc32": _crc32(arr)})
        arrays[f"a{i}"] = arr
    info = {"step": int(step), "n_leaves": len(nodes), "treedef": None,
            "meta": meta}
    table = _arena_region_table(nodes)
    if any(r is not None for r in table):
        info["arena_regions"] = table
    if isinstance(tree, dict):
        info["regions"] = sorted(str(k) for k in tree)
    info["paths"] = ["/".join(p) for p, _, _ in nodes]
    info["codecs"] = _codecs(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "structure.json"), "w") as f:
            json.dump(info, f)
            f.flush()
            os.fsync(f.fileno())
        # the data and the directory are durable BEFORE the rename
        # publishes them
        _fsync_path(os.path.join(tmp, "arrays.npz"))
        _fsync_path(tmp)
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return str(final)


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = sorted(p.glob("step_*"))
    return int(steps[-1].name.split("_")[1]) if steps else None


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _read(d: Path):
    """(structure.json, {name: array}) of one step, every array read."""
    try:
        with open(d / "structure.json") as f:
            info = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"{d / 'structure.json'}: unreadable metadata ({e})") from e
    try:
        with np.load(d / "arrays.npz") as npz:
            data = {k: npz[k] for k in npz.files}    # full reads now
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
            ValueError, KeyError, NotImplementedError) as e:
        raise CheckpointCorruptError(
            f"{d / 'arrays.npz'}: unreadable archive — truncated or "
            f"damaged zip ({e})") from e
    return info, data


def _check_checksums(d: Path, info, data) -> None:
    for i, m in enumerate(info["meta"]):
        if "crc32" not in m:
            continue                       # pre-checksum checkpoint
        got = _crc32(data[f"a{i}"])
        if got != m["crc32"]:
            raise CheckpointCorruptError(
                f"{d / 'arrays.npz'}: checksum mismatch on array a{i} "
                f"(crc32 {got:#010x} != recorded {m['crc32']:#010x}) — "
                f"on-disk corruption, refusing to restore")


def _check_regions(step, info, tree) -> None:
    """The reference's check of the top-level state regions, by name."""
    saved = info.get("regions")
    if saved is None or not isinstance(tree, dict):
        return
    have = sorted(str(k) for k in tree)
    if have == saved:
        return
    lacks = [k for k in have if k not in saved]
    stale = [k for k in saved if k not in have]
    parts = []
    if lacks:
        parts.append(f"checkpoint lacks region(s) {lacks} the target state "
                     f"carries")
    if stale:
        parts.append(f"checkpoint carries stale region(s) {stale} the "
                     f"target state does not expect")
    raise ValueError(
        f"state-region mismatch restoring step {step}: " + "; ".join(parts)
        + f" (checkpoint regions {saved}, target regions {have}). Regions "
        f"are never silently zero-filled or dropped — e.g. a run with an "
        f"fp8 error-feedback residual ('ef') cannot resume from a "
        f"checkpoint written without one; re-init or convert the "
        f"checkpoint explicitly")


def _same_model(saved_tbl, target_tbl) -> bool:
    """Whether some Arena leaf's saved and target layouts have the same
    stacks (names and layer counts): a row difference is then the padding
    of another shard count, not another model."""
    for sv, tgt in zip(saved_tbl or (), target_tbl):
        if sv is not None and tgt is not None and \
                [s[0::2] for s in sv["stacks"]] == \
                [[s[0], s[2]] for s in tgt["stacks"]]:
            return True
    return False


def _check_leaves(step, info, data, nodes, target_tbl) -> None:
    """Leaf count, then each leaf's shape and dtype exactly."""
    if len(nodes) != info["n_leaves"]:
        raise ValueError(f"leaf count mismatch: tree {len(nodes)} vs "
                         f"checkpoint {info['n_leaves']}")
    saved_tbl = info.get("arena_regions")
    for i, (path, leaf, owner) in enumerate(nodes):
        arr = data[f"a{i}"]
        want = _shape(leaf)
        if tuple(arr.shape) != want:
            if (owner is not None and arr.ndim == len(want) >= 1
                    and arr.shape[1:] == want[1:]
                    and _same_model(saved_tbl, target_tbl)):
                raise NotImplementedError(
                    f"restoring step {step}: leaf {i} ({'/'.join(path)}) "
                    f"holds {arr.shape[0]} arena rows where the target's "
                    f"layout has {want[0]}: a layout padded for another "
                    f"shard count. Restoring it {ITEM_10}")
            raise ValueError(f"shape mismatch at leaf {i} "
                             f"({'/'.join(path)}): {arr.shape} vs {want}")
        saved_dt, want_dt = info["meta"][i]["dtype"], _dtype_name(leaf)
        if saved_dt != want_dt:
            raise ValueError(f"dtype mismatch at leaf {i} "
                             f"({'/'.join(path)}): checkpoint {saved_dt} "
                             f"vs target {want_dt}")


def _check_structure(step, info, tree, nodes, target_tbl) -> None:
    """The Arena leaves' region boundaries, then the codecs and key paths
    where the checkpoint records them (the port's own keys)."""
    saved_tbl = info.get("arena_regions")
    if saved_tbl is not None:
        for i, (sv, tgt) in enumerate(zip(saved_tbl, target_tbl)):
            if sv != tgt:
                raise ValueError(
                    f"arena layout mismatch restoring step {step} at leaf "
                    f"{i}: " + ("an Arena on one side only" if sv is None
                                or tgt is None else _region_mismatch(sv, tgt)))
    if "codecs" in info and info["codecs"] != _codecs(tree):
        raise ValueError(f"codec mismatch restoring step {step}: checkpoint "
                         f"{info['codecs']} vs target {_codecs(tree)}")
    if "paths" in info:
        have = ["/".join(p) for p, _, _ in nodes]
        if info["paths"] != have:
            bad = next(i for i, (a, b) in enumerate(zip(info["paths"], have))
                       if a != b)
            raise ValueError(f"tree structure mismatch restoring step "
                             f"{step} at leaf {bad}: checkpoint "
                             f"{info['paths'][bad]!r} vs target {have[bad]!r}")


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def restore(ckpt_dir, step: int, tree: Any, bucket_plan=None,
            elastic: bool = False) -> Any:
    """Restore step `step` into the live `tree` (its structure, shapes and
    dtypes validated first, as the module docstring lists): every tensor
    is overwritten in place on its device, and the tree is returned with
    its host ints set to the checkpoint's."""
    if elastic:
        raise NotImplementedError(f"restore(elastic=True) {ITEM_10}")
    if bucket_plan is not None:
        raise NotImplementedError(f"restore(bucket_plan=) {ITEM_10}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    info, data = _read(d)
    _check_checksums(d, info, data)
    _check_regions(step, info, tree)
    nodes = _flatten(tree)
    target_tbl = _arena_region_table(nodes)
    _check_leaves(step, info, data, nodes, target_tbl)
    _check_structure(step, info, tree, nodes, target_tbl)
    values = []
    for i, (_, leaf, _) in enumerate(nodes):
        arr = data.pop(f"a{i}")
        if _is_host_int(leaf):
            values.append(int(arr))
        else:
            leaf.copy_(_from_numpy(arr, info["meta"][i]["dtype"]))
            values.append(leaf)
    return _rebuild(tree, iter(values))


def export_working_params(ckpt_dir, step: Optional[int], tree: Any, *,
                          elastic: bool = False) -> Any:
    """Checkpoint -> serving params: restore the {"params", "opt"} training
    tree into `tree` and unpack the bf16 working params from the master
    arena: state["wp"] when the run cached them (what the train step
    consumed), else bf16(master) (what the apply kernel writes). Leaves
    take their recorded dtypes, as `arena.unpack` gives them. `step=None`
    exports the latest step; a state without the master region "p" raises
    MissingMasterRegionError."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    tree = restore(ckpt_dir, step, tree, elastic=elastic)
    opt = tree.get("opt") if isinstance(tree, dict) else None
    if not isinstance(opt, dict) or "p" not in opt:
        regions = sorted(opt) if isinstance(opt, dict) else type(opt).__name__
        raise MissingMasterRegionError(
            f"checkpoint {ckpt_dir} step {step}: optimizer state has no "
            f"master-param region 'p' (regions: {regions}); working-param "
            f"export requires a master_params=True run")
    if "wp" in opt:
        wp = opt["wp"]
        return arena_mod.unpack(wp.data, wp.layout)
    master = opt["p"]
    return arena_mod.unpack(master.data.to(torch.bfloat16), master.layout)
