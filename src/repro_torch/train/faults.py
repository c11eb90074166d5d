"""Fault injection for the finite guards (`repro/train/faults.py`): one
spec grammar for the CLI's `--inject-fault` and the tests.

A `FaultSpec` names what goes wrong and where:

    nan@micro=1              NaN into micro-batch 1's gradient, every step
    nan@micro=0,step=2       only on train step 2
    inf@micro=2              Inf instead
    zero@micro=1             silent corruption: zero a gradient leaf; finite,
                             so the guards must NOT fire
    skip@micro=1             force the guard's verdict to False without
                             corrupting anything: "a run that never saw
                             micro-batch 1", which a caught NaN must equal
                             bit for bit
    crash@step=3             raise InjectedCrash after step 3's update
                             (train/loop.py)

Selectors default to -1, every value. The engines pass the micro-batch
index and their step counter as host ints, so a hit is decided on the host
and the injection itself is a device write where a real NaN would appear.
The `device` selector raises: the port has no multi-device engine yet.

`corrupt_checkpoint_array` and `truncate_checkpoint` damage a checkpoint
on disk (train/checkpoint.py) as a failing disk or a torn write would, for
the tests of `CheckpointCorruptError`.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import arena as arena_mod

KINDS = ("nan", "inf", "zero", "skip", "crash")


class InjectedCrash(RuntimeError):
    """Raised by train/loop.py for `crash@step=N` after that step's
    update."""


@dataclass(frozen=True)
class FaultSpec:
    kind: str                    # one of KINDS
    micro_batch: int = -1        # -1 = every micro-batch
    device: int = -1             # -1 = every device
    step: int = -1               # -1 = every step

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {KINDS}")


_SEL = re.compile(r"^(micro|device|step)=(-?\d+)$")


def parse_fault(spec: Optional[str]) -> Optional[FaultSpec]:
    """Parse `<kind>[@sel=val[,sel=val...]]` with selectors micro, device
    and step. None or "" gives None."""
    if not spec:
        return None
    kind, _, rest = spec.partition("@")
    kw = {}
    if rest:
        for part in rest.split(","):
            m = _SEL.match(part.strip())
            if not m:
                raise ValueError(
                    f"bad fault selector {part!r} in {spec!r}; expected "
                    f"micro=<i>, device=<i> or step=<i>")
            key = {"micro": "micro_batch"}.get(m.group(1), m.group(1))
            kw[key] = int(m.group(2))
    return FaultSpec(kind=kind.strip(), **kw)


def _hit(spec: FaultSpec, micro: int, step: Optional[int]) -> bool:
    """Does this (micro-batch, step) match? Host ints."""
    if spec.step >= 0 and step is None:
        raise ValueError(f"fault {spec} selects a step but the engine did "
                         f"not thread the step counter")
    if spec.device >= 0:
        raise ValueError(f"fault {spec} selects a device but the engine is "
                         f"not running under shard_map")
    return ((spec.micro_batch < 0 or micro == spec.micro_batch)
            and (spec.step < 0 or step == spec.step))


@torch.no_grad()
def corrupt_tree(spec: Optional[FaultSpec], tree, *, micro: int,
                 step: Optional[int] = None):
    """Inject the fault into a gradient tree, in place: nan/inf poison
    element [0, ..., 0] of the first leaf in the reference's flatten order
    (sorted keys), enough for any finite flag; zero multiplies that leaf by
    0 (finite: the guards must not fire). Other kinds and None leave the
    tree alone. Returns the tree."""
    if spec is None or spec.kind not in ("nan", "inf", "zero"):
        return tree
    if not _hit(spec, micro, step):
        return tree
    leaf = arena_mod.tree_flatten(tree)[0][0]
    if spec.kind == "zero":
        leaf.mul_(0.0)
    else:
        leaf[(0,) * leaf.dim()] = float("nan" if spec.kind == "nan"
                                        else "inf")
    return tree


def corrupt_loss(spec: Optional[FaultSpec], loss: torch.Tensor, *,
                 micro: int, step: Optional[int] = None) -> torch.Tensor:
    """Inject nan/inf at the loss or the backward's seed (a tensor): the
    realistic failure, which reaches every layer's gradient. Returns a new
    tensor on a hit, `loss` otherwise."""
    if spec is None or spec.kind not in ("nan", "inf"):
        return loss
    if not _hit(spec, micro, step):
        return loss
    return torch.full_like(loss, float("nan" if spec.kind == "nan"
                                       else "inf"))


def apply_skip(spec: Optional[FaultSpec], ok: bool, *, micro: int,
               step: Optional[int] = None) -> bool:
    """AND a verdict with a forced `skip` fault (identity for every other
    kind). On the host: the engines start their device flag from it."""
    if spec is None or spec.kind != "skip":
        return ok
    if spec.device >= 0:
        raise ValueError("skip faults cannot be device-selective: the "
                         "forced verdict is applied after cross-device "
                         "agreement (use kind=nan to test agreement)")
    return bool(ok) and not _hit(spec, micro, step)


def crash_due(spec: Optional[FaultSpec], step: int) -> bool:
    """Should train/loop.py raise InjectedCrash after this step's update
    (0-based step index), before its checkpoint is saved?"""
    return (spec is not None and spec.kind == "crash"
            and (spec.step < 0 or spec.step == step))


# ---------------------------------------------------------------------------
# Checkpoint damage (CheckpointCorruptError tests)
# ---------------------------------------------------------------------------


def corrupt_checkpoint_array(ckpt_dir, step: int, *, offset: int = -64) -> str:
    """Flip one bit inside <ckpt_dir>/step_<n>/arrays.npz (at `offset`
    bytes from the end by default, in the zip trailer; a positive mid-file
    offset lands in array data) and return the damaged path. A second call
    with the same offset flips it back. restore() must raise
    CheckpointCorruptError naming the file."""
    path = Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    with open(path, "r+b") as f:
        f.seek(offset, 0 if offset >= 0 else 2)
        pos = f.tell()
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ 0x01]))
    return str(path)


def truncate_checkpoint(ckpt_dir, step: int, *, keep_bytes: int = 128) -> str:
    """Truncate arrays.npz to its first `keep_bytes` bytes (a torn write
    that the atomic rename prevents, made on purpose)."""
    path = Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    os.truncate(path, min(keep_bytes, path.stat().st_size))
    return str(path)
