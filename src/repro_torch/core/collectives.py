"""The data-parallel engine's collectives over a `torch.distributed`
process group, each counting what it moves, as the kernel wrappers count
their launches: `<fn>.calls` and `<fn>.bytes`, the bytes of the whole
tensor the collective spans (the tensor all-reduced, the slab
reduce-scattered, the result all-gathered). Reset both to 0 before the
region to count (`reset_counts`). Their sum is the volume §3.3 and Fig. 7
of the paper reckon a schedule by: P for ga, 2P for AdamA (m and v),
N x P for the naive schedule, and N x P + P for ZeRO-1 (a gradient
scatter a micro-batch and the param all-gather).

Every collective runs, whatever the group's size: on one rank the
reduce-scatter and the all-gather copy, and the all-reduce leaves its
tensor as it is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """x <- the sum of every rank's x, in place. Returns x."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += _nbytes(x)
    return x


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of x's rows [k*R/M, (k+1)*R/M) on rank k: a new
    (R/M, ...) tensor (`reduce_scatter_tensor`)."""
    m = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // m,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    reduce_scatter.calls += 1
    reduce_scatter.bytes += _nbytes(x)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x stacked by rank along dim 0: a new (M*R, ...) tensor
    (`all_gather_into_tensor`)."""
    m = dist.get_world_size(group)
    out = x.new_empty((m * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    all_gather.calls += 1
    all_gather.bytes += _nbytes(out)
    return out


def agree(ok: torch.Tensor, group=None) -> torch.Tensor:
    """ok <- 1.0 if every rank's ok is 1.0, else 0.0, in place (a (1,)
    float32 device flag, a guard vector's verdict): one 4-byte all-reduce
    of 1 - ok, whose sum is 0 only if no rank saw a fault. Returns ok."""
    bad = 1.0 - ok
    all_reduce(bad, group)
    ok.copy_((bad == 0).to(ok.dtype))
    return ok


COLLECTIVES = (all_reduce, reduce_scatter, all_gather)


def reset_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = fn.bytes = 0


reset_counts()
