"""Micro-batch accumulation engines — where AdamA meets the training loop
(`repro/core/accumulation.py`, the kernel paths).

  ga               baseline gradient accumulation: a param-sized fp32
                   accumulator slab sums pack(g)/N over the micro-batches,
                   then one fold (with the begin-minibatch decay) and one
                   apply. The paper's comparison point. Arena state only.
                   Each micro-batch's tree is packed and dropped, and the
                   pack is added in as XLA CPU evaluates the reference's
                   `acc + pack(g) / n` (`_ga_accumulate`): one arena beside
                   the accumulator, no tree or quotient.
  adama            Algorithm 1: each micro-batch's gradient is folded into
                   (m, v) at once, then dropped before the next
                   micro-batch's backward. No param-sized gradient
                   accumulator exists. Arena state: packed and folded by one
                   kernel (scale 1/N in-kernel, the decay fused into fold
                   0). Per-leaf state: g/N folded leaf by leaf after a
                   begin-minibatch decay pass.
  adama_layerwise  Algorithm 2 (core/layerwise.py): each LAYER's gradient
                   is folded inside the backward, so only one layer's
                   gradient is ever live.

All consume a global batch (GB, ...) split into N micro-batches of GB/N.
`remat` (the reference's keyword; RunConfig.remat in train()) runs ga's
and adama's forward with each layer checkpointed (make_loss): the forward
keeps layer inputs only and the backward recomputes each layer. It
changes no value: the recompute repeats the forward's operations on the
same inputs. adama_layerwise takes it and ignores it, its schedule
already recomputing every layer.
`OptimizerConfig.arena` selects the state form. Params and state are
updated in place; `step` returns them for symmetry with the reference.

`OptimizerConfig.finite_guard` (arena state) runs each engine's guarded
branch, the reference's line for line, through the guarded kernel forms:

  ga               one verdict over the accumulated slab predicates the
                   fold, the apply and the step counter.
  adama            a verdict per micro-batch over its packed slab: a
                   non-finite micro-batch folds nothing; the begin-minibatch
                   decay moves to the first committed fold (`good`, the
                   count of committed folds, picks it on the device); the
                   step counts only if some fold committed.
  adama_layerwise  the same, the verdict ANDed over dx, the head's
                   gradients and every layer's slab as the backward goes.

`OptimizerConfig.grad_dtype` (arena state, adama and adama_layerwise; the
config refuses it for ga, whose accumulator sums raw gradients) is the
gradient wire: each micro-batch's (or each layer's) gradient packs into a
slab of that dtype (bf16: half the bytes), and the fold kernels upcast it
to fp32 in-pass, so the moments accumulate in fp32 on either wire. The fp8
wire ("fp8_e4m3", guarded engines only, as the config requires) packs
fp32 and runs three kernels per slab (kernels/fp8_wire.py): the encode,
which injects the error-feedback residual state["ef"] at the live loss
scale (x = fma(ef, S, slab)), writes the e4m3 codes and their per-row
scale column and ANDs finite(x) into the guard's ok (the wire's finite
flag: no finite_and pass); the guarded fold of the codes, decoded in-pass
(`grad_scale`); and the residual's update, ef = fma(-code, scale, x) / S,
predicated on the same ok, so a skipped micro-batch leaves ef bitwise.
Without error feedback (error_feedback=False) the state has no "ef" and
the encode reads the slab alone.

`OptimizerConfig.master_params` (arena state, every engine) adds the fp32
master region "p": `adama.finalize` then updates it and writes the bf16
working params into the param leaves from the same apply kernel, and never
packs the params. With `work_param_cache` the working params are kept in
the state ("wp", written by the kernel), and every engine loads its param
leaves from them at step start (`adama.load_working_params`, the
reference's `params = adama.working_params(opt_state)`), so step 1 too
runs on bf16-cast params.

The guarded state carries "scaler" (train/scaler.py). Its scale divides
1/N in the fold's traced scale (scale_into_fold) and multiplies the loss
(adama) or the backward's seed (adama_layerwise), so the bf16 slab holds
the scaled gradient and loss scaling ("dynamic" or static) keeps its small
values out of bf16's subnormal range. Every verdict, count
and scalar of the micro-batch loop lives on the device: the kernels read
the guard vector [dm, dv, ok, scale] that the engine fills there and
`finite_and` ANDs the flag into, and NOTHING reads a device value on the
host inside the micro-batch loop. The step counter stays a host int: the
apply's lr, bc1 and bc2 are formed on the host for step + 1 (when no fold
committed the guarded apply is the identity, so their value does not
matter), and after the apply is enqueued the engine reads `good` and the
scaler's counters back once per mini-batch, to advance the step and
report the metrics (loss, loss_scale, skipped_micro_batches,
consec_skips). Faults (train/faults.py) select micro-batches and steps by
those host ints.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      grad_wire_dtype, is_fp8_wire,
                                      use_error_feedback)
from repro_torch.core import adama
from repro_torch.core import arena as arena_mod
from repro_torch.core import state_store
from repro_torch.core.layerwise import layerwise_loss_and_fold
from repro_torch.kernels import fp8_wire, fused_step
from repro_torch.kernels.adama_accum import _fma32
from repro_torch.models.model import loss_fn
from repro_torch.train import faults as fault_mod
from repro_torch.train import scaler as scaler_mod


def _fold_decay(i: int, beta1: float, beta2: float):
    """Decay pair for fold i of a mini-batch: the begin-minibatch pass
    (m *= b1, v *= b2) fused into the FIRST fold, identity afterwards."""
    return (beta1, beta2) if i == 0 else (1.0, 1.0)


def _split_micro(batch: Dict[str, Any], n: int):
    """Global batch -> list of n micro-batches (views along dim 0)."""
    gb = batch["tokens"].shape[0]
    if gb % n:
        raise ValueError(f"global batch {gb} not divisible by micro {n}")
    return [{k: x[i * (gb // n):(i + 1) * (gb // n)] for k, x in
             batch.items()} for i in range(n)]


def make_loss(cfg: ModelConfig, *, remat: bool = False) -> Callable:
    """The loss of a param tree and a batch; `remat` checkpoints each
    layer (models.model.run_blocks)."""
    return functools.partial(loss_fn, cfg, remat=remat)


def _grads(loss_of, params, leaves, mb, sc=None):
    """(loss, gradient tree) of one micro-batch under the loss `loss_of`
    (make_loss); with a scaler `sc`, of the loss times its scale
    (scaler.scale_loss)."""
    loss = scaler_mod.scale_loss(loss_of(params, mb), sc)
    grads = torch.autograd.grad(loss, leaves)
    _, paths = arena_mod.tree_flatten(params)
    return loss.detach(), arena_mod.tree_unflatten(paths, list(grads))


def inv_n(n: int, device) -> torch.Tensor:
    """f32(1) / f32(n) as a device scalar: XLA CPU rewrites the reference's
    division by the constant N (`x / n`) as a multiply by this reciprocal,
    and a device tensor keeps CUDA and the CPU on the same multiply."""
    return torch.tensor(np.float32(1) / np.float32(n), device=device)


# XLA CPU fuses a concatenate into the loop that consumes it only if it has
# at most this many operands
_XLA_FUSED_CONCAT_OPERANDS = 8


def _concat_operands(leaves, region_rows):
    """Operands of the concatenate that packs a region: one per leaf, and
    one zero block if the leaves leave rows of the region unused."""
    return len(leaves) + (region_rows > sum(s.rows for s in leaves))


def uncontracted_rows(layout):
    """The arena rows [lo, hi) on which XLA CPU multiplies and adds
    `acc + pack(g) / n` in two roundings: every row of each leaf whose last
    row is zero-padded, where that leaf's pad runs inside the loop that
    forms the sum. XLA leaves the multiply-add uncontracted there and
    contracts every other row into one fused multiply-add.

    A pad runs inside that loop when every concatenate between it and the
    sum is fused into the loop, i.e. has at most 8 operands: the arena's
    (one per stacked region, the rest region's leaves and its zero rows,
    which XLA merges into it, and the tail's zero rows) and, for a stacked
    leaf, its region's (the region's leaves and zero rows). Measured on
    XLA CPU with trees whose stacked regions hold one, two or many padded
    leaves, and with every model of the repo
    (tests/test_torch_reciprocal.py)."""
    rest = layout.rest
    used = rest.row + rest.rows
    outer = (len(layout.stacks)
             + (_concat_operands(rest.leaves, rest.rows) if rest.rows else 0)
             + (layout.rows > used))
    if outer > _XLA_FUSED_CONCAT_OPERANDS:
        return []
    out = []
    for st in layout.stacks:
        if _concat_operands(st.leaves, st.layer_rows) \
                > _XLA_FUSED_CONCAT_OPERANDS:
            continue
        for j in range(st.n_layers):
            base = st.row + j * st.layer_rows
            out += [(base + s.row, base + s.row + s.rows)
                    for s in st.leaves if s.size % arena_mod.LANES]
    out += [(rest.row + s.row, rest.row + s.row + s.rows)
            for s in rest.leaves if s.size % arena_mod.LANES]
    return out


def scale_leaves(g, r):
    """Algorithm 1 line 6 as the reference's per-leaf path does it, g / N:
    its `x / n`, which XLA CPU evaluates as x * f32(1/N) (`inv_n` r), in
    place on every leaf of the gradient tree g, which it returns."""
    for x in arena_mod.tree_flatten(g)[0]:
        x.mul_(r)
    return g


_FMA_CHUNK_ROWS = 1 << 12


def _ga_accumulate(acc, slab, r, plain_rows):
    """acc += slab / N as the jitted reference computes it: fma(slab, r,
    acc) with r = f32(1/N) (`inv_n`), but slab * r + acc in two roundings
    on `plain_rows` (`uncontracted_rows`). On CUDA `addcmul_` is the
    fused multiply-add (nvcc contracts its self + t1 * t2); on the CPU it
    is formed exactly (`_fma32`), a chunk of rows at a time."""
    kept = [(lo, hi, acc[lo:hi] + slab[lo:hi] * r) for lo, hi in plain_rows]
    if acc.is_cuda:
        acc.addcmul_(slab, r)
    else:
        for lo in range(0, acc.shape[0], _FMA_CHUNK_ROWS):
            hi = lo + _FMA_CHUNK_ROWS
            acc[lo:hi] = _fma32(slab[lo:hi], r, acc[lo:hi])
    for lo, hi, x in kept:
        acc[lo:hi] = x


def _lr(lr_schedule, opt: OptimizerConfig, step: int):
    return opt.lr if lr_schedule is None else lr_schedule(step)


class _Guard:
    """A guarded engine's device constants, copied from the host once per
    device, and the guard vectors built from them on the device."""

    def __init__(self, opt: OptimizerConfig):
        self.opt = opt
        self._consts = {}

    def consts(self, device) -> torch.Tensor:
        c = self._consts.get(device)
        if c is None:
            o = self.opt
            # [b1, b2 | 1, 1 | ok False, ok True | f32(1/N) | 1]
            c = self._consts[device] = torch.tensor(
                [o.beta1, o.beta2, 1.0, 1.0, 0.0, 1.0,
                 1.0 / o.micro_batches, 1.0], dtype=torch.float32,
                device=device)
        return c

    def flag(self, device, ok: bool) -> torch.Tensor:
        """A host verdict as a (1,) device view: 1.0 or 0.0."""
        i = 5 if ok else 4
        return self.consts(device)[i:i + 1]

    def inv_n(self, device) -> torch.Tensor:
        return self.consts(device)[6]

    def one(self, device) -> torch.Tensor:
        return self.consts(device)[7]

    def fold_decay(self, good: torch.Tensor) -> torch.Tensor:
        """The decay pair of the next fold, a (2,) device tensor: (beta1,
        beta2) while no fold of the mini-batch has committed (good == 0),
        (1, 1) after (the reference's _fold_decay(good, ...))."""
        c = self.consts(good.device)
        return torch.where(good == 0, c[0:2], c[2:4])

    def vector(self, decay: torch.Tensor, ok: bool, scale: torch.Tensor):
        """A fresh guard vector [dm, dv, ok, scale] on the device."""
        return torch.cat([decay, self.flag(decay.device, ok),
                          scale.reshape(1)])

    def read_back(self, good, sc, loss):
        """The one read of the mini-batch: (committed folds, metrics: the
        loss and scaler.scaler_metrics'), after the apply is enqueued."""
        named = scaler_mod.scaler_metrics({"scaler": sc})
        vals = torch.stack([good.float(), loss.float()] + [
            x.float() for x in named.values()]).tolist()
        return int(vals[0]), {"loss": vals[1], **{
            k: x if named[k].is_floating_point() else int(x)
            for k, x in zip(named, vals[2:])}}


def make_ga_step(cfg: ModelConfig, opt: OptimizerConfig, *, remat=False,
                 lr_schedule=None, fault=None):
    loss_of = make_loss(cfg, remat=remat)
    n = opt.micro_batches
    if opt.finite_guard:
        return _make_guarded_ga_step(loss_of, opt, lr_schedule, fault)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        layout = opt_state["m"].layout
        leaves, _ = arena_mod.tree_flatten(params)
        acc = torch.zeros((layout.rows, arena_mod.LANES), dtype=torch.float32,
                          device=leaves[0].device)
        r = inv_n(n, acc.device)
        plain_rows = uncontracted_rows(layout)
        lsum = torch.zeros((), dtype=torch.float32, device=acc.device)
        for mb in _split_micro(batch, n):
            loss, g = _grads(loss_of, params, leaves, mb)
            slab = arena_mod.pack(g, layout)
            del g
            _ga_accumulate(acc, slab, r, plain_rows)
            del slab
            lsum = lsum + loss
        if opt.grad_clip:
            gn = torch.sqrt(torch.sum(torch.square(acc)))
            acc *= torch.clamp(opt.grad_clip / torch.clamp(gn, min=1e-9),
                               max=1.0)
        # the reference reads the schedule at the pre-increment step here
        lr = _lr(lr_schedule, opt, opt_state["step"])
        opt_state = state_store.fold_state(
            dict(opt_state, step=opt_state["step"] + 1), acc,
            beta1=opt.beta1, beta2=opt.beta2, decay=(opt.beta1, opt.beta2))
        del acc
        params, opt_state = adama.finalize(
            params, opt_state, lr=lr, beta1=opt.beta1, beta2=opt.beta2,
            eps=opt.eps, weight_decay=opt.weight_decay)
        return params, opt_state, {"loss": lsum * r}

    return step, _init(opt)


def _make_guarded_ga_step(loss_of, opt, lr_schedule, fault):
    """ga's whole-step guard: one verdict over the accumulated slab (checked
    before the clip) predicates the single fold, the apply and the step
    counter. The step does not advance on a skip, so a fault selecting
    that step fires again next step."""
    n = opt.micro_batches
    guard = _Guard(opt)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        layout = opt_state["m"].layout
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        st0 = opt_state["step"]
        acc = torch.zeros((layout.rows, arena_mod.LANES), dtype=torch.float32,
                          device=dev)
        plain_rows = uncontracted_rows(layout)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, g = _grads(loss_of, params, leaves, mb)
            fault_mod.corrupt_tree(fault, g, micro=i, step=st0)
            slab = arena_mod.pack(g, layout)
            del g
            _ga_accumulate(acc, slab, guard.inv_n(dev), plain_rows)
            del slab
            lsum = lsum + loss
        c = guard.consts(dev)
        vec = guard.vector(c[0:2], fault_mod.apply_skip(
            fault, True, micro=0, step=st0), guard.one(dev))
        fused_step.finite_and(acc, vec[2:3])
        if opt.grad_clip:
            gn = torch.sqrt(torch.sum(torch.square(acc)))
            acc *= torch.clamp(opt.grad_clip / torch.clamp(gn, min=1e-9),
                               max=1.0)
        lr = _lr(lr_schedule, opt, st0)
        opt_state, _ = state_store.fold_state(opt_state, acc, beta1=opt.beta1,
                                              beta2=opt.beta2, guard=vec)
        del acc
        sc = scaler_mod.scaler_update(
            opt_state["scaler"], vec[2] != 0, dynamic=False,
            growth_interval=opt.scaler_growth_interval)
        params, _ = adama.finalize(
            params, dict(opt_state, step=st0 + 1), lr=lr, beta1=opt.beta1,
            beta2=opt.beta2, eps=opt.eps, weight_decay=opt.weight_decay,
            guard=vec[2:3])
        good, metrics = guard.read_back(vec[2], sc, lsum * guard.inv_n(dev))
        return params, dict(opt_state, step=st0 + good, scaler=sc), metrics

    return step, _init(opt)


def make_adama_step(cfg: ModelConfig, opt: OptimizerConfig, *, remat=False,
                    lr_schedule=None, fault=None):
    loss_of = make_loss(cfg, remat=remat)
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2
    wire = grad_wire_dtype(opt.grad_dtype)
    if opt.finite_guard:
        return _make_guarded_adama_step(loss_of, opt, lr_schedule, fault)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        leaves, _ = arena_mod.tree_flatten(params)
        if opt.arena:
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2)
        r = inv_n(n, leaves[0].device)
        lsum = torch.zeros((), dtype=torch.float32, device=r.device)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, g = _grads(loss_of, params, leaves, mb)
            if opt.arena:
                state = adama.accumulate(state, g, b1, b2, scale=1.0 / n,
                                         decay=_fold_decay(i, b1, b2),
                                         grad_dtype=wire)
            else:
                state = adama.accumulate(state, scale_leaves(g, r), b1, b2)
            del g
            lsum = lsum + loss
        lr = _lr(lr_schedule, opt, state["step"])
        params, state = adama.finalize(
            params, state, lr=lr, beta1=b1, beta2=b2, eps=opt.eps,
            weight_decay=opt.weight_decay)
        return params, state, {"loss": lsum * r}

    return step, _init(opt)


def _fold_fp8(state, slab, vec, sc, b1, b2):
    """The fp8 wire's fold of one fp32 slab (Algorithm 1): encode with the
    residual injected at the live scale (its finite flag ANDed into the
    guard vector's ok), the guarded fold of the codes, the residual's
    update on the same ok. The codes are the one arena-sized transient
    beside the slab."""
    ef = state["ef"].data if "ef" in state else None
    s = sc["scale"]
    codes, gs = fp8_wire.fp8_encode(slab, ef=ef, scale=s, ok=vec[2:3])
    state, _ = state_store.fold_state(state, codes, beta1=b1, beta2=b2,
                                      grad_scale=gs, guard=vec)
    if ef is not None:
        fp8_wire.fp8_ef_update(ef, slab, codes, gs, scale=s, ok=vec[2:3])
    return state


def _make_guarded_adama_step(loss_of, opt, lr_schedule, fault):
    """Algorithm 1 guarded: per micro-batch, the loss times the live scale,
    the gradient packed at the wire's dtype, the slab's finite flag ANDed
    into a fresh guard vector [dm, dv, ok, scale_into_fold(1/N, sc)], the
    guarded fold, the scaler's transition; `good` counts the committed
    folds and moves the begin-minibatch decay to the first of them. The
    fp8 wire packs fp32 and folds through `_fold_fp8`."""
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2
    fp8 = is_fp8_wire(opt)
    wire = torch.float32 if fp8 else grad_wire_dtype(opt.grad_dtype)
    dyn = scaler_mod.is_dynamic(opt)
    gi = opt.scaler_growth_interval
    guard = _Guard(opt)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        st0 = opt_state["step"]
        state, sc = opt_state, opt_state["scaler"]
        good = torch.zeros((), dtype=torch.int32, device=dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, g = _grads(loss_of, params, leaves, mb, sc)
            fault_mod.corrupt_tree(fault, g, micro=i, step=st0)
            slab = arena_mod.pack(g, state["m"].layout, dtype=wire)
            del g
            vec = guard.vector(guard.fold_decay(good), fault_mod.apply_skip(
                fault, True, micro=i, step=st0),
                scaler_mod.scale_into_fold(guard.inv_n(dev), sc))
            if fp8:
                state = _fold_fp8(state, slab, vec, sc, b1, b2)
            else:
                fused_step.finite_and(slab, vec[2:3])
                state, _ = state_store.fold_state(state, slab, beta1=b1,
                                                  beta2=b2, guard=vec)
            del slab
            ok = vec[2] != 0
            lsum = lsum + torch.where(ok, loss, 0.0) / sc["scale"]
            sc = scaler_mod.scaler_update(sc, ok, dynamic=dyn,
                                          growth_interval=gi)
            good = good + ok.to(torch.int32)
        params, _ = adama.finalize(
            params, dict(state, step=st0 + 1),
            lr=_lr(lr_schedule, opt, st0 + 1), beta1=b1, beta2=b2,
            eps=opt.eps, weight_decay=opt.weight_decay,
            guard=(good > 0).float().reshape(1))
        good, metrics = guard.read_back(
            good, sc, lsum / torch.clamp(good, min=1).float())
        return params, dict(state, step=st0 + (good > 0), scaler=sc), metrics

    return step, _init(opt)


def make_adama_layerwise_step(cfg: ModelConfig, opt: OptimizerConfig, *,
                              remat=False, lr_schedule=None, fault=None):
    """Algorithm 2. `remat` is accepted and unused, as in the reference:
    the engine already recomputes every layer from its saved input
    (core/layerwise.py), which is activation checkpointing."""
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2
    wire = grad_wire_dtype(opt.grad_dtype)
    if opt.finite_guard:
        return _make_guarded_layerwise_step(cfg, opt, lr_schedule, fault)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        if opt.arena:
            # each arena row is folded exactly once per micro-batch (each
            # layer's slice in the backward, the rest region after it), so
            # the begin-minibatch decay fuses into micro-batch 0's folds
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2)
        r = inv_n(n, batch["tokens"].device)
        lsum = torch.zeros((), dtype=torch.float32, device=r.device)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, state = layerwise_loss_and_fold(
                cfg, params, mb, state, beta1=b1, beta2=b2, scale=1.0 / n,
                decay=_fold_decay(i, b1, b2) if opt.arena else None,
                grad_dtype=wire)
            lsum = lsum + loss
        lr = _lr(lr_schedule, opt, state["step"])
        params, state = adama.finalize(
            params, state, lr=lr, beta1=b1, beta2=b2, eps=opt.eps,
            weight_decay=opt.weight_decay)
        return params, state, {"loss": lsum * r}

    return step, _init(opt)


def _make_guarded_layerwise_step(cfg, opt, lr_schedule, fault):
    """Algorithm 2 guarded: the backward is seeded with (1/N) * S (a
    nan/inf fault lands on the seed, and so reaches every slab), the guard
    vector [dm, dv, ok, 1/S] starts from the forced-skip verdict, and
    layerwise_loss_and_fold ANDs every check of the micro-batch into it."""
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2
    wire = grad_wire_dtype(opt.grad_dtype)
    dyn = scaler_mod.is_dynamic(opt)
    gi = opt.scaler_growth_interval
    guard = _Guard(opt)

    def step(params, opt_state, batch):
        adama.load_working_params(params, opt_state)
        dev = batch["tokens"].device
        st0 = opt_state["step"]
        state, sc = opt_state, opt_state["scaler"]
        good = torch.zeros((), dtype=torch.int32, device=dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(_split_micro(batch, n)):
            seed = fault_mod.corrupt_loss(
                fault, guard.inv_n(dev) * sc["scale"], micro=i, step=st0)
            vec = guard.vector(guard.fold_decay(good), fault_mod.apply_skip(
                fault, True, micro=i, step=st0), guard.one(dev) / sc["scale"])
            loss, state, ok = layerwise_loss_and_fold(
                cfg, params, mb, state, beta1=b1, beta2=b2, scale=seed,
                grad_dtype=wire, guard=vec)
            ok = ok.reshape(()) != 0
            # the loss is the unscaled ce: the scale only seeds the backward
            lsum = lsum + torch.where(ok, loss, 0.0)
            sc = scaler_mod.scaler_update(sc, ok, dynamic=dyn,
                                          growth_interval=gi)
            good = good + ok.to(torch.int32)
        params, _ = adama.finalize(
            params, dict(state, step=st0 + 1),
            lr=_lr(lr_schedule, opt, st0 + 1), beta1=b1, beta2=b2,
            eps=opt.eps, weight_decay=opt.weight_decay,
            guard=(good > 0).float().reshape(1))
        good, metrics = guard.read_back(
            good, sc, lsum / torch.clamp(good, min=1).float())
        return params, dict(state, step=st0 + (good > 0), scaler=sc), metrics

    return step, _init(opt)


def _init(opt: OptimizerConfig):
    init = adama.init_arena if opt.arena else adama.init

    def init_state(params):
        if opt.arena:
            state = init(params, codec=opt.state_codec, m_codec=opt.m_codec,
                         master_params=opt.master_params,
                         work_param_cache=opt.work_param_cache,
                         error_feedback=use_error_feedback(opt))
        else:
            state = init(params, codec=opt.state_codec, m_codec=opt.m_codec)
        if opt.finite_guard:
            state["scaler"] = scaler_mod.init_scaler(
                opt, arena_mod.tree_flatten(params)[0][0].device)
        return state
    return init_state


ENGINES = {"ga": make_ga_step, "adama": make_adama_step,
           "adama_layerwise": make_adama_layerwise_step}


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig, **kw):
    """Returns (step_fn, opt_init_fn) for the configured engine."""
    return ENGINES[opt.accumulation](cfg, opt, **kw)
