"""Micro-batch accumulation engines — where AdamA meets the training loop
(`repro/core/accumulation.py`, the kernel paths).

  ga               baseline gradient accumulation: a param-sized fp32
                   accumulator slab sums pack(g)/N over the micro-batches,
                   then one fold (with the begin-minibatch decay) and one
                   apply. The paper's comparison point. Arena state only.
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
`OptimizerConfig.arena` selects the state form. Params and state are
updated in place; `step` returns them for symmetry with the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core import adama
from repro_torch.core import arena as arena_mod
from repro_torch.core import state_store
from repro_torch.core.layerwise import layerwise_loss_and_fold
from repro_torch.models.model import loss_fn


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


def _grads(cfg, params, leaves, mb):
    """(loss, gradient tree) of one micro-batch."""
    loss = loss_fn(cfg, params, mb)
    grads = torch.autograd.grad(loss, leaves)
    _, paths = arena_mod.tree_flatten(params)
    return loss.detach(), arena_mod.tree_unflatten(paths, list(grads))


def _lr(lr_schedule, opt: OptimizerConfig, step: int):
    return opt.lr if lr_schedule is None else lr_schedule(step)


def make_ga_step(cfg: ModelConfig, opt: OptimizerConfig, *, lr_schedule=None):
    n = opt.micro_batches

    def step(params, opt_state, batch):
        layout = opt_state["m"].layout
        leaves, _ = arena_mod.tree_flatten(params)
        acc = torch.zeros((layout.rows, arena_mod.LANES), dtype=torch.float32,
                          device=leaves[0].device)
        lsum = torch.zeros((), dtype=torch.float32, device=acc.device)
        for mb in _split_micro(batch, n):
            loss, g = _grads(cfg, params, leaves, mb)
            acc += arena_mod.pack(g, layout) / n
            del g
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
        return params, opt_state, {"loss": lsum / n}

    return step, _init(opt)


def make_adama_step(cfg: ModelConfig, opt: OptimizerConfig, *,
                    lr_schedule=None):
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2

    def step(params, opt_state, batch):
        leaves, _ = arena_mod.tree_flatten(params)
        if opt.arena:
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2)
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, g = _grads(cfg, params, leaves, mb)
            if opt.arena:
                state = adama.accumulate(state, g, b1, b2, scale=1.0 / n,
                                         decay=_fold_decay(i, b1, b2))
            else:
                # Algorithm 1 line 6 as the reference's per-leaf path does
                # it: a true division by N (a device scalar, so CUDA divides
                # too rather than multiplying by 1/N), then a fold at scale 1
                n_t = torch.tensor(float(n), device=loss.device)
                for x in arena_mod.tree_flatten(g)[0]:
                    x.div_(n_t)
                state = adama.accumulate(state, g, b1, b2)
            del g
            lsum = lsum + loss
        lr = _lr(lr_schedule, opt, state["step"])
        params, state = adama.finalize(
            params, state, lr=lr, beta1=b1, beta2=b2, eps=opt.eps,
            weight_decay=opt.weight_decay)
        return params, state, {"loss": lsum / n}

    return step, _init(opt)


def make_adama_layerwise_step(cfg: ModelConfig, opt: OptimizerConfig, *,
                              lr_schedule=None):
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2

    def step(params, opt_state, batch):
        if opt.arena:
            # each arena row is folded exactly once per micro-batch (each
            # layer's slice in the backward, the rest region after it), so
            # the begin-minibatch decay fuses into micro-batch 0's folds
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for i, mb in enumerate(_split_micro(batch, n)):
            loss, state = layerwise_loss_and_fold(
                cfg, params, mb, state, beta1=b1, beta2=b2, scale=1.0 / n,
                decay=_fold_decay(i, b1, b2) if opt.arena else None)
            lsum = lsum + loss
        lr = _lr(lr_schedule, opt, state["step"])
        params, state = adama.finalize(
            params, state, lr=lr, beta1=b1, beta2=b2, eps=opt.eps,
            weight_decay=opt.weight_decay)
        return params, state, {"loss": lsum / n}

    return step, _init(opt)


def _init(opt: OptimizerConfig):
    init = adama.init_arena if opt.arena else adama.init
    return lambda params: init(params, codec=opt.state_codec,
                               m_codec=opt.m_codec)


ENGINES = {"ga": make_ga_step, "adama": make_adama_step,
           "adama_layerwise": make_adama_layerwise_step}


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig, **kw):
    """Returns (step_fn, opt_init_fn) for the configured engine."""
    return ENGINES[opt.accumulation](cfg, opt, **kw)
