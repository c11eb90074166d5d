"""AdamA — Adam Accumulation (the paper's contribution), the arena and
per-leaf branches of `repro/core/adama.py`.

The mini-batch lifecycle (Algorithm 1), arena state:

    state = init_arena(params)
    for each micro-batch i:
        state = accumulate(state, grads_i, beta1, beta2, scale=1/N,
                           decay=(beta1, beta2) if i == 0 else None)
    params, state = finalize(params, state, lr=..., ...)

and per-leaf state (m and v are trees shaped like the params):

    state = init(params)
    state = begin_minibatch(state, beta1, beta2)     # m *= b1, v *= b2
    for each micro-batch i:
        state = accumulate(state, grads_i / N, beta1, beta2)
    params, state = finalize(params, state, lr=..., ...)

`accumulate` is where gradients die: after the fold the gradient has no
further reader, and the caller drops it before the next micro-batch's
backward. On arena state the begin-minibatch decay rides in the first fold.

Arena state carries each moment in its codec (core/state_store.py): fp32
arenas, int8 codes with row scales, or the factored row statistic; the
fold and apply kernels take every pair. Per-leaf state is fp32 only, as
the reference's config requires.

Master params (`init_arena(master_params=True)`): the state also holds the
fp32 master region "p", packed from the params. `finalize` then never packs
the params: the apply updates the master and writes bf16 working params in
the same kernel, and the param leaves are refreshed from them, so they hold
bf16(master). With the working-param cache ("wp", a bf16 arena) the kernel
writes into the cache, and the engines load the leaves from it at step
start (`load_working_params`).

The fp8 wire's error-feedback residual (`init_arena(error_feedback=True)`):
the state also holds "ef", a zeroed fp32 arena that the guarded engines
read and update around each fold (core/accumulation.py,
core/layerwise.py).

Unlike the reference, whose arrays are immutable and whose kernels alias
input to output, the port updates the moments and the params IN PLACE: a
"new" state returned here shares its tensors with the old one.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import state_store
from repro_torch.kernels import ops

State = Dict[str, Any]


def init(params, codec: str = "fp32", m_codec: str = "fp32") -> State:
    """Per-leaf state: m and v are zeroed fp32 trees shaped like the params;
    `step` is a host int. Any codec but fp32 raises: codecs are columns of
    the arena (use init_arena)."""
    for moment, name in (("m", m_codec), ("v", codec)):
        if state_store.get_codec(name, moment).name != "fp32":
            raise ValueError(f"{moment}-codec {name!r} requires arena state "
                             f"(arena=True): codecs are columns of the flat "
                             f"state arena (core/state_store.py)")
    leaves, paths = arena_mod.tree_flatten(params)

    def zeros():
        return arena_mod.tree_unflatten(paths, [
            torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in leaves])
    return {"m": zeros(), "v": zeros(), "step": 0}


def init_arena(params, codec: str = "fp32", m_codec: str = "fp32",
               master_params: bool = False, work_param_cache: bool = False,
               error_feedback: bool = False) -> State:
    """Arena-backed state on the params' device, laid out as the reference
    lays it out: m in `m_codec`, v in `codec` (fp32 moments are Arenas,
    the others MomentStates of the reference's column shapes), zeroed;
    `step` is a host int. `master_params` adds the fp32 master region
    state["p"] = pack(params); `work_param_cache` the bf16 working-param
    cache state["wp"] = pack(params, dtype=bfloat16) (the reference's
    regions, bit for bit); `error_feedback` the fp8 wire's residual
    state["ef"], a zeroed fp32 arena."""
    mc = state_store.get_codec(m_codec, "m")
    vc = state_store.get_codec(codec, "v")
    layout = arena_mod.build_layout(params)
    device = arena_mod.tree_flatten(params)[0][0].device
    state = {"m": mc.init(layout, device), "v": vc.init(layout, device),
             "step": 0}
    with torch.no_grad():
        if master_params:
            state["p"] = arena_mod.Arena(arena_mod.pack(params, layout),
                                         layout)
        if error_feedback:
            state["ef"] = arena_mod.Arena.zeros(layout, device)
        if work_param_cache:
            state["wp"] = arena_mod.Arena(arena_mod.pack(
                params, layout, dtype=torch.bfloat16), layout)
    return state


def working_params(state: State):
    """The param tree held by the working-param cache state["wp"], its
    leaves cast to their recorded dtypes (the reference's
    `working_params`)."""
    wp = state["wp"]
    return arena_mod.unpack(wp.data, wp.layout)


@torch.no_grad()
def load_working_params(params, state: State):
    """The engines' form of `working_params`, at step start: when the state
    has the cache, each param leaf, in place, from its bf16 view of it (no
    fp32 copy of the tree is made). Returns params."""
    if "wp" in state:
        _copy_leaves(params, state["wp"].data, state["wp"].layout,
                     torch.bfloat16)
    return params


def _copy_leaves(params, arena: torch.Tensor, layout, dtype=None) -> None:
    """leaf <- its slot of `arena`, in place; `dtype` the arena's, whose
    views then need no cast before the copy."""
    leaves, _ = arena_mod.tree_flatten(params)
    new, _ = arena_mod.tree_flatten(arena_mod.unpack(arena, layout, dtype))
    for leaf, x in zip(leaves, new):
        leaf.copy_(x)


def is_arena_state(state: State) -> bool:
    return state_store.is_arena_backed(state["m"])


def _scale_tree_(tree, factor: float) -> None:
    for x in arena_mod.tree_flatten(tree)[0]:
        x.mul_(factor)


@torch.no_grad()
def begin_minibatch(state: State, beta1: float, beta2: float) -> State:
    """Per-leaf state: m *= beta1, v *= beta2 (in place) and count the
    mini-batch. Arena state raises: the arena engines fuse this decay into
    the mini-batch's first fold."""
    if is_arena_state(state):
        raise ValueError("begin_minibatch takes per-leaf state; on arena "
                         "state the decay rides in the first fold "
                         "(accumulate(..., decay=(beta1, beta2)))")
    _scale_tree_(state["m"], beta1)
    _scale_tree_(state["v"], beta2)
    return dict(state, step=state["step"] + 1)


@torch.no_grad()
def accumulate(state: State, grads, beta1: float, beta2: float,
               scale: float = 1.0, decay=None, grad_dtype=torch.float32,
               guard=None) -> State:
    """Fold one micro-batch's gradient tree into (m, v). Arena state: pack
    it into one slab of the gradient wire's dtype (`grad_dtype`: float32,
    or bfloat16 for a half-size slab that the fold kernel upcasts in-pass,
    the moments still accumulating in fp32) and run one fused fold, in the
    state's codecs. Per-leaf state: one adama_accum_2d launch per leaf.
    `scale` multiplies g in-kernel (Algorithm 1's 1/N); `decay=(dm, dv)`
    applies the begin-minibatch decay first (fused into the fold on arena
    state; pass it on the first micro-batch only). `guard` (arena state
    only): True or a guard vector, as state_store.fold takes it; the return
    is then (state, guard vector)."""
    if is_arena_state(state):
        g = arena_mod.pack(grads, state["m"].layout, dtype=grad_dtype)
        return state_store.fold_state(state, g, beta1=beta1, beta2=beta2,
                                      scale=scale, decay=decay, guard=guard)
    if guard is not None:
        raise ValueError("finite guards require the arena fold path "
                         "(OptimizerConfig arena=True)")
    if decay is not None:
        _scale_tree_(state["m"], decay[0])
        _scale_tree_(state["v"], decay[1])
    ops.adama_accumulate_tree(state["m"], state["v"], grads, beta1=beta1,
                              beta2=beta2, scale=scale)
    return state


@torch.no_grad()
def accumulate_leaf(m, v, g, beta1: float, beta2: float):
    """Single-leaf fold, in place (the layer-wise backward, Algorithm 2)."""
    return ops.adama_accumulate(m, v, g, beta1=beta1, beta2=beta2)


def bias_corrections(step: int, beta1: float, beta2: float):
    """(1 - beta1**t, 1 - beta2**t) in float32 with float32 t, as the
    reference computes them."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (one - np.float32(beta1) ** t, one - np.float32(beta2) ** t)


@torch.no_grad()
def finalize(params, state: State, *, lr, beta1: float, beta2: float,
             eps: float = 1e-8, weight_decay: float = 0.0, guard=None):
    """Bias-correct and apply (Algorithm 1's update). `state['step']` must
    already count this mini-batch. Arena state: packs the params, runs one
    fused apply, and copies the result back into the param leaves in place;
    with a master region (state["p"]) the params are not packed: the master
    apply updates the master and writes bf16 working params (into the
    cache state["wp"] if there is one), and each leaf is copied from its
    bf16 view of them. Per-leaf state: one adam_apply_2d launch per param
    leaf, in place. `guard` (arena state only; a (1,) device flag, e.g.
    good > 0 after the guarded folds): when 0 the params (or the master)
    keep every byte, whatever bc1 is; the leaves then take bf16(master)."""
    bc1, bc2 = bias_corrections(state["step"], beta1, beta2)
    if not is_arena_state(state):
        if guard is not None:
            raise ValueError("finite guards require the arena apply path "
                             "(OptimizerConfig arena=True)")
        ops.adam_apply_tree(params, state["m"], state["v"], lr=lr, bc1=bc1,
                            bc2=bc2, eps=eps, weight_decay=weight_decay)
        return params, state
    layout = state["m"].layout
    if state_store.has_master(state):
        work, state = state_store.apply_master_state(
            state, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
            weight_decay=weight_decay, guard=guard)
        _copy_leaves(params, work, layout, work.dtype)
        return params, state
    p = state_store.apply_state(arena_mod.pack(params, layout), state, lr=lr,
                                bc1=bc1, bc2=bc2, eps=eps,
                                weight_decay=weight_decay, guard=guard)
    _copy_leaves(params, p, layout)
    return params, state
