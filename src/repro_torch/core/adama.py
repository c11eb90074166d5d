"""AdamA — Adam Accumulation (the paper's contribution) over the state
arena, the arena branches of `repro/core/adama.py`.

The mini-batch lifecycle (Algorithm 1):

    state = init_arena(params)
    for each micro-batch i:
        state = accumulate(state, grads_i, beta1, beta2, scale=1/N,
                           decay=(beta1, beta2) if i == 0 else None)
    params, state = finalize(params, state, lr=..., ...)

`accumulate` is where gradients die: after the fold the packed gradient
has no further reader, and the caller drops it before the next
micro-batch's backward. The begin-minibatch decay (m *= b1, v *= b2) rides
in the first fold.

Unlike the reference, whose arrays are immutable and whose kernels alias
input to output, the port updates the m/v arenas and the params IN PLACE:
a "new" state returned here shares its tensors with the old one.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core import state_store

State = Dict[str, Any]


def init_arena(params, codec: str = "fp32", m_codec: str = "fp32") -> State:
    """Arena-backed state: m and v are zeroed fp32 arenas on the params'
    device, laid out as the reference lays them out; `step` is a host int.
    Any codec but fp32 raises (not ported yet)."""
    state_store.check_codecs(m_codec, codec)
    layout = arena_mod.build_layout(params)
    device = arena_mod.tree_flatten(params)[0][0].device
    return {"m": arena_mod.Arena.zeros(layout, device),
            "v": arena_mod.Arena.zeros(layout, device), "step": 0}


def accumulate(state: State, grads, beta1: float, beta2: float,
               scale: float = 1.0, decay=None) -> State:
    """Fold one micro-batch's gradient tree into (m, v): pack it into one
    fp32 slab and run one fused fold. `scale` multiplies g in-kernel
    (Algorithm 1's 1/N); `decay=(dm, dv)` fuses the begin-minibatch decay
    (pass it on the first micro-batch only)."""
    g = arena_mod.pack(grads, state["m"].layout)
    return state_store.fold_state(state, g, beta1=beta1, beta2=beta2,
                                  scale=scale, decay=decay)


def bias_corrections(step: int, beta1: float, beta2: float):
    """(1 - beta1**t, 1 - beta2**t) in float32 with float32 t, as the
    reference computes them."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (one - np.float32(beta1) ** t, one - np.float32(beta2) ** t)


@torch.no_grad()
def finalize(params, state: State, *, lr, beta1: float, beta2: float,
             eps: float = 1e-8, weight_decay: float = 0.0):
    """Bias-correct and apply (Algorithm 1's update). `state['step']` must
    already count this mini-batch. Packs the params, runs one fused apply,
    and copies the result back into the param leaves in place."""
    bc1, bc2 = bias_corrections(state["step"], beta1, beta2)
    layout = state["m"].layout
    p = state_store.apply_state(arena_mod.pack(params, layout), state, lr=lr,
                                bc1=bc1, bc2=bc2, eps=eps,
                                weight_decay=weight_decay)
    leaves, _ = arena_mod.tree_flatten(params)
    new, _ = arena_mod.tree_flatten(arena_mod.unpack(p, layout))
    for leaf, x in zip(leaves, new):
        leaf.copy_(x)
    return params, state
