"""Baseline Adam (Kingma & Ba, 2014), the paper's comparison point
(`repro/optim/adam.py`): per-leaf fp32 moments, plain torch, no kernel, as
the reference's plain jnp. The data-parallel engine's `ga` variant
(core/dp_shardmap.py) applies its all-reduced gradient with it.

Unlike the reference, which returns new trees, `update` writes the
moments and the params IN PLACE and returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import tree_flatten, tree_unflatten


def init(params):
    """m and v zeroed fp32 trees shaped like the params; `step` a host
    int."""
    leaves, paths = tree_flatten(params)

    def zeros():
        return tree_unflatten(paths, [
            torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in leaves])
    return {"m": zeros(), "v": zeros(), "step": 0}


@torch.no_grad()
def update(grads, state, params, *, lr, beta1=0.9, beta2=0.999, eps=1e-8,
           weight_decay=0.0):
    """One Adam step: m = b1*m + (1-b1)*g, v = b2*v + (1-b2)*g^2, then
    p -= lr * (m/bc1) / (sqrt(v/bc2) + eps) (+ weight_decay * p inside the
    update), with bc = 1 - beta**t at t = step + 1 in float32, as the
    reference forms them. Returns (params, state)."""
    step = state["step"] + 1
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(beta1) ** t)
    bc2 = float(np.float32(1) - np.float32(beta2) ** t)
    c1, c2 = 1.0 - beta1, 1.0 - beta2
    ps, paths = tree_flatten(params)
    ms, vs, gs = (tree_flatten(x)[0] for x in (state["m"], state["v"],
                                                grads))
    for p, m, v, g in zip(ps, ms, vs, gs):
        g = g.float()
        m.mul_(beta1).add_(g * c1)
        v.mul_(beta2).add_(torch.square(g) * c2)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, dict(state, step=step)
