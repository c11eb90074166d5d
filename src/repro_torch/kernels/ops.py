"""Per-leaf kernel entry points over trees (`repro/kernels/ops.py`).

The reference flattens each leaf, pads it to (R, 1024) rows, runs the
kernel and slices the result back out. The port's kernels take a leaf as
it is (see adama_accum.py), so these fold and apply each leaf IN PLACE:
the moments (and params) passed in are the ones updated and returned.
"""
from __future__ import annotations

from repro_torch.core.arena import tree_flatten
from repro_torch.kernels.adam_apply import adam_apply_2d
from repro_torch.kernels.adama_accum import adama_accum_2d


def adama_accumulate(m, v, g, *, beta1, beta2, scale=1.0):
    """Single-leaf fold, in place. Returns (m, v)."""
    return adama_accum_2d(m, v, g, beta1=beta1, beta2=beta2, scale=scale)


def adama_accumulate_tree(m_tree, v_tree, g_tree, *, beta1, beta2,
                          scale=1.0):
    """Fold every leaf of a gradient tree into the matching moment leaves,
    in place, one launch per leaf. Returns (m_tree, v_tree)."""
    ms, paths = tree_flatten(m_tree)
    vs, gs = tree_flatten(v_tree), tree_flatten(g_tree)
    if vs[1] != paths or gs[1] != paths:
        raise ValueError("m, v and gradient trees differ in structure")
    for m, v, g in zip(ms, vs[0], gs[0]):
        adama_accum_2d(m, v, g, beta1=beta1, beta2=beta2, scale=scale)
    return m_tree, v_tree


def adam_apply(p, m, v, *, lr, bc1, bc2, eps=1e-8, weight_decay=0.0):
    """Single-leaf apply, p in place. Returns p."""
    return adam_apply_2d(p, m, v, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
                         weight_decay=weight_decay)


def adam_apply_tree(params, m_tree, v_tree, *, lr, bc1, bc2, eps=1e-8,
                    weight_decay=0.0):
    """Apply to every param leaf in place, one launch per leaf. Returns
    params."""
    ps, paths = tree_flatten(params)
    ms, vs = tree_flatten(m_tree), tree_flatten(v_tree)
    if ms[1] != paths or vs[1] != paths:
        raise ValueError("param, m and v trees differ in structure")
    for p, m, v in zip(ps, ms[0], vs[0]):
        adam_apply_2d(p, m, v, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
                      weight_decay=weight_decay)
    return params
