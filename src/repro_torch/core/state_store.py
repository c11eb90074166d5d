"""Optimizer-state store over the arena (`repro/core/state_store.py`).

This slice ports the fp32 codec only: each moment is a full-precision
Arena, folded and applied by one fused kernel each. The reference's int8,
factored and rowcol codecs are queued (ROADMAP queue 1, item 7); asking
for one raises NotImplementedError.
"""
from __future__ import annotations

from repro_torch.kernels import fused_step

PORTED_CODECS = ("fp32",)
_QUEUED_CODECS = ("int8", "factored", "rowcol")


def check_codecs(m_codec: str, v_codec: str) -> None:
    """Refuse any (m, v) codec pair this port cannot run."""
    for moment, name in (("m", m_codec), ("v", v_codec)):
        if name in PORTED_CODECS:
            continue
        if name in _QUEUED_CODECS:
            raise NotImplementedError(
                f"{moment}-codec {name!r} is not ported yet (ROADMAP queue 1, "
                f"item 7: remaining codecs); this port has {PORTED_CODECS}")
        raise KeyError(f"unknown {moment}-codec {name!r}; available: "
                       f"{PORTED_CODECS}")


def fold_state(state, g, *, beta1, beta2, scale=1.0, decay=None):
    """One fused fold of a packed gradient arena into the state dict's
    m/v arenas, in place."""
    fused_step.arena_fold(state["m"].data, state["v"].data, g, beta1=beta1,
                          beta2=beta2, scale=scale, decay=decay)
    return state


def fold_slice(m, v, g, row_offset, *, beta1, beta2, block, scale=1.0,
               decay=None):
    """Fold a packed gradient slab into arena rows
    [row_offset, row_offset + rows_g) of the m/v arena tensors, in place
    (one slice-fold kernel). Returns (m, v)."""
    return fused_step.arena_fold_slice(m, v, g, row_offset, beta1=beta1,
                                       beta2=beta2, block=block, scale=scale,
                                       decay=decay)


def apply_state(p, state, *, lr, bc1, bc2, eps=1e-8, weight_decay=0.0):
    """One fused bias-corrected apply of the state dict onto a param arena,
    p updated in place."""
    return fused_step.arena_apply(p, state["m"].data, state["v"].data, lr=lr,
                                  bc1=bc1, bc2=bc2, eps=eps,
                                  weight_decay=weight_decay)
