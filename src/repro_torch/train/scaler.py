"""Loss scaler and skip accounting around the fused finite guards
(`repro/train/scaler.py`), as pure functions on 0-d device tensors.

The guarded fold kernels (kernels/fused_step.py) commit nothing for a
micro-batch whose gradient is not finite. This module is the policy on top:

  scale     the live loss scale: the loss is multiplied by it before the
            backward, and the folds divide it back out in-kernel
            (`scale_into_fold`), so the moments never see it.
  growth    good micro-batches since the last skip or growth; at
            `growth_interval` a dynamic scale doubles (capped at SCALE_MAX).
  skipped   skipped micro-batches in all.
  consec    the current run of consecutive skips; train/loop.py aborts when
            it reaches OptimizerConfig.scaler_abort_after (> 0).

All four ride in the optimizer state dict under "scaler" as 0-d tensors on
the state's device, so the engines update them without reading them on the
host. Every guarded run carries them; the scale stays 1.0 unless loss
scaling is on (OptimizerConfig.loss_scale, on the bf16 gradient wire): a
static scale stays, a "dynamic" one starts at DYNAMIC_INIT, halves on every
skipped micro-batch and doubles after growth_interval good ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import parse_loss_scale

SCALE_GROWTH = 2.0          # growth factor at each growth_interval
SCALE_BACKOFF = 0.5         # backoff factor on every skipped micro-batch
SCALE_MIN = 1.0             # backoff floor (never scale the loss down)
SCALE_MAX = float(2 ** 24)  # growth ceiling
DYNAMIC_INIT = float(2 ** 15)


def wants_scaler(opt) -> bool:
    """Whether this OptimizerConfig carries scaler state: every
    finite_guard run does (skip accounting)."""
    return bool(opt.finite_guard)


def init_scaler(opt, device="cpu"):
    """The "scaler" entry of the optimizer state dict on `device`, or None
    when the config has no guard."""
    if not wants_scaler(opt):
        return None
    parsed = parse_loss_scale(opt.loss_scale)
    scale = {"off": 1.0, "dynamic": DYNAMIC_INIT}.get(parsed, parsed)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)
    return {"scale": torch.tensor(float(scale), dtype=torch.float32,
                                  device=device),
            "growth": i32(), "skipped": i32(), "consec": i32()}


def is_dynamic(opt) -> bool:
    return parse_loss_scale(opt.loss_scale) == "dynamic"


def scaler_update(sc, ok, *, dynamic: bool, growth_interval: int):
    """One micro-batch's transition, given its verdict `ok` (a 0-d bool
    tensor on the scaler's device). Skipped: the scale halves (floored at
    SCALE_MIN), the growth run resets, skipped and consec advance. Good: the
    growth run advances and at `growth_interval` the scale doubles (capped
    at SCALE_MAX), consec resets. With dynamic=False the scale stays; the
    counters still count. Returns a new dict."""
    scale = sc["scale"]
    grown = sc["growth"] + 1
    full = grown >= growth_interval
    if dynamic:
        scale_good = torch.where(
            full, torch.clamp(scale * SCALE_GROWTH, max=SCALE_MAX), scale)
        scale_bad = torch.clamp(scale * SCALE_BACKOFF, min=SCALE_MIN)
    else:
        scale_good = scale_bad = scale
    zero = torch.zeros_like(grown)
    return {"scale": torch.where(ok, scale_good, scale_bad),
            "growth": torch.where(ok, torch.where(full, zero, grown), zero),
            "skipped": sc["skipped"] + torch.where(ok, zero, zero + 1),
            "consec": torch.where(ok, zero, sc["consec"] + 1)}


def scale_loss(loss, sc):
    """The loss times the live scale, before the backward (the loss itself
    without a scaler)."""
    return loss if sc is None else loss * sc["scale"]


def scale_into_fold(scale, sc):
    """The fold's scale: the engine's 1/N divided by the live loss scale,
    as a 0-d float32 tensor on the scaler's device (a true division on
    every device), so the un-scaling rides in the kernel's multiply;
    `scale` itself without a scaler."""
    if sc is None:
        return scale
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=sc["scale"].device) / sc["scale"]


def scaler_metrics(state, prefix=""):
    """{name: 0-d tensor} metrics for the loop's logs; {} without a
    scaler."""
    sc = state.get("scaler") if isinstance(state, dict) else None
    if sc is None:
        return {}
    return {prefix + "loss_scale": sc["scale"],
            prefix + "skipped_micro_batches": sc["skipped"],
            prefix + "consec_skips": sc["consec"]}
