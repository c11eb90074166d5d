"""Algorithm 2: interleave the per-LAYER backward with the AdamA fold
(`repro/core/layerwise.py`, every family of the reference's configs, one
device, the fp32, bf16 or fp8 gradient wire, with or without the finite
guard).

The port's block params are stacked: each leaf is one (L, ...) tensor. A
gradient hook on such a leaf fires only once autograd has written the
whole stack's gradient, so hooks cannot free one layer's gradient at a
time. The schedule is written out instead, as the reference's reverse scan
does:

  1. the forward runs under `torch.no_grad()` through the stages (an MoE
     model's `dense_blocks`, then `blocks`; `models.model.stages`),
     saving each layer's INPUT and summing the layers' aux losses as the
     reference does;
  2. the head (final norm, lm_head, cross entropy) runs with autograd and
     its backward is seeded with `scale` (= 1/N), so every gradient below
     arrives pre-scaled; the loss is ce + the aux total;
  3. stage by stage in reverse, for j = L-1 ... 0, layer j is recomputed
     from its saved input on detached views of its slice of the stacked
     params, and `torch.autograd.grad` of (its output, its aux loss),
     seeded with (dx, scale), gives that layer's param gradients and the
     gradient of its input; the layer gradients are folded into (m, v) and
     dropped before layer j-1;
  4. last, the embedding's backward, and the fold of the rest region.

Peak gradient memory is therefore one layer's (plus the head's and the
embedding's), which is the paper's 1/M claim; the recompute in step 3 makes
the engine activation checkpointing as well.

A vlm runs the same schedule from [patches; text] (the patches a constant
before the embedding), its head on the text tail. An enc-dec model has a
form of its own (`_layerwise_audio`): the decoder's layers, each reading
the encoder's output, then the encoder norm's and the encoder's.

Arena state: each layer's gradient tree is packed into one
(layer_rows, LANES) slab of the wire's dtype (`grad_dtype`: float32, or
bfloat16, which the kernel upcasts in-pass) and folded into the layer's
row range with ONE `arena_fold_slice` launch; the rest region likewise,
once per micro-batch.
The launch carries every codec column of the slice (int8 codes and row
scales, the factored statistic, rowcol's row sums) and adds into the
columns every row shares (rowcol's column sums).
`decay` rides in every one of those folds for the row-indexed columns:
each arena row belongs to exactly one slice. The shared columns are
decayed once per micro-batch, before the first slice fold
(`state_store.begin_micro_state`), as the reference's engine does.
Per-leaf state: each gradient leaf is folded into the matching view of
the m/v trees (layer j's row of a stacked moment) with one
`adama_accum_2d` launch.

Guarded (arena state; `guard`, the guard vector [dm, dv, ok, fold_scale]
whose ok holds the engine's external verdict): the pre-backward guard ANDs
the finiteness of dx and of the head's gradients (final norm, lm_head)
into ok before anything commits (`_pre_guard`), the shared columns' decay
is where-predicated on it, and each layer's and the rest region's slab
ANDs its own check in before its slice fold, every fold predicated on the
running verdict (once false, every later fold is off). A loss-originated
NaN reaches dx and so every slab: the whole micro-batch is a bitwise
no-op. All of it is `finite_and` on the one device vector: no flag is read
on the host.

The fp8 wire (grad_dtype=float8_e4m3fn; guarded arena state only, as the
config requires): each layer's and the rest region's slab packs fp32 and
runs the reference's single-device front and back halves
(`_fp8_wire_slab`, `_fp8_ef_update`) as kernels/fp8_wire.py's two passes
around its guarded slice fold: the encode injects the slab's rows of the
error-feedback residual state["ef"] at S = 1 / fold_scale (formed on the
device, as the reference's `ef_scale = 1.0 / fold_scale`) and ANDs the
slab's finite flag into the running verdict in place of `finite_and`; the
slice fold decodes the codes in-pass; the residual's update is predicated
on the same verdict.

ZeRO-1 streaming (`zero=ZeroStream(...)`, driven by the data-parallel
engine, core/dp_shardmap.py; arena state, the fp32 wire): the state is the
rank's OWNED rows (partition order, core/buckets.py), and each layer's
packed slab is reduce-scattered over the stream's process group the moment
its backward gives it; the received, fully reduced slice folds into the
owned block at the layer's partition offset (`BucketPlan.stack_slice`:
layer 0's offset + j x slice rows) and the slab is dropped. The rest
region streams the same way, one size-capped bucket at a time: pack its
rows, reduce-scatter, fold the slice at its `own_offset`. No gradient
tree of more than a layer and no gradient arena is ever live. The shared
columns decay by the stream's `replicated_decay` (dv / M, so that the
ranks' partial column sums add up to the whole arena's). Guarded, the
pre-backward verdict and each received slice's finite flag are agreed
over the group (`collectives.agree`) before the fold they predicate: every
rank folds, or none does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import arena as arena_mod
from repro_torch.core import collectives, state_store
from repro_torch.core.adama import accumulate_leaf, is_arena_state
from repro_torch.core.arena import STACK_KEYS
from repro_torch.kernels import fp8_wire, fused_step
from repro_torch.models import modules as md
from repro_torch.models.model import (apply_block, cross_entropy,
                                      dec_block, embed_tokens, stages,
                                      vlm_input)


@dataclass(frozen=True)
class ZeroStream:
    """The ZeRO-1 stream's context (the reference's `ZeroStream`): the
    bucket plan (core/buckets.py), the process group to reduce-scatter
    over (None: the default group), and the shared columns' decay pair,
    dv pre-divided by the group's size (host numbers or device scalars;
    None: the fold's own decay)."""
    plan: Any
    group: Any = None
    replicated_decay: Optional[Tuple] = None


def _fold_tree(m, v, g, beta1, beta2) -> None:
    """Per-leaf fold of a gradient tree into matching m/v trees (or leaf
    views), in place."""
    ms, paths = arena_mod.tree_flatten(m)
    vs, _ = arena_mod.tree_flatten(v)
    gs = arena_mod.flatten_up_to(g, paths)
    for mx, vx, gx in zip(ms, vs, gs):
        accumulate_leaf(mx, vx, gx, beta1, beta2)


def _fold_slab(state, g2, row_offset, block, beta1, beta2, decay,
               guard, ef_scale=None, zero=None) -> None:
    """One slice fold of a packed slab; guarded, the slab's finite flag is
    ANDed into the guard vector's ok first, and agreed over the stream's
    group under `zero` (g2 then the received slice). `ef_scale` (the fp8
    wire: S, a (1,) device tensor) encodes the fp32 slab with the
    residual's rows injected first, folds the codes and updates the
    residual's rows."""
    if guard is None:
        state_store.fold_slice_state(state, g2, row_offset, beta1=beta1,
                                     beta2=beta2, block=block, decay=decay)
        return
    ok = guard[2:3]
    if ef_scale is None:
        fused_step.finite_and(g2, ok)
        if zero is not None:
            collectives.agree(ok, zero.group)
        state_store.fold_slice_state(state, g2, row_offset, beta1=beta1,
                                     beta2=beta2, block=block, guard=guard)
        return
    ef = (state["ef"].data[row_offset:row_offset + g2.shape[0]]
          if "ef" in state else None)
    codes, gs = fp8_wire.fp8_encode(g2, ef=ef, scale=ef_scale, ok=ok)
    state_store.fold_slice_state(state, codes, row_offset, beta1=beta1,
                                 beta2=beta2, block=block, grad_scale=gs,
                                 guard=guard)
    if ef is not None:
        fp8_wire.fp8_ef_update(ef, g2, codes, gs, scale=ef_scale, ok=ok)


def _fold_layer(state, dlp, j: int, name: str, beta1, beta2, decay,
                guard=None, grad_dtype=torch.float32, ef_scale=None,
                zero=None) -> None:
    """Fold layer j's gradient tree. Arena state: pack it into one slab of
    the wire's dtype (`grad_dtype`: the pack's; fp32 on the fp8 wire) and
    fold it into the layer's arena rows with one slice fold (guarded: the
    running verdict ANDed with the slab's; `ef_scale` as in `_fold_slab`);
    under `zero` the slab is reduce-scattered first and this rank's slice
    folds at the layer's partition offset. Per-leaf state: fold each leaf
    into row j of the stacked moments."""
    if is_arena_state(state):
        lay = state["m"].layout
        spec = lay.stack(name)
        g2 = arena_mod.pack_layer(dlp, spec, dtype=grad_dtype)
        if zero is None:
            off, block = spec.row + j * spec.layer_rows, lay.slice_block(spec)
        else:
            g2 = collectives.reduce_scatter(g2, zero.group)
            base, lslice, block = zero.plan.stack_slice(name)
            off = base + j * lslice
        _fold_slab(state, g2, off, block, beta1, beta2, decay, guard,
                   ef_scale, zero)
        return
    m_j = {k: x[j] for k, x in state["m"][name].items()}
    v_j = {k: x[j] for k, x in state["v"][name].items()}
    _fold_tree(m_j, v_j, dlp, beta1, beta2)


def _fold_rest(state, d_rest, beta1, beta2, decay, guard=None,
               grad_dtype=torch.float32, ef_scale=None, zero=None) -> None:
    """Fold the non-stacked leaves' gradients. Arena state: one slice fold
    over the contiguous rest region, its slab of the wire's dtype (guarded,
    and on the fp8 wire, as `_fold_layer`); under `zero` one rest bucket
    at a time: pack its rows, reduce-scatter, fold the slice at its
    `own_offset`. Per-leaf state: leaf by leaf."""
    if is_arena_state(state):
        lay = state["m"].layout
        if not lay.rest.rows:
            return
        if zero is None:
            _fold_slab(state, arena_mod.pack_rest(d_rest, lay,
                                                  dtype=grad_dtype),
                       lay.rest.row, lay.slice_block(lay.rest), beta1, beta2,
                       decay, guard, ef_scale)
            return
        for b in zero.plan.grad_buckets():
            if b.kind == "rest":
                own = collectives.reduce_scatter(arena_mod.pack_rest_rows(
                    d_rest, lay, b.start, b.stop, dtype=grad_dtype),
                    zero.group)
                _fold_slab(state, own, b.own_offset, b.fold_block, beta1,
                           beta2, decay, guard, ef_scale, zero)
                del own
        return
    for k, g in d_rest.items():
        _fold_tree(state["m"][k], state["v"][k], g, beta1, beta2)


def _requires_grad(tree):
    """Detached leaves (views of the same memory) that autograd tracks."""
    return {k: x.detach().requires_grad_(True) for k, x in tree.items()}


def _pre_guard(guard, dx, d_rest_post, zero=None) -> None:
    """The pre-backward guard: AND the finiteness of the backward's seed dx
    and of the head's gradients into the guard vector's ok, before any fold
    or shared-column decay commits; agreed over the stream's group under
    `zero`."""
    ok = guard[2:3]
    fused_step.finite_and(dx, ok)
    for leaf in arena_mod.tree_flatten(d_rest_post)[0]:
        fused_step.finite_and(leaf, ok)
    if zero is not None:
        collectives.agree(ok, zero.group)


def _head_backward(cfg, rest, x, s, labels, scale):
    """The head (final norm on the last `s` positions of x: a vlm's text
    tail, lm_head, cross entropy) and its backward seeded with `scale`:
    (ce, the gradients of the final norm and lm_head, dx, the seed as a
    device scalar)."""
    h = md.apply_norm(cfg, rest, x[:, -s:] if x.shape[1] != s else x,
                      "final_norm_")
    logits = (h @ rest["lm_head"].to(h.dtype)).float()
    ce = cross_entropy(logits, labels)
    post_keys = [k for k in rest if k.startswith("final_norm_")
                 or k == "lm_head"]
    seed = (scale if isinstance(scale, torch.Tensor) else
            torch.tensor(scale, dtype=torch.float32, device=ce.device))
    grads = torch.autograd.grad(
        ce, [rest[k] for k in post_keys] + [x], grad_outputs=seed)
    return ce.detach(), dict(zip(post_keys, grads[:-1])), grads[-1], seed


def _begin(state, fold_kw, dx, d_rest) -> None:
    """Before the first fold of a micro-batch: the pre-backward guard
    (guarded), then the shared columns' decay (the stream's replicated
    decay under `zero`), where-predicated on its verdict."""
    decay, guard, zero = fold_kw["decay"], fold_kw["guard"], fold_kw["zero"]
    rdecay = None if zero is None else zero.replicated_decay
    if guard is not None:
        _pre_guard(guard, dx, d_rest, zero)
        state_store.begin_micro_state(
            state, rdecay or (guard[0], guard[1]), guard=guard[2:3])
    elif decay is not None:
        state_store.begin_micro_state(state, rdecay or decay)


def _layer_backward(fn, lp, inputs, dx, seed):
    """Recompute one layer, fn(lp, *inputs) -> (y, aux), on detached leaves
    and `torch.autograd.grad` of (y, aux) seeded with (dx, seed): (the
    layer's param gradients, by key, the inputs' gradients)."""
    keys = sorted(lp)
    y, a = fn(lp, *inputs)
    # the aux loss's cotangent is the seed, as the reference's
    # vjp((dx, scale)); a block without one returns a constant
    outs, seeds = ([y, a], [dx, seed]) if a.requires_grad else ([y], [dx])
    g = torch.autograd.grad(outs, [lp[k] for k in keys] + list(inputs),
                            grad_outputs=seeds)
    return dict(zip(keys, g[:len(keys)])), g[len(keys):]


def _backward_stack(state, params, name, saved, dx, seed, fold_kw, fn,
                    extra=()):
    """A stacked region's layers in reverse: each recomputed from its saved
    input (with `extra`, inputs every layer reads, e.g. the encoder's
    output, made leaves that require grad), its gradients folded into the
    region's rows (`_fold_layer`) and dropped before the layer below.
    Returns (dx at the region's input, the gradients of `extra` summed
    over the layers, from the last layer down, in their own dtype)."""
    stack = params[name]
    keys = sorted(stack)
    dextra = [torch.zeros_like(e) for e in extra]
    for j in reversed(range(len(saved))):
        lp = _requires_grad({k: stack[k][j] for k in keys})
        inputs = [saved.pop().requires_grad_(True)] + [
            e.detach().requires_grad_(True) for e in extra]
        dl, dins = _layer_backward(fn, lp, inputs, dx, seed)
        dx = dins[0]
        dextra = [d + e for d, e in zip(dextra, dins[1:])]
        del inputs, dins
        _fold_layer(state, dl, j, name, **fold_kw)
        del dl
    return dx, dextra


def _forward_stack(fn, stack, x, extra=()):
    """A stacked region's layers under no_grad from x, fn(layer params, h,
    *extra) -> (y, aux): (the output, each layer's input, the layers' aux
    losses summed from zero)."""
    keys = sorted(stack)
    saved = []
    with torch.no_grad():
        auxs = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(stack[keys[0]].shape[0]):
            saved.append(x)
            x, a = fn({k: stack[k][j] for k in keys}, x, *extra)
            auxs = auxs + a
    return x, saved, auxs


def layerwise_loss_and_fold(cfg: ModelConfig, params, batch, state, *,
                            beta1: float, beta2: float, scale, decay=None,
                            grad_dtype=torch.float32, guard=None,
                            zero: Optional[ZeroStream] = None):
    """One micro-batch: forward, then layer-by-layer backward folding each
    layer's gradients into (m, v) in place. Gradients are scaled by `scale`
    (1/N, Algorithm 1 line 6; a host number or a 0-d float32 device tensor)
    through the backward's seed. `decay` (arena state only) fuses the
    begin-minibatch decay into this micro-batch's folds. `grad_dtype`
    (arena state only) is the gradient wire the layer and rest slabs are
    packed in; float8_e4m3fn (guarded only) packs fp32 and encodes each
    slab (see the module's docstring). Returns (loss, state).

    `guard` (arena state only): the guard vector [dm, dv, ok, fold_scale]
    (kernels/fused_step.py), in place of `decay`: ok holds the engine's
    external verdict on entry and every check of the micro-batch is ANDed
    into it (see the module's docstring); every fold reads the vector, the
    slabs being scaled by `scale` (the seed, which may carry the loss
    scale S) and un-scaled by fold_scale (1/S). Returns (loss, state, ok),
    ok the vector's (1,) verdict.

    `zero` (a ZeroStream; arena state, the fp32 wire): the ZeRO-1 stream
    (see the module's docstring); `state` then holds this rank's owned
    rows, in partition order, and `scale` is 1/(N x M)."""
    if (decay is not None or guard is not None or zero is not None) and \
            not is_arena_state(state):
        raise ValueError("a fused decay, a finite guard or the ZeRO-1 "
                         "stream requires arena state")
    if zero is not None and grad_dtype != torch.float32:
        raise NotImplementedError(
            f"grad_dtype={grad_dtype} under the ZeRO-1 stream is not ported "
            f"(ROADMAP queue 1, item 10.2 for bf16, 10.3 for fp8)")
    if guard is not None and decay is not None:
        raise ValueError("with guard=, the decay rides in the guard vector")
    ef_scale = None
    if grad_dtype == torch.float8_e4m3fn:
        if guard is None or not is_arena_state(state):
            raise ValueError("the fp8 wire requires finite guards over arena "
                             "state (OptimizerConfig enforces finite_guard "
                             "for grad_dtype='fp8_e4m3')")
        # the residual is stored unscaled and the slabs carry the loss scale
        # S: the encode multiplies by S = 1 / fold_scale, the update divides
        ef_scale = torch.ones_like(guard[3:4]) / guard[3:4]
        grad_dtype = torch.float32
    fold_kw = dict(beta1=beta1, beta2=beta2, decay=decay, guard=guard,
                   grad_dtype=grad_dtype, ef_scale=ef_scale, zero=zero)
    if cfg.arch_type == "audio":
        return _layerwise_audio(cfg, params, batch, state, scale, fold_kw)
    causal = cfg.arch_type != "encoder"
    tokens = batch["tokens"]
    b, s = tokens.shape
    plan = stages(cfg, params)

    # ---- forward, saving layer inputs ----
    rest = _requires_grad({k: x for k, x in params.items()
                           if k not in STACK_KEYS})
    if cfg.arch_type == "vlm":
        # the constant patches before the text's embedding; the head
        # reads the text tail
        x0, positions = vlm_input(cfg, rest, tokens, batch["patches"])
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
        x0 = embed_tokens(cfg, rest, tokens, positions)

    def block(kind):
        return lambda lp, h: apply_block(cfg, lp, h, positions, kind=kind,
                                         causal=causal)
    saved: Dict[str, List[torch.Tensor]] = {}
    x = x0.detach()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, kind in plan:
        x, saved[name], auxs = _forward_stack(block(kind), params[name], x)
        aux_total = aux_total + auxs

    # ---- head, backward seeded with `scale` ----
    ce, d_rest, dx, seed = _head_backward(cfg, rest, x.requires_grad_(True),
                                          s, batch["labels"], scale)
    loss = ce + aux_total
    del x

    # ---- backward, one layer at a time, folding as it goes ----
    _begin(state, fold_kw, dx, d_rest)
    for name, kind in reversed(plan):
        dx, _ = _backward_stack(state, params, name, saved[name], dx, seed,
                                fold_kw, block(kind))

    # ---- embedding backward, rest-region fold ----
    return _finish(state, rest, d_rest, x0, dx, loss, fold_kw)


def _finish(state, rest, d_rest, x0, dx, loss, fold_kw):
    """The embedding's backward from dx at its output x0, the rest region's
    fold; returns (loss, state[, the guard's verdict])."""
    (d_rest["embed"],) = torch.autograd.grad(x0, [rest["embed"]],
                                             grad_outputs=dx)
    del x0, dx
    _fold_rest(state, d_rest, **fold_kw)
    guard = fold_kw["guard"]
    if guard is not None:
        return loss.detach(), state, guard[2:3]
    return loss.detach(), state


def _layerwise_audio(cfg, params, batch, state, scale, fold_kw):
    """Algorithm 2 for an enc-dec model (the reference's
    `_layerwise_audio`): the decoder's layers, then the encoder's.

      1. the encoder's forward under no_grad from the stub frames plus
         their sinusoidal positions, saving each layer's input;
      2. the encoder's norm with autograd: enc_out;
      3. the decoder's forward under no_grad, saving each layer's input;
      4. the head's backward seeded with `scale`;
      5. the decoder's layers in reverse, each recomputed (its cross keys
         and values from enc_out, a leaf that requires grad) and folded
         into the `blocks` rows; d(enc_out) is summed over them from the
         last layer down in enc_out's own dtype (bf16 under bf16 compute,
         as the reference's zeros_like(enc_out) carry);
      6. the encoder norm's backward from it, then the encoder's layers in
         reverse, folded into the `enc_blocks` rows;
      7. the embedding's backward, and one fold of the rest region: the
         final norm's and lm_head's gradients from the head, the encoder
         norm's from step 6, the embedding's from step 7 (each leaf has
         one of them: the reference's (post + enc_norm) + pre adds zeros
         to it).

    The loss returned is the cross entropy (the blocks have no aux loss)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    rest = _requires_grad({k: x for k, x in params.items()
                           if k not in STACK_KEYS})
    frames = batch["frames"].to(getattr(torch, cfg.compute_dtype))
    se = frames.shape[1]
    epos = torch.arange(se, dtype=torch.int32,
                        device=tokens.device).expand(b, se)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)

    def enc_block(lp, h):
        return apply_block(cfg, lp, h, epos, kind="dense", causal=False)

    def dec(lp, h, eo):
        return dec_block(cfg, lp, h, eo, positions)

    # ---- encoder forward, its norm with autograd, decoder forward ----
    e0 = frames + md.sinusoidal_positions(epos, cfg.d_model).to(frames.dtype)
    e, enc_saved, _ = _forward_stack(enc_block, params["enc_blocks"], e0)
    e = e.requires_grad_(True)
    enc_out = md.apply_norm(cfg, rest, e, "enc_norm_")
    x0 = embed_tokens(cfg, rest, tokens, positions)
    x, dec_saved, _ = _forward_stack(dec, params["blocks"], x0.detach(),
                                     (enc_out.detach(),))

    # ---- head, backward seeded with `scale` ----
    ce, d_rest, dx, seed = _head_backward(cfg, rest, x.requires_grad_(True),
                                          s, batch["labels"], scale)
    del x

    # ---- decoder backward, then the encoder's ----
    _begin(state, fold_kw, dx, d_rest)
    dx, (denc,) = _backward_stack(state, params, "blocks", dec_saved, dx,
                                  seed, fold_kw, dec, (enc_out.detach(),))
    norm_keys = [k for k in rest if k.startswith("enc_norm_")]
    *dnorm, de = torch.autograd.grad(enc_out, [rest[k] for k in norm_keys]
                                     + [e], grad_outputs=denc)
    d_rest.update(zip(norm_keys, dnorm))
    del enc_out, e, denc, dnorm
    _backward_stack(state, params, "enc_blocks", enc_saved, de, seed,
                    fold_kw, enc_block)
    del de
    return _finish(state, rest, d_rest, x0, dx, ce, fold_kw)
