"""Model assembly for the dense and encoder families: parameter init, the
training forward pass and the loss (`repro/models/model.py`).

Param tree layout, the reference's key for key:
  {"embed": (V_pad, D), "lm_head": (D, V_pad),
   "final_norm_scale"/"final_norm_bias": (D,),
   "blocks": {leaf: (L, ...)}}              # stacked, leading layer axis

`Model` is an nn.Module whose parameters are exactly these leaves, so the
arena layout built from `Model.tree()` is the reference's. The forward is a
plain function of the tree (`forward`, `loss_fn`), which lets the engines
take `torch.autograd.grad` with respect to the leaves.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.arena import tree_flatten, tree_unflatten
from repro_torch.models import modules as md

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init (the reference's shapes and scales, drawn from a torch.Generator)
# ---------------------------------------------------------------------------


def _norm_params(cfg, d, prefix, device):
    p = {prefix + "scale": torch.ones((d,), dtype=torch.float32,
                                      device=device)}
    if cfg.norm == "layernorm":
        p[prefix + "bias"] = torch.zeros((d,), dtype=torch.float32,
                                         device=device)
    return p


def _dense(gen, shape, scale=0.02):
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=gen.device)


def _attn_params(cfg, gen, lead):
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    return {"wq": _dense(gen, lead + (d, h, hd)),
            "wk": _dense(gen, lead + (d, kv, hd)),
            "wv": _dense(gen, lead + (d, kv, hd)),
            "wo": _dense(gen, lead + (h, hd, d), out_scale)}


def _mlp_params(cfg, gen, lead):
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    if cfg.act == "silu":
        return {"w_gate": _dense(gen, lead + (d, f)),
                "w_up": _dense(gen, lead + (d, f)),
                "w_down": _dense(gen, lead + (f, d), out_scale)}
    return {"w_up": _dense(gen, lead + (d, f)),
            "w_down": _dense(gen, lead + (f, d), out_scale)}


def _block_params(cfg, gen, n_layers):
    """The dense block's params for all layers at once (leading L axis)."""
    lead = (n_layers,)
    p = {}
    for prefix in ("attn_norm_", "mlp_norm_"):
        for k, x in _norm_params(cfg, cfg.d_model, prefix, gen.device).items():
            p[k] = x.expand(lead + x.shape).clone()
    p.update(_attn_params(cfg, gen, lead))
    p.update(_mlp_params(cfg, gen, lead))
    return p


def _check_family(cfg: ModelConfig):
    if cfg.arch_type not in ("dense", "encoder") or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} attention="
            f"{cfg.attention!r} is not ported yet (ROADMAP queue 1, item 9: "
            f"other model families); this port runs dense and encoder gqa "
            f"models")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on `gen.device`, with the reference's shapes, scales and
    keys. The draws differ from jax.random's; tests that need the
    reference's numbers go through `params_from_jax`."""
    _check_family(cfg)
    vp = cfg.padded_vocab()
    params: Params = {"embed": _dense(gen, (vp, cfg.d_model)),
                      "lm_head": _dense(gen, (cfg.d_model, vp))}
    params.update(_norm_params(cfg, cfg.d_model, "final_norm_", gen.device))
    params["blocks"] = _block_params(cfg, gen, cfg.num_layers)
    return params


def params_from_jax(tree_of_numpy, device) -> Params:
    """The reference's param tree (a nested dict of numpy arrays, e.g.
    `np.asarray`-ed `repro.models.model.init_params` leaves) as a tree of
    fp32 tensors on `device`."""
    leaves, paths = tree_flatten(tree_of_numpy)
    return tree_unflatten(paths, [
        torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
        for x in leaves])


class Model(nn.Module):
    """Holds a param tree as nn.Parameters under the reference's names:
    top-level leaves directly, the stacked layers in `self.blocks`."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        for k, x in params.items():
            if k != "blocks":
                self.register_parameter(k, nn.Parameter(x))
        self.blocks = nn.ParameterDict(
            {k: nn.Parameter(x) for k, x in params["blocks"].items()})

    def tree(self) -> Params:
        tree = {k: p for k, p in self.named_parameters(recurse=False)}
        tree["blocks"] = dict(self.blocks.items())
        return tree

    def forward(self, batch):
        return forward(self.cfg, self.tree(), batch)


# ---------------------------------------------------------------------------
# Forward + loss
# ---------------------------------------------------------------------------


def apply_block(cfg, p, x, positions, *, causal=True):
    """One dense transformer block on (B, S, D)."""
    a_in = md.apply_norm(cfg, p, x, "attn_norm_")
    x = x + md.gqa_attention(cfg, p, a_in, positions, causal=causal)
    m_in = md.apply_norm(cfg, p, x, "mlp_norm_")
    return x + md.mlp(cfg, p, m_in)


def run_blocks(cfg, stack, x, positions, *, causal=True):
    """The layer loop over a stacked subtree (the reference scans it).
    `unbind` splits each stacked leaf once, so the backward writes each
    leaf's gradient as one stacked tensor."""
    keys = sorted(stack)
    per_leaf = [torch.unbind(stack[k], 0) for k in keys]
    for layer in zip(*per_leaf):
        x = apply_block(cfg, dict(zip(keys, layer)), x, positions,
                        causal=causal)
    return x


def _cdt(cfg):
    return getattr(torch, cfg.compute_dtype)


def embed_tokens(cfg, params, tokens, positions):
    x = params["embed"].to(_cdt(cfg))[tokens.long()]
    if cfg.pos_emb == "sinusoidal":
        x = x + md.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def forward(cfg: ModelConfig, params: Params, batch):
    """Training forward. Returns (logits fp32 (B, S, V_pad), aux loss)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    causal = cfg.arch_type != "encoder"
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = embed_tokens(cfg, params, tokens, positions)
    x = run_blocks(cfg, params["blocks"], x, positions, causal=causal)
    x = md.apply_norm(cfg, params, x, "final_norm_")
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def cross_entropy(logits, labels):
    """logits (B, S, V) fp32; labels (B, S), -1 = masked. Mean over valid
    positions; the logsumexp runs over the whole padded vocab."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask.to(logits.dtype)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(cfg: ModelConfig, params: Params, batch):
    logits, aux = forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"]) + aux
