"""Model assembly for the dense (gqa, swa and mla attention), encoder, MoE,
rwkv6 (ssm), hybrid (attention and Mamba heads side by side), audio
(enc-dec) and vlm families: parameter init, the training forward pass and
the loss (`repro/models/model.py`).

Param tree layout, the reference's key for key:
  {"embed": (V_pad, D), "lm_head": (D, V_pad),
   "final_norm_scale"/"final_norm_bias": (D,),
   "blocks": {leaf: (L, ...)},              # stacked, leading layer axis
   "dense_blocks": {leaf: (P, ...)},        # MoE: the P dense-prefix layers
   "enc_blocks": {leaf: (E, ...)},          # enc-dec: the E encoder layers
   "enc_norm_scale"/"enc_norm_bias": (D,)}  # enc-dec: the encoder's norm

An MoE model's main stack holds its num_layers - dense_prefix MoE layers;
the forward runs `dense_blocks` first. An enc-dec model's main stack is
its num_layers decoder blocks (self-attention, cross-attention to the
encoder's output, MLP); the forward runs the encoder stack over the stub
frames first. A vlm runs the main stack over [patches; text] and takes the
logits on the text tail.

`Model` is an nn.Module whose parameters are exactly these leaves, so the
arena layout built from `Model.tree()` is the reference's. The forward is a
plain function of the tree (`forward`, `loss_fn`), which lets the engines
take `torch.autograd.grad` with respect to the leaves.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _attn_params(cfg, gen, lead, cross=False):
    """The attention's leaves; `cross`: an enc-dec decoder's
    cross-attention, named wq_x, wk_x, wv_x and wo_x."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    if cfg.attention == "mla" and not cross:
        return _mla_params(cfg, gen, lead, out_scale)
    sfx = "_x" if cross else ""
    return {f"wq{sfx}": _dense(gen, lead + (d, h, hd)),
            f"wk{sfx}": _dense(gen, lead + (d, kv, hd)),
            f"wv{sfx}": _dense(gen, lead + (d, kv, hd)),
            f"wo{sfx}": _dense(gen, lead + (h, hd, d), out_scale)}


def _mla_params(cfg, gen, lead, out_scale):
    """The reference's mla leaves at tp = 1 (no padded heads): the kv
    down-projection to the latent and the shared rotary key, the latent's
    norm, its up-projection to k_nope and v, the output; the q
    down-projection, its norm and its up-projection when q_lora_rank is
    set, else one q projection."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.resolved_v_head_dim, cfg.kv_lora_rank
    ones = functools.partial(torch.ones, dtype=torch.float32,
                             device=gen.device)
    p = {"wkv_a": _dense(gen, lead + (d, r + dr)),
         "kv_norm": ones(lead + (r,)),
         "wkv_b": _dense(gen, lead + (r, h, dn + dv)),
         "wo": _dense(gen, lead + (h, dv, d), out_scale)}
    if cfg.q_lora_rank:
        p["wq_a"] = _dense(gen, lead + (d, cfg.q_lora_rank))
        p["q_norm"] = ones(lead + (cfg.q_lora_rank,))
        p["wq_b"] = _dense(gen, lead + (cfg.q_lora_rank, h, dn + dr))
    else:
        p["wq"] = _dense(gen, lead + (d, h, dn + dr))
    return p


def _mlp_params(cfg, gen, lead):
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    if cfg.act == "silu":
        return {"w_gate": _dense(gen, lead + (d, f)),
                "w_up": _dense(gen, lead + (d, f)),
                "w_down": _dense(gen, lead + (f, d), out_scale)}
    return {"w_up": _dense(gen, lead + (d, f)),
            "w_down": _dense(gen, lead + (f, d), out_scale)}


def _moe_params(cfg, gen, lead):
    """The router (D, E), the routed experts' gated FFN (E, D, F) / (E, F,
    D) and the shared experts' at width F x n_shared."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.n_experts, mc.d_expert
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"router": _dense(gen, lead + (d, e)),
         "w_gate_e": _dense(gen, lead + (e, d, f)),
         "w_up_e": _dense(gen, lead + (e, d, f)),
         "w_down_e": _dense(gen, lead + (e, f, d), out_scale)}
    if mc.n_shared:
        fs = f * mc.n_shared
        p["w_gate_s"] = _dense(gen, lead + (d, fs))
        p["w_up_s"] = _dense(gen, lead + (d, fs))
        p["w_down_s"] = _dense(gen, lead + (fs, d), out_scale)
    return p


def _mamba_params(cfg, gen, lead):
    """The Mamba heads' leaves: the in-projection to x and z (D, 2 d_inner),
    the depthwise conv (d_conv, d_inner) and its bias, the low-rank dt
    projection (rank D // 16) and its bias (softplus^-1(0.01)), the B and C
    projections (d_inner, N), A_log = log(1..N) for every channel, the skip
    D and the out-projection."""
    d, sc = cfg.d_model, cfg.ssm
    di, n = sc.expand * d, sc.d_state
    dt_rank = max(1, d // 16)
    dev = gen.device

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {"w_in": _dense(gen, lead + (d, 2 * di)),
            "conv_w": _dense(gen, lead + (sc.d_conv, di), 0.2),
            "conv_b": full((di,), 0.0),
            "w_dt_a": _dense(gen, lead + (di, dt_rank)),
            "w_dt_b": _dense(gen, lead + (dt_rank, di)),
            "dt_bias": full((di,), -4.6),
            "w_B": _dense(gen, lead + (di, n)),
            "w_C": _dense(gen, lead + (di, n)),
            "A_log": torch.log(a).expand(lead + (di, n)).clone(),
            "D_skip": full((di,), 1.0),
            "w_out": _dense(gen, lead + (di, d),
                            0.02 / math.sqrt(2 * cfg.num_layers))}


def _block_params(cfg, gen, n_layers, kind="dense"):
    """A dense, MoE, hybrid or enc-dec decoder ("dec") block's params for
    all layers at once (leading L axis); a hybrid block adds the Mamba
    heads' leaves and the two fuse norms to a dense one's, a decoder block
    the cross-attention's leaves and its norm."""
    lead = (n_layers,)
    p = {}
    for prefix in ("attn_norm_", "mlp_norm_"):
        for k, x in _norm_params(cfg, cfg.d_model, prefix, gen.device).items():
            p[k] = x.expand(lead + x.shape).clone()
    p.update(_attn_params(cfg, gen, lead))
    p.update(_moe_params(cfg, gen, lead) if kind == "moe"
             else _mlp_params(cfg, gen, lead))
    if kind == "hybrid":
        p.update(_mamba_params(cfg, gen, lead))
        for name in ("fuse_norm_a", "fuse_norm_m"):
            p[name] = torch.ones(lead + (cfg.d_model,), dtype=torch.float32,
                                 device=gen.device)
    if kind == "dec":
        p.update(_attn_params(cfg, gen, lead, cross=True))
        for k, x in _norm_params(cfg, cfg.d_model, "cross_norm_",
                                 gen.device).items():
            p[k] = x.expand(lead + x.shape).clone()
    return p


def _rwkv_block_params(cfg, gen, n_layers):
    """The RWKV-6 block's params for all layers at once (leading L axis)."""
    lead = (n_layers,)
    d, lora = cfg.d_model, 32
    dev = gen.device
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)

    def full(value):
        return torch.full(lead + (d,), value, dtype=torch.float32, device=dev)
    p = {f"mu_{nm}": full(0.5) for nm in ("r", "k", "v", "g", "w")}
    for nm in ("w_r", "w_k", "w_v", "w_g"):
        p[nm] = _dense(gen, lead + (d, d))
    p["w_o"] = _dense(gen, lead + (d, d), out_scale)
    p["w_dd_a"] = _dense(gen, lead + (d, lora))
    p["w_dd_b"] = _dense(gen, lead + (lora, d))
    # w_base such that decay exp(-exp(w_base)) spans (slow..fast) per channel
    p["w_base"] = torch.linspace(-6.0, 1.0, d, dtype=torch.float32,
                                 device=dev).expand(lead + (d,)).clone()
    p["u_bonus"] = _dense(gen, lead + (d,), 0.5)
    p["ln_x"] = full(1.0)
    p["mu_ck"] = full(0.5)
    p["mu_cr"] = full(0.5)
    p["w_ck"] = _dense(gen, lead + (d, cfg.d_ff))
    p["w_cv"] = _dense(gen, lead + (cfg.d_ff, d), out_scale)
    p["w_cr"] = _dense(gen, lead + (d, d))
    for prefix in ("att_norm_", "ffn_norm_"):
        for k, x in _norm_params(cfg, d, prefix, dev).items():
            p[k] = x.expand(lead + x.shape).clone()
    return p


def main_stack_kind(cfg) -> str:
    """The block kind of the main stack, as the reference names it."""
    return {"dense": "dense", "encoder": "dense", "vlm": "dense",
            "moe": "moe", "ssm": "rwkv", "hybrid": "hybrid",
            "audio": "dec"}[cfg.arch_type]


def n_main_layers(cfg) -> int:
    """The main stack's depth: an MoE model's first dense_prefix layers
    are the dense_blocks stack."""
    if cfg.moe is not None:
        return cfg.num_layers - cfg.moe.dense_prefix
    return cfg.num_layers


def stages(cfg, params):
    """The stacked regions of the plain layer loop in forward order, (name,
    block kind) each: an MoE model's dense_blocks, then the main stack (an
    enc-dec model's encoder and decoder stacks run through `forward`'s and
    Algorithm 2's own enc-dec forms)."""
    out = [("dense_blocks", "dense")] if "dense_blocks" in params else []
    return out + [("blocks", main_stack_kind(cfg))]


# the (arch_type, attention) pairs of the reference's configs
FAMILIES = {("dense", "gqa"), ("encoder", "gqa"), ("dense", "swa"),
            ("dense", "mla"), ("moe", "mla"), ("ssm", "none"),
            ("hybrid", "swa"), ("audio", "gqa"), ("vlm", "gqa")}


def _check_family(cfg: ModelConfig):
    if (cfg.arch_type, cfg.attention) not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} attention="
            f"{cfg.attention!r} is no family of the reference's configs; "
            f"this port runs {sorted(FAMILIES)}")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random params on `gen.device`, with the reference's shapes, scales and
    keys. The draws differ from jax.random's; tests that need the
    reference's numbers go through `params_from_jax`."""
    _check_family(cfg)
    vp = cfg.padded_vocab()
    params: Params = {"embed": _dense(gen, (vp, cfg.d_model)),
                      "lm_head": _dense(gen, (cfg.d_model, vp))}
    params.update(_norm_params(cfg, cfg.d_model, "final_norm_", gen.device))
    kind = main_stack_kind(cfg)
    if kind == "rwkv":
        params["blocks"] = _rwkv_block_params(cfg, gen, cfg.num_layers)
    else:
        params["blocks"] = _block_params(cfg, gen, n_main_layers(cfg), kind)
    if cfg.moe is not None and cfg.moe.dense_prefix:
        params["dense_blocks"] = _block_params(cfg, gen, cfg.moe.dense_prefix)
    if cfg.encoder_layers:
        params["enc_blocks"] = _block_params(cfg, gen, cfg.encoder_layers)
        params.update(_norm_params(cfg, cfg.d_model, "enc_norm_",
                                   gen.device))
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
    top-level leaves directly, each stacked region (`blocks`, an MoE
    model's `dense_blocks`, an enc-dec model's `enc_blocks`) in an
    nn.ParameterDict of that name."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        for k, x in params.items():
            if isinstance(x, dict):
                setattr(self, k, nn.ParameterDict(
                    {n: nn.Parameter(y) for n, y in x.items()}))
            else:
                self.register_parameter(k, nn.Parameter(x))

    def tree(self) -> Params:
        tree: Params = {k: p for k, p in self.named_parameters(recurse=False)}
        for k, stack in self.named_children():
            tree[k] = dict(stack.items())
        return tree

    def forward(self, batch):
        return forward(self.cfg, self.tree(), batch)


# ---------------------------------------------------------------------------
# Forward + loss
# ---------------------------------------------------------------------------


def apply_block(cfg, p, x, positions, *, kind, causal=True, enc_kv=None):
    """One block on (B, S, D), of `kind`: a dense transformer block, an MoE
    one (its FFN routed, `moe_ffn`), a hybrid one (attention and the Mamba
    heads on the same normed input, each output rms-normed, their mean
    added), an enc-dec decoder one ("dec": cross-attention to `enc_kv`, the
    encoder's keys and values, between the self-attention and the MLP), or
    an RWKV-6 block (time-mix, then channel-mix, each from a zero
    token-shift carry and, for the time-mix, a zero fp32 state). Returns
    (x, aux loss): the MoE FFN's load-balance loss, a zero fp32 scalar for
    the other kinds."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        b, _, d = x.shape
        hd = cfg.ssm.head_dim
        zeros_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        st = torch.zeros((b, d // hd, hd, hd), dtype=torch.float32,
                         device=x.device)
        a_in = md.apply_norm(cfg, p, x, "att_norm_")
        y, _, _ = md.rwkv6_timemix(cfg, p, a_in, zeros_x, st)
        x = x + y
        c_in = md.apply_norm(cfg, p, x, "ffn_norm_")
        y, _ = md.rwkv6_channelmix(p, c_in, zeros_x)
        return x + y, aux
    a_in = md.apply_norm(cfg, p, x, "attn_norm_")
    attn = md.mla_attention if cfg.attention == "mla" else md.gqa_attention
    attn = attn(cfg, p, a_in, positions, causal=causal)
    if kind == "hybrid":
        mam, _, _ = md.mamba_mix(cfg, p, a_in)
        attn = 0.5 * (md.rmsnorm(attn, p["fuse_norm_a"]) +
                      md.rmsnorm(mam, p["fuse_norm_m"]))
    x = x + attn
    if kind == "dec":
        c_in = md.apply_norm(cfg, p, x, "cross_norm_")
        x = x + md.cross_attention(cfg, p, c_in, enc_kv, positions)
    m_in = md.apply_norm(cfg, p, x, "mlp_norm_")
    if kind == "moe":
        y, aux = md.moe_ffn(cfg, p, m_in)
    else:
        y = md.mlp(cfg, p, m_in)
    return x + y, aux


def dec_block(cfg, p, x, enc_out, positions):
    """An enc-dec decoder layer: its cross keys and values projected from
    the encoder's output, then the block (the reference's `_scan_dec`
    body)."""
    return apply_block(cfg, p, x, positions, kind="dec", causal=True,
                       enc_kv=md.encode_cross_kv(p, enc_out))


def run_blocks(cfg, stack, x, positions, *, kind, causal=True, remat=False,
               enc_out=None):
    """The layer loop over a stacked subtree of blocks of `kind` (the
    reference scans it). Returns (x, the layers' aux losses summed in
    layer order from zero). `unbind` splits each stacked leaf once, so the
    backward writes each leaf's gradient as one stacked tensor. Decoder
    blocks ("dec") take the encoder's output `enc_out` and project their
    cross keys and values inside the layer (`dec_block`).

    With `remat`, each layer runs under non-reentrant
    torch.utils.checkpoint (the reference's `jax.checkpoint` of the scan
    body): the forward keeps only the layer's input, and the backward
    recomputes the layer, saving what its own backward reads (for rwkv6,
    the scan's chunk states come from that recompute). The layer's param
    views are explicit inputs, so their gradients still reach the stacked
    leaves. The non-reentrant form is the one `torch.autograd.grad`, which
    every engine calls, supports."""
    keys = sorted(stack)
    per_leaf = [torch.unbind(stack[k], 0) for k in keys]

    def block(h, eo, *layer):
        p = dict(zip(keys, layer))
        if kind == "dec":
            return dec_block(cfg, p, h, eo, positions)
        return apply_block(cfg, p, h, positions, kind=kind, causal=causal)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in zip(*per_leaf):
        if remat:
            x, a = checkpoint(block, x, enc_out, *layer, use_reentrant=False)
        else:
            x, a = block(x, enc_out, *layer)
        aux = aux + a
    return x, aux


def _cdt(cfg):
    return getattr(torch, cfg.compute_dtype)


def embed_tokens(cfg, params, tokens, positions):
    x = params["embed"].to(_cdt(cfg))[tokens.long()]
    if cfg.pos_emb == "sinusoidal":
        x = x + md.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def _positions(n, b, device):
    return torch.arange(n, dtype=torch.int32, device=device).expand(b, n)


def encode(cfg, params, frames, *, remat=False):
    """An enc-dec model's encoder: the stub frames (in the compute dtype)
    plus sinusoidal positions 0..Se-1, the encoder stack (dense blocks,
    non-causal; rope on top of the sinusoids, as every gqa block applies
    it), the encoder's norm. Returns (enc_out, the stack's aux loss)."""
    frames = frames.to(_cdt(cfg))
    b, se = frames.shape[:2]
    epos = _positions(se, b, frames.device)
    e = frames + md.sinusoidal_positions(epos, cfg.d_model).to(frames.dtype)
    e, aux = run_blocks(cfg, params["enc_blocks"], e, epos, kind="dense",
                        causal=False, remat=remat)
    return md.apply_norm(cfg, params, e, "enc_norm_"), aux


def vlm_input(cfg, params, tokens, patches):
    """A vlm's input: the stub patches (in the compute dtype) before the
    text's embedding, and positions 0..P+S-1 over both. Returns (x,
    positions)."""
    patches = patches.to(_cdt(cfg))
    b, s = tokens.shape
    p = patches.shape[1]
    positions = _positions(p + s, b, tokens.device)
    xt = embed_tokens(cfg, params, tokens, positions[:, p:])
    return torch.cat([patches, xt], dim=1), positions


def forward(cfg: ModelConfig, params: Params, batch, *, remat: bool = False):
    """Training forward. Returns (logits fp32 (B, S, V_pad), aux loss: the
    stages' aux losses summed from zero in forward order). `remat`
    checkpoints each layer (`run_blocks`), an enc-dec decoder layer's
    cross keys and values included. An enc-dec model runs the encoder
    first; a vlm takes the logits on the text tail."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    causal = cfg.arch_type != "encoder"
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    enc_out = None
    if cfg.arch_type == "audio":
        enc_out, a = encode(cfg, params, batch["frames"], remat=remat)
        aux = aux + a
    if cfg.arch_type == "vlm":
        x, positions = vlm_input(cfg, params, tokens, batch["patches"])
    else:
        positions = _positions(s, b, tokens.device)
        x = embed_tokens(cfg, params, tokens, positions)
    for name, kind in stages(cfg, params):
        x, a = run_blocks(cfg, params[name], x, positions, kind=kind,
                          causal=causal, remat=remat, enc_out=enc_out)
        aux = aux + a
    if cfg.arch_type == "vlm":
        x = x[:, -s:]                                   # the text tail
    x = md.apply_norm(cfg, params, x, "final_norm_")
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return logits, aux


def cross_entropy(logits, labels):
    """logits (B, S, V) fp32; labels (B, S), -1 = masked. Mean over valid
    positions; the logsumexp runs over the whole padded vocab."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask.to(logits.dtype)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(cfg: ModelConfig, params: Params, batch, *, remat: bool = False):
    logits, aux = forward(cfg, params, batch, remat=remat)
    return cross_entropy(logits, batch["labels"]) + aux
