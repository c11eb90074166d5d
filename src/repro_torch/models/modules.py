"""Model building blocks (dense, encoder and rwkv6 families; the dense
decoder's gqa, sliding-window (swa) and multi-head latent (mla) attention),
plain functions on tensors with the reference's layouts and operation order
(`repro/models/modules.py`).

Params are dicts of tensors. Attention is the blockwise online-softmax
formulation over 1024-key blocks in plain torch (einsum), as the reference
leaves it to XLA; it never calls a fused attention operator. The RWKV-6
time-mix runs its chunked recurrence through the scan kernel
(`kernels/rwkv6_chunk.py`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_chunk import rwkv6_chunk_scan

NORM_EPS = 1e-6
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps=NORM_EPS):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dtype)


def layernorm(x, w, b, eps=NORM_EPS):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dtype)


def apply_norm(cfg, p, x, prefix=""):
    if cfg.norm == "layernorm":
        return layernorm(x, p[prefix + "scale"], p[prefix + "bias"])
    return rmsnorm(x, p[prefix + "scale"])


def _gelu_tanh(x):
    # the reference's jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].float() * freqs             # (..., S, hd/2)
    if x.dim() == ang.dim() + 1:                           # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d_model):
    """Sinusoidal absolute embeddings, computed on the fly."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Blockwise attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal, q_positions, kv_positions,
                        window=None, kv_block=1024):
    """Online-softmax attention; never materializes (Sq, Sk) for large Sk.

    q: (B, Hq, Sq, hd); k: (B, Hkv, Sk, hd); v: (B, Hkv, Sk, hv)
    q_positions: (B, Sq); kv_positions: (B, Sk); window: a sliding window
    (a query sees keys at positions > its own - window), None = full.
    Returns (B, Hq, Sq, hv). A kv block that a query sees none of (past its
    causal edge, or wholly before its window) adds nothing to its row.
    """
    b, hq, sq, hd = q.shape
    _, hkv, sk, hv = v.shape
    scale = 1.0 / math.sqrt(hd)
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    # eager PyTorch keeps every masked score for the backward, so a sequence
    # shorter than one block gets a block of its own length instead of
    # being padded to kv_block keys (padded keys add exact zeros either way)
    kv_block = min(kv_block, sk)
    nblk = max(1, -(-sk // kv_block))
    pad = nblk * kv_block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=_INT32_MAX)
    qf = q.float()
    m = torch.full((b, hq, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, hv), dtype=torch.float32, device=q.device)
    for j in range(nblk):
        sl = slice(j * kv_block, (j + 1) * kv_block)
        kc, vc, pc = k[:, :, sl], v[:, :, sl], kv_positions[:, sl]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float()) * scale
        valid = (pc[:, None, :] < _INT32_MAX).expand(b, sq, pc.shape[1])
        if causal:
            valid = valid & (pc[:, None, :] <= q_positions[:, :, None])
        if window is not None:
            valid = valid & (pc[:, None, :] > q_positions[:, :, None] - window)
        mask = valid[:, None]                               # (B,1,Sq,kb)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(torch.where(torch.isinf(m), 0.0, m) - m_safe)
        corr = torch.where(torch.isinf(m), 0.0, corr)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkv->bhqv", p,
                                                   vc.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention sublayer (train / prefill path)
# ---------------------------------------------------------------------------


def gqa_attention(cfg, p, x, positions, *, causal=True):
    """p: wq (D,Hq,hd), wk/wv (D,Hkv,hd), wo (Hq,hd,D). RoPE is applied to
    q and k for every config (bert adds sinusoidal embeddings as well); an
    swa config attends within its window."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(x.dtype))
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    window = cfg.window if cfg.attention == "swa" else None
    out = blockwise_attention(q, k, v, causal=causal, q_positions=positions,
                              kv_positions=positions, window=window)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3): low-rank q, a compressed kv latent, a shared
# rotary key
# ---------------------------------------------------------------------------


def mla_project_q(cfg, p, x):
    """Returns q_nope (B,H,S,dn), q_rope (B,H,S,dr)."""
    if cfg.q_lora_rank:
        ql = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"])
        q = torch.einsum("bsr,rhk->bhsk", ql, p["wq_b"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(x.dtype))
    dn = cfg.qk_nope_head_dim
    return q[..., :dn], q[..., dn:]


def mla_latent(cfg, p, x):
    """Compressed kv: (latent (B,S,R) rms-normed, k_rope (B,S,dr))."""
    kv = x @ p["wkv_a"].to(x.dtype)                        # (B,S,R+dr)
    r = cfg.kv_lora_rank
    return rmsnorm(kv[..., :r], p["kv_norm"]), kv[..., r:]


def mla_expand_kv(cfg, p, latent):
    """latent (B,S,R) -> k_nope (B,H,S,dn), v (B,H,S,dv)."""
    kv = torch.einsum("bsr,rhk->bhsk", latent, p["wkv_b"].to(latent.dtype))
    dn = cfg.qk_nope_head_dim
    return kv[..., :dn], kv[..., dn:]


def mla_attention(cfg, p, x, positions, *, causal=True):
    """q and k of head size dn + dr (the rotary part of k one (B,S,dr)
    tensor shared by every head), v of dv: the softmax scale is
    1/sqrt(dn + dr)."""
    q_nope, q_rope = mla_project_q(cfg, p, x)
    latent, k_rope = mla_latent(cfg, p, x)
    q_rope = apply_rope(q_rope.transpose(1, 2), positions,
                        cfg.rope_theta).transpose(1, 2)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k_nope, v = mla_expand_kv(cfg, p, latent)
    h = q_nope.shape[1]
    k_rope_h = k_rope[:, None].expand(k_rope.shape[0], h, *k_rope.shape[1:])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = blockwise_attention(q, k, v, causal=causal, q_positions=positions,
                              kv_positions=positions)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp(cfg, p, x):
    a = act_fn(cfg.act)
    if "w_gate" in p:                                       # gated (silu) FFN
        h = a(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:                                                   # plain (gelu) FFN
        h = a(x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear recurrence, chunk-parallel
# ---------------------------------------------------------------------------


def _token_shift(x, prev):
    """Shift sequence right by one; prev: (B,D) last token of previous call."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def rwkv6_decay(p, x):
    """Data-dependent decay (Finch's signature): w = exp(-exp(w0 + lora(x))).
    Returns the log-decay, fp32, <= 0."""
    lo = torch.tanh(x @ p["w_dd_a"].to(x.dtype)) @ p["w_dd_b"].to(x.dtype)
    return -torch.exp(torch.clamp(p["w_base"].float() + lo.float(), -20.0,
                                  8.0))


def rwkv6_timemix(cfg, p, x, prev_x, state, *, chunk=64):
    """Chunked RWKV-6 time-mix.

    x: (B,S,D); prev_x: (B,D) token-shift carry; state: (B,H,K,V) wkv state.
    Returns (y, new_prev_x, new_state). The recurrence runs over (B*H, S, 64)
    fp32 operands in the scan kernel, S padded to a chunk multiple."""
    b, s, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    xs = _token_shift(x, prev_x)

    def mix(name):
        mu = p[f"mu_{name}"].to(x.dtype)
        return x + (xs - x) * mu
    r = (mix("r") @ p["w_r"].to(x.dtype)).reshape(b, s, h, hd)
    kk = (mix("k") @ p["w_k"].to(x.dtype)).reshape(b, s, h, hd)
    v = (mix("v") @ p["w_v"].to(x.dtype)).reshape(b, s, h, hd)
    g = F.silu(mix("g") @ p["w_g"].to(x.dtype))
    logw = rwkv6_decay(p, mix("w")).reshape(b, s, h, hd)   # (B,S,H,K) fp32
    u = p["u_bonus"].float().reshape(h, hd)

    nc = -(-s // chunk)
    sp = nc * chunk

    def heads(a):                        # (B,S,H,hd) -> (B*H, Sp, hd) fp32
        a = F.pad(a.float(), (0, 0, 0, 0, 0, sp - s))
        return a.permute(0, 2, 1, 3).reshape(b * h, sp, hd).contiguous()
    y, new_state = rwkv6_chunk_scan(
        heads(r), heads(kk), heads(v), heads(logw),
        u.expand(b, h, hd).reshape(b * h, hd),
        state.float().reshape(b * h, hd, hd).contiguous(), chunk=chunk)
    y = y.reshape(b, h, sp, hd).permute(0, 2, 1, 3)[:, :s]
    y = y.reshape(b, s, d).to(x.dtype)
    y = rmsnorm(y.reshape(b, s, h, hd), p["ln_x"].reshape(h, hd)).reshape(
        b, s, d)
    y = (y * g) @ p["w_o"].to(x.dtype)
    return y, x[:, -1], new_state.reshape(b, h, hd, hd).to(state.dtype)


def rwkv6_channelmix(p, x, prev_x):
    xs = _token_shift(x, prev_x)
    mu_k = p["mu_ck"].to(x.dtype)
    mu_r = p["mu_cr"].to(x.dtype)
    xk = x + (xs - x) * mu_k
    xr = x + (xs - x) * mu_r
    k = torch.square(F.relu(xk @ p["w_ck"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["w_cr"].to(x.dtype))
    return r * (k @ p["w_cv"].to(x.dtype)), x[:, -1]
