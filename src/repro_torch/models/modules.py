"""Model building blocks (dense, encoder, MoE, rwkv6, hybrid, enc-dec and
vlm families; the dense decoder's gqa, sliding-window (swa) and multi-head
latent (mla) attention; the enc-dec decoder's cross-attention; the routed
experts' FFN, `moe_ffn`; the hybrid block's Mamba heads, `mamba_mix`),
plain functions on tensors with the reference's
layouts and operation order (`repro/models/modules.py`).

Params are dicts of tensors. Attention is the blockwise online-softmax
formulation over 1024-key blocks in plain torch (einsum), as the reference
leaves it to XLA; it never calls a fused attention operator. The RWKV-6
time-mix runs its chunked recurrence through the scan kernel
(`kernels/rwkv6_chunk.py`). The Mamba heads' selective scan is plain torch,
as the reference's is jnp (`lax.associative_scan`, no Pallas kernel).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.adama_accum import _fma32
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
    """1 / theta ** (2i / head_dim) in float32, as XLA computes the
    reference's: the exponent in float32, the power formed in float64 and
    rounded once (XLA's float32 pow is the correctly rounded one; torch's
    float32 pow is not, on the CPU or the card), the reciprocal in
    float32."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    # theta as the reference's float32 holds it, a host scalar (a device
    # tensor made from it would wait for the card)
    return 1.0 / torch.pow(float(np.float32(theta)), e.double()).float()


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


def cross_attention(cfg, p, x, enc_kv, positions):
    """The enc-dec decoder's cross-attention: queries from x through wq_x,
    keys and values the encoder's (`encode_cross_kv`), at positions
    0..Se-1, non-causal, no rope on either side. enc_kv = (k, v), each
    (B, Hkv, Se, hd); at Se = 1500 the 1024-key blocks pad 548 keys, which
    add exact zeros."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq_x"].to(x.dtype))
    k, v = enc_kv
    se = k.shape[2]
    kv_pos = torch.arange(se, dtype=torch.int32,
                          device=x.device).expand(x.shape[0], se)
    out = blockwise_attention(q, k, v, causal=False, q_positions=positions,
                              kv_positions=kv_pos)
    return torch.einsum("bhsk,hkd->bsd", out, p["wo_x"].to(x.dtype))


def encode_cross_kv(p, enc_out):
    """A decoder layer's cross keys and values from the encoder's output,
    (B, Hkv, Se, hd) each."""
    k = torch.einsum("bsd,dhk->bhsk", enc_out, p["wk_x"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bhsk", enc_out, p["wv_x"].to(enc_out.dtype))
    return k, v


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
# MoE (sort-based per-row routing into capacity buffers)
# ---------------------------------------------------------------------------
#
# The reference dispatches with a gather `x_row[tok]` and combines with a
# scatter-add over slots; both repeat indices (a token has up to k slots),
# and a CUDA scatter-add, or the backward of a CUDA gather, sums repeated
# indices in atomic order. Here every sum over a token's slots goes through
# the (token, j) -> slot map, its k slots in ascending order (the order in
# which the reference's scatter meets them), one add at a time: the
# combine's forward and the dispatch's backward. Scatters whose indices
# repeat only at the discarded sink slot stay plain torch ops.


def _route(ids, gates, n_experts, capacity):
    """The slot maps of rows of top-k expert ids (B, S, k): copy f = t*k + j
    of token t goes to expert ids[t, j] at its rank among that expert's
    copies in a stable sort; copies at or past `capacity` are dropped.
    Returns (tok_slot (B, E*C) int64, filled (B, E*C) bool, gate_slot (B,
    E*C), token_slots (B, S, k) int64): empty slots hold token 0 and gate
    0; token_slots lists each token's slots in ascending order, a dropped
    copy as E*C (the sink) after them."""
    b, s, k = ids.shape
    dev = ids.device
    n_slots = n_experts * capacity
    sorted_ids, order = torch.sort(ids.reshape(b, s * k).long(), dim=-1,
                                   stable=True)
    experts = torch.arange(n_experts, device=dev).expand(b, n_experts)
    starts = torch.searchsorted(sorted_ids, experts.contiguous(),
                                side="left")
    pos = torch.arange(s * k, device=dev) - starts.gather(1, sorted_ids)
    dst = torch.where(pos < capacity, sorted_ids * capacity + pos, n_slots)
    tok = order // k
    # one column past the slots takes every dropped copy and is cut off
    sink = functools.partial(torch.zeros, (b, n_slots + 1), device=dev)
    tok_slot = sink(dtype=torch.int64).scatter(1, dst, tok)[:, :n_slots]
    filled = sink(dtype=torch.bool).scatter(
        1, dst, torch.ones_like(dst, dtype=torch.bool))[:, :n_slots]
    dst_of_copy = torch.empty_like(dst).scatter_(1, order, dst)
    gate_slot = sink(dtype=gates.dtype).scatter(
        1, dst_of_copy, gates.reshape(b, s * k))[:, :n_slots]
    token_slots = torch.sort(dst_of_copy.reshape(b, s, k), dim=-1).values
    return tok_slot, filled, gate_slot, token_slots


def _gather_rows(src, idx):
    """src (B, N, D), idx (B, M) -> src[b, idx[b, m]] (B, M, D)."""
    return src.gather(1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _sum_slots(src, token_slots):
    """out[b, t] = the sum of src[b, slot] over token t's slots, in
    ascending slot order, one add at a time (the sink adds a zero row)."""
    pad = torch.cat([src, src.new_zeros((src.shape[0], 1, src.shape[2]))],
                    dim=1)
    out = _gather_rows(pad, token_slots[..., 0])
    for j in range(1, token_slots.shape[-1]):
        out = out + _gather_rows(pad, token_slots[..., j])
    return out


class _Dispatch(torch.autograd.Function):
    """buf[slot] = x[token of slot] (zero for an empty slot); the backward
    sums each token's slots in ascending order."""

    @staticmethod
    def forward(ctx, x, tok_slot, filled, token_slots):
        ctx.save_for_backward(token_slots)
        return torch.where(filled[..., None], _gather_rows(x, tok_slot),
                           x.new_zeros(()))

    @staticmethod
    def backward(ctx, dbuf):
        (token_slots,) = ctx.saved_tensors
        return _sum_slots(dbuf, token_slots), None, None, None


class _Combine(torch.autograd.Function):
    """y[token] = the sum of its slots' contributions in ascending slot
    order; the backward gives each filled slot its token's gradient."""

    @staticmethod
    def forward(ctx, contrib, tok_slot, filled, token_slots):
        ctx.save_for_backward(tok_slot, filled)
        return _sum_slots(contrib, token_slots)

    @staticmethod
    def backward(ctx, dy):
        tok_slot, filled = ctx.saved_tensors
        return (torch.where(filled[..., None], _gather_rows(dy, tok_slot),
                            dy.new_zeros(())), None, None, None)


def route_row(ids, gates, x_row, n_experts, capacity):
    """The reference's `_route_row`: ids, gates (S, k) and x_row (S, D) of
    one row, or (B, S, k) and (B, S, D) of B rows. Returns (buf (E*C, D),
    tok_slot (E*C,), gate_slot (E*C,)), with a leading B for B rows: the
    copies in their expert's capacity slots, and each slot's token and gate
    (empty slots: token 0, gate 0). Differentiable in x_row and gates."""
    one = ids.dim() == 2
    if one:
        ids, gates, x_row = ids[None], gates[None], x_row[None]
    tok_slot, filled, gate_slot, token_slots = _route(ids, gates, n_experts,
                                                      capacity)
    buf = _Dispatch.apply(x_row, tok_slot, filled, token_slots)
    out = (buf, tok_slot, gate_slot)
    return tuple(t[0] for t in out) if one else out


def moe_top_k(probs, k):
    """(gates, ids) of the k largest probs, ties to the lower expert index
    as `lax.top_k` breaks them (a stable descending sort)."""
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    ids = ids[..., :k]
    return probs.gather(-1, ids), ids


def moe_capacity(mc, s):
    """Slots per expert and row of S tokens: max(k, ceil(S k cf / E))."""
    return int(max(mc.top_k, math.ceil(s * mc.top_k * mc.capacity_factor
                                       / mc.n_experts)))


def moe_ffn(cfg, p, x):
    """x: (B, S, D). Router top-k -> per-row capacity buffers -> the
    experts' batched matmuls -> the gate-weighted combine; the shared
    experts run densely. Returns (y, aux_loss)."""
    mc = cfg.moe
    b, s, d = x.shape
    e, k = mc.n_experts, mc.top_k
    capacity = moe_capacity(mc, s)

    logits = (x @ p["router"].to(x.dtype)).float()              # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = moe_top_k(probs, k)                            # (B, S, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style)
    me = torch.mean(probs, dim=(0, 1))                          # (E,)
    ce = torch.mean(F.one_hot(ids[..., 0], e).float(), dim=(0, 1))
    aux = e * torch.sum(me * ce) * mc.router_aux_weight

    tok_slot, filled, gate_slot, token_slots = _route(ids, gates, e,
                                                      capacity)
    buf = _Dispatch.apply(x, tok_slot, filled, token_slots)
    buf = buf.reshape(b, e, capacity, d)
    h = torch.einsum("becd,edf->becf", buf, p["w_gate_e"].to(x.dtype))
    h = act_fn(cfg.act)(h) * torch.einsum("becd,edf->becf", buf,
                                          p["w_up_e"].to(x.dtype))
    yb = torch.einsum("becf,efd->becd", h, p["w_down_e"].to(x.dtype))
    yb = yb.reshape(b, e * capacity, d)
    contrib = yb * gate_slot[..., None].to(yb.dtype)
    y = _Combine.apply(contrib, tok_slot, filled, token_slots)

    if mc.n_shared:
        sh = act_fn(cfg.act)(x @ p["w_gate_s"].to(x.dtype)) * \
            (x @ p["w_up_s"].to(x.dtype))
        y = y + sh @ p["w_down_s"].to(x.dtype)
    return y, aux


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


# ---------------------------------------------------------------------------
# Mamba / S6 selective SSM (the hybrid block's SSM heads), training form
# ---------------------------------------------------------------------------

SERVING = ("ROADMAP queue 1, item 11 (serving): the decode form with conv "
           "and ssm states")


class _Fma(torch.autograd.Function):
    """a * b + c in one rounding, as XLA CPU contracts it: fp32 on the CPU
    formed exactly (`_fma32`); on CUDA (nvcc contracts it) and in other
    dtypes `addcmul`."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        if c.is_cuda or c.dtype != torch.float32:
            return torch.addcmul(c, a, b)
        return _fma32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def _causal_conv(x, w):
    """Depthwise causal conv over time. x: (B, S, C), w: (K, C). Returns
    (out (B, S, C), the last K - 1 inputs (B, K - 1, C)): x padded with K -
    1 zero steps on the left, out = the sum over i of xp[:, i:i+S] * w[i],
    the reference's terms in its order, contracted as XLA CPU contracts
    them: fma(xp_0, w_0, xp_1 w_1), then fma(xp_i, w_i, acc) for i >= 2
    (K >= 2)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))

    def term(i):
        return xp[:, i:i + s], w[i].to(x.dtype).expand(x.shape)
    out = _Fma.apply(*term(0), torch.mul(*term(1)))
    for i in range(2, k):
        out = _Fma.apply(*term(i), out)
    return out, xp[:, -(k - 1):]


def _take(x, dim, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along dim; a is as long as b or one
    longer."""
    m = b.shape[dim]
    out = torch.stack([_take(a, dim, 0, m), b], dim + 1).flatten(dim, dim + 1)
    return torch.cat([out, _take(a, dim, m)], dim) if a.shape[dim] > m \
        else out


def associative_scan(fn, elems, dim):
    """Inclusive scan of the list of tensors `elems` along `dim` under the
    associative `fn(earlier, later)` (each a list like `elems`), by the
    odd/even recursion `lax.associative_scan` runs, so every element comes
    out of the same tree of combinations: combine adjacent pairs, scan those
    recursively (the odd outputs), combine each with the next even input
    (the even outputs), put the first input in front and interleave. The
    levels hold about twice the input's size in all."""
    elems = list(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn([_take(e, dim, 0, -1, 2) for e in elems],
                                  [_take(e, dim, 1, None, 2) for e in elems]),
                           dim)
    nxt = [_take(e, dim, 2, None, 2) for e in elems]
    even = fn([_take(e, dim, 0, -1) for e in odd] if n % 2 == 0 else odd, nxt)
    even = [torch.cat([_take(e, dim, 0, 1), r], dim)
            for e, r in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


def ssm_combine(e1, e2):
    """The linear recurrence's combine, (a1, b1) then (a2, b2): (a1 a2,
    a2 b1 + b2)."""
    (a1, b1), (a2, b2) = e1, e2
    return [a1 * a2, _Fma.apply(a2, b1, b2)]


def mamba_mix(cfg, p, x, conv_state=None, ssm_state=None):
    """Selective SSM, training form. x: (B, S, D). Returns (y, conv_state,
    ssm_state): the last d_conv - 1 conv inputs and the fp32 state after
    the last step. Products run in x's dtype; the discretization (abar =
    exp(dt a), dt B x) and the scan h_t = abar_t h_{t-1} + (dt B x)_t run
    in fp32 over (B, S, d_inner, d_state), the scan from a zero state."""
    b, s, d = x.shape
    if conv_state is not None or ssm_state is not None or s == 1:
        raise NotImplementedError(f"mamba_mix: {SERVING}")
    di = cfg.ssm.expand * d
    dt = x.dtype
    xz = x @ p["w_in"].to(dt)                               # (B,S,2*di)
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = _causal_conv(xi, p["conv_w"])
    xi = F.silu(xi + p["conv_b"].to(dt))
    # jax.nn.softplus is logaddexp(x, 0)
    delta = torch.logaddexp((xi @ p["w_dt_a"].to(dt)) @ p["w_dt_b"].to(dt)
                            + p["dt_bias"].to(dt), x.new_zeros(()))
    bmat = xi @ p["w_B"].to(dt)                             # (B,S,N)
    cmat = xi @ p["w_C"].to(dt)                             # (B,S,N)
    a = -torch.exp(p["A_log"].float())                      # (di,N)
    dt32 = delta.float()
    abar = torch.exp(dt32[..., None] * a)                   # (B,S,di,N)
    bx = dt32[..., None] * bmat[:, :, None, :].float() * \
        xi[..., None].float()                               # (B,S,di,N)
    a_in = torch.cat([abar.new_ones((b, 1) + abar.shape[2:]), abar], 1)
    b_in = torch.cat([bx.new_zeros((b, 1) + bx.shape[2:]), bx], 1)
    _, hh = associative_scan(ssm_combine, (a_in, b_in), 1)
    h = hh[:, 1:]
    y = torch.einsum("bsdn,bsn->bsd", h, cmat.float())
    y = y.to(dt) + xi * p["D_skip"].to(dt)
    y = y * F.silu(z)
    return y @ p["w_out"].to(dt), conv_state, h[:, -1]
