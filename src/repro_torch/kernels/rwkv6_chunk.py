"""RWKV-6 chunked linear recurrence: the time-mix scan of the rwkv6 family,
forward and backward.

  rwkv6_chunk_scan        the differentiable op. On CUDA tensors it runs
                          the hand-written forward kernels in
                          csrc/rwkv6_chunk.cu under a torch.autograd.Function
                          whose backward is the hand-written backward kernels
                          (or raises); on CPU tensors it runs the plain
                          forward, which autograd differentiates.
  scan_forward            the forward's launcher: a state pass writes the
                          state at the start of every chunk (what the
                          backward reads, returned on request), then an
                          output pass computes y from it, every chunk at
                          once. One call counts one into
                          `rwkv6_chunk_scan.launches`.
  rwkv6_chunk_scan_bwd    the backward's launcher: a reverse state pass
                          writes the gradient of the state after every chunk,
                          then a gradient pass computes every chunk's
                          gradients from it and the forward's states, all
                          chunks at once, and a reduction sums du's per-chunk
                          partials. One call counts one into
                          `rwkv6_chunk_scan_bwd.launches`.
  rwkv6_chunk_scan_ref    the plain forward: the reference model's chunk
                          body (`repro/models/modules.py::rwkv6_timemix`),
                          batched over BH.
  rwkv6_chunk_scan_bwd_ref  the plain backward: torch.autograd.grad
                          through the plain forward.

They replace the Pallas kernel `repro/kernels/rwkv6_chunk.py::
rwkv6_chunk_scan` (fp32 throughout). The reference has no backward kernel:
XLA differentiates the model's jnp scan.

Per head and chunk of C tokens, with cw the inclusive and cx the exclusive
cumsum of logw over the chunk and T = cw[C-1]:

    y[t]  = (r[t] e^{cx[t]}) S + sum_{i<t} A[t,i] v[i] + (r[t].u.k[t]) v[t]
    A[t,i] = sum_k r[t,k] k[i,k] e^{cx[t,k] - cw[i,k]}        (exponent <= 0)
    S'    = diag(e^T) S + sum_i (k[i] e^{T - cw[i]})^T v[i]

logw reaches -e^8 per token in the model, so e^{-cw} overflows within one
chunk: every exponential is taken of a difference that is <= 0, never split
into a product of e^{cx} and e^{-cw}. The backward cannot rebuild S from S'
by dividing by e^T for the same reason; it reads the chunk-start states the
forward wrote.

The backward's only sequential part is dS, the gradient of the state at each
chunk boundary: dS_c = diag(e^T) dS_{c+1} + (r e^{cx})^T dy_c from
dS_n = ds_final, the forward's state recurrence with r e^{cx} for
k e^{T-cw} and dy for v, over the chunks in reverse (the same kernel). Given
S_c and dS_{c+1}, each chunk's gradients depend on that chunk alone.

The forward's output pass factors the decays between 16-token sub-chunks
at the later sub-chunk's start b: e^{cx[t]-cw[i]} = e^{cx[t]-b} e^{b-cw[i]},
both exponents <= 0, so that those blocks of A are matrix products; only
the pairs within a sub-chunk take the pairwise form.

The kernels sum in another order than the plain versions, so they agree to
a tolerance, not bit for bit (stated where they are compared).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK = 64
# the kernels size their shared-memory tiles and fragment arrays for chunk,
# K and V up to this
MAX_DIM = 64
# the CUDA forward's sub-chunk and tensor-core tile side: on the card,
# chunk, K and V are multiples of it
SUB = 16

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C signatures of the launchers in csrc/rwkv6_chunk.cu (the trailing
# pointer is the CUDA stream)
SIGNATURES = {
    # r, k, v, logw, u, s0, y, s_out, states, bh, s, chunk, K, V
    "rwkv6_fwd_launch": (_P,) * 9 + (_I64, _I64, _I, _I, _I, _P),
    # r, k, v, logw, u, states, dy, ds_final, dr, dk, dv, dlogw, du, ds0,
    # dstates, du_part (scratch), bh, s, chunk, K, V
    "rwkv6_bwd_launch": (_P,) * 16 + (_I64, _I64, _I, _I, _I, _P),
}


def check_inputs(fn, r, k, v, logw, u, s0, chunk):
    """r, k, logw (BH, S, K); v (BH, S, V); u (BH, K); s0 (BH, K, V); all
    fp32, contiguous, on one device (CPU or CUDA); S a multiple of chunk.
    Returns (bh, s, kdim, vdim)."""
    ts = (r, k, v, logw, u, s0)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: expected float32 operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
        if t.device != r.device:
            raise ValueError(f"{fn}: operands on {t.device} and {r.device}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {r.device}")
    if r.dim() != 3:
        raise ValueError(f"{fn}: r must be (BH, S, K), got {tuple(r.shape)}")
    bh, s, kdim = r.shape
    vdim = v.shape[-1]
    want = {"k": (bh, s, kdim), "v": (bh, s, vdim), "logw": (bh, s, kdim),
            "u": (bh, kdim), "s0": (bh, kdim, vdim)}
    for name, t in zip(("k", "v", "logw", "u", "s0"), ts[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"{fn}: sequence length {s} is not a multiple of "
                         f"the chunk {chunk}")
    if r.is_cuda:
        if max(chunk, kdim, vdim) > MAX_DIM or chunk % SUB or kdim % SUB \
                or vdim % SUB:
            raise ValueError(f"{fn}: the CUDA kernels take chunk, K and V "
                             f"multiples of {SUB} up to {MAX_DIM}; got "
                             f"{chunk}, {kdim}, {vdim}")
        if any(t.data_ptr() % 16 for t in ts):
            raise ValueError(f"{fn}: the CUDA kernels take operands whose "
                             f"data is 16-byte aligned")
    return bh, s, kdim, vdim


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def rwkv6_chunk_scan_ref(r, k, v, logw, u, s0, *, chunk: int = CHUNK,
                         states: bool = False):
    """Plain forward (the reference model's chunk body, per bh). Returns
    (y (BH, S, V), s_final (BH, K, V)), and with `states=True` also the
    state at the start of every chunk, (BH, S/chunk, K, V)."""
    bh, s, _, _ = check_inputs("rwkv6_chunk_scan_ref", r, k, v, logw, u, s0,
                               chunk)
    # i < t: the strictly lower (t, i) pairs of a chunk
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)[None, :, :, None]
    st, ys, starts = s0, [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        starts.append(st)
        cw = torch.cumsum(wb, dim=1)                          # inclusive
        cx = cw - wb                                          # exclusive
        total = cw[:, -1:]                                    # (BH, 1, K)
        y_inter = torch.einsum("bck,bkv->bcv", rb * torch.exp(cx), st)
        # e^{cx[t] - cw[i]} for i < t, 0 elsewhere: (BH, C, C, K) [t, i, k]
        decay = torch.exp(torch.where(
            tri, cx[:, :, None, :] - cw[:, None, :, :], -torch.inf))
        att = torch.einsum("bck,bjk,bcjk->bcj", rb, kb, decay)
        bonus = torch.einsum("bck,bk,bck->bc", rb, u, kb)[..., None]
        y_intra = att @ vb + bonus * vb
        kdec = kb * torch.exp(total - cw)
        st = st * torch.exp(total).transpose(1, 2) + \
            kdec.transpose(1, 2) @ vb
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)
    if states:
        return y, st, torch.stack(starts, dim=1)
    return y, st


def rwkv6_chunk_scan_bwd_ref(r, k, v, logw, u, s0, dy, ds_final, *,
                             chunk: int = CHUNK):
    """Plain backward: torch.autograd.grad through rwkv6_chunk_scan_ref for
    the output gradients dy (BH, S, V) and ds_final (BH, K, V). Returns
    (dr, dk, dv, dlogw, du (BH, K), ds0)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True)
                  for x in (r, k, v, logw, u, s0)]
        y, s_final = rwkv6_chunk_scan_ref(*leaves, chunk=chunk)
        return torch.autograd.grad((y, s_final), leaves, (dy, ds_final))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    return build.bind("rwkv6_chunk", SIGNATURES)


def scan_forward(r, k, v, logw, u, s0, *, chunk: int = CHUNK,
                 save_states: bool = False):
    """One forward launch. Returns (y, s_final, states or None); `states`
    (BH, S/chunk, K, V) is the state at the start of every chunk. CPU
    tensors run the plain version."""
    bh, s, kdim, vdim = check_inputs("rwkv6_chunk_scan", r, k, v, logw, u,
                                     s0, chunk)
    if r.device.type == "cpu":
        out = rwkv6_chunk_scan_ref(r, k, v, logw, u, s0, chunk=chunk,
                                   states=save_states)
        return out if save_states else (*out, None)
    lib = _lib()
    y = torch.empty((bh, s, vdim), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s0)
    # the state pass writes every chunk-start state for the output pass
    # (and the backward); without save_states they are scratch
    states = torch.empty((bh, s // chunk, kdim, vdim), dtype=torch.float32,
                         device=r.device)
    build.launch("rwkv6_chunk_scan", lib.rwkv6_fwd_launch, r,
                 r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                 states.data_ptr(), bh, s, chunk, kdim, vdim)
    rwkv6_chunk_scan.launches += 1
    return y, s_out, states if save_states else None


def rwkv6_chunk_scan_bwd(r, k, v, logw, u, states, dy, ds_final, *,
                         chunk: int = CHUNK):
    """Gradients of (y, s_final) -> (r, k, v, logw, u, s0); `states` as
    `scan_forward` wrote them. One call runs three kernels: the reverse
    state pass, the gradient pass and du's reduction, with two scratch
    tensors allocated here: `dstates` (the shape of `states`, the gradient
    of the state after every chunk) and du's per-chunk partials (BH,
    S/chunk, K). CPU tensors run the plain version. Returns (dr, dk, dv,
    dlogw, du, ds0)."""
    bh, s, kdim, vdim = check_inputs("rwkv6_chunk_scan_bwd", r, k, v, logw,
                                     u, ds_final, chunk)
    for name, t, shape in (("states", states, (bh, s // chunk, kdim, vdim)),
                           ("dy", dy, (bh, s, vdim))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != r.device):
            raise ValueError(f"rwkv6_chunk_scan_bwd: {name} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{r.device}")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError(f"rwkv6_chunk_scan_bwd: the CUDA kernels take "
                             f"{name} whose data is 16-byte aligned")
    if r.device.type == "cpu":
        return rwkv6_chunk_scan_bwd_ref(r, k, v, logw, u,
                                        states[:, 0].contiguous(), dy,
                                        ds_final, chunk=chunk)
    lib = _lib()
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, logw))
    du = torch.empty_like(u)
    ds0 = torch.empty_like(ds_final)
    # scratch: the reverse pass writes the gradient of the state after
    # every chunk for the gradient pass, which writes du's partial of every
    # chunk for the reduction
    dstates = torch.empty_like(states)
    du_part = torch.empty((bh, s // chunk, kdim), dtype=torch.float32,
                          device=r.device)
    build.launch("rwkv6_chunk_scan_bwd", lib.rwkv6_bwd_launch, r,
                 *(t.data_ptr() for t in (r, k, v, logw, u, states, dy,
                                          ds_final, dr, dk, dv, dw, du, ds0,
                                          dstates, du_part)),
                 bh, s, chunk, kdim, vdim)
    rwkv6_chunk_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


class _Scan(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the CUDA backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk, save):
        y, s_out, states = scan_forward(r, k, v, logw, u, s0, chunk=chunk,
                                        save_states=save)
        if save:
            ctx.save_for_backward(r, k, v, logw, u, states)
        ctx.chunk = chunk
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, logw, u, states = ctx.saved_tensors
        bh, s, kdim = r.shape
        vdim = v.shape[-1]
        dy = (torch.zeros((bh, s, vdim), dtype=torch.float32, device=r.device)
              if dy is None else dy.contiguous())
        ds_final = (torch.zeros((bh, kdim, vdim), dtype=torch.float32,
                                device=r.device)
                    if ds_final is None else ds_final.contiguous())
        grads = rwkv6_chunk_scan_bwd(r, k, v, logw, u, states, dy, ds_final,
                                     chunk=ctx.chunk)
        return (*grads, None, None)


def rwkv6_chunk_scan(r, k, v, logw, u, s0, *, chunk: int = CHUNK):
    """r, k, logw (BH, S, K); v (BH, S, V); u (BH, K) bonus; s0 (BH, K, V)
    initial state; S a multiple of `chunk`. Returns (y (BH, S, V),
    s_final (BH, K, V)), differentiable in every input. Both branches
    check their operands."""
    if r.device.type == "cpu":
        return rwkv6_chunk_scan_ref(r, k, v, logw, u, s0, chunk=chunk)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u, s0))
    return _Scan.apply(r, k, v, logw, u, s0, chunk, save)


rwkv6_chunk_scan.launches = 0
rwkv6_chunk_scan_bwd.launches = 0
