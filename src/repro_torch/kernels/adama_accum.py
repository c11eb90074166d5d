"""Per-leaf AdamA fold: the fold of the per-leaf state form, one launch per
leaf (or per layer view of a stacked leaf).

  adama_accum_2d      the wrapper. On CUDA tensors it launches the
                      hand-written kernel in csrc/adama_accum.cu (or
                      raises); on CPU tensors it runs the plain version.
  adama_accum_2d_ref  the plain PyTorch version: the same operations in the
                      same order, used on the CPU and as the kernel's
                      oracle.

They replace the Pallas kernel `repro/kernels/adama_accum.py::
adama_accum_2d` for fp32 m, v and g (a bf16 g is queued).

The module also holds the row helpers of the reference's int8, factored and
rowcol state codecs (`q8_encode_rows`, `q8s_encode_rows`, their decodes,
`fac_row_stat` and `rowcol_decode`): the building blocks of the codec
forms' plain versions in fused_step.py and the decode used on the host;
and those of its fp8 (e4m3) gradient wire (`fp8_encode_rows`,
`fp8_scale_rows`, `fp8_quantize_rows`, `fp8_decode_rows`), the plain
encode of kernels/fp8_wire.py.
The reference pads each leaf to (R, 1024) rows first
(`kernels/ops.py::_to_2d`); the fold is elementwise, so the port skips
the padding and folds the leaf's own memory in place: m, v and g are
contiguous tensors of one shape, any shape.

The reference's CPU lowering folds (1-beta1)*scale into one float32
constant and contracts the first moment into a fused multiply-add:
m = fma(g, f32(c1*s), m), v = fma(c2, (g*s)^2, v), with c1 = f32(1-beta1),
c2 = f32(1-beta2), s = f32(scale). Kernel, plain version and reference
compute exactly these, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

# elements per step of the plain version (bounds its float64 temporaries)
_PLAIN_CHUNK = 1 << 24


def _f32(x) -> float:
    return float(np.float32(x))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with ONE rounding, like a fused multiply-add.

    a*b is exact in float64 (24+24 significant bits). The float64 sum is
    kept exact as s + err (TwoSum), rounded to odd (if inexact, the last
    bit of s is forced odd toward err), and then rounded to float32; with
    53 >= 24 + 2 bits that double rounding is correct. An infinite or NaN
    sum is the result as it stands (TwoSum's error term is NaN there)."""
    prod = a.double() * b.double()
    c = c.double()
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    err = torch.where(torch.isfinite(s), err, torch.zeros_like(err))
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).float()


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU kernel is not): the
    float64 root rounded once more to float32 is exact."""
    return torch.sqrt(x.double()).float()

# ---------------------------------------------------------------------------
# Row helpers of the int8 and factored state codecs
# ---------------------------------------------------------------------------
#
# The reference's helpers run under XLA CPU, which evaluates every
# floating-point operation with subnormal inputs read as zero and subnormal
# results flushed to zero (its executables run with the FTZ and DAZ bits
# set; `q8_encode_rows`'s fallback scale relies on it). The helpers here
# spell that out with `ftz` after each operation, on the CPU and on the
# card alike, so that no global flag changes any other kernel.

Q8_MAX = 127.0
# float32(1/127): the reference multiplies by the weak-typed 1.0 / Q8_MAX
Q8_INV = float(np.float32(1.0 / Q8_MAX))
TINY = float(np.finfo(np.float32).tiny)      # 2^-126, the least normal


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal float32 values to zero of the same sign."""
    return torch.where(x.abs() < TINY, x * 0.0, x)


def _row_scale(rowmax: torch.Tensor) -> torch.Tensor:
    """rowmax * f32(1/127), flushed; a row whose scale flushed to zero but
    whose max is not zero takes the max itself (codes collapse to 0/±1)."""
    s = ftz(rowmax * Q8_INV)
    return torch.where((s == 0.0) & (rowmax > 0.0), rowmax, s)


def _safe(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0.0, s, torch.ones_like(s))


def q8_encode_rows(v: torch.Tensor):
    """(R, LANES) float32, v >= 0 -> ((R, LANES) int8 codes, (R, 1) float32
    scales): codes ceil(v / s) clipped to [0, 127], so v_hat >= v (but for
    the reference's one-ulp dip at the row max, where 127 * s can round
    below it). The divide is IEEE-rounded."""
    v = ftz(v)
    s = _row_scale(v.amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.ceil(ftz(v / _safe(s))), 0.0, Q8_MAX)
    return q.to(torch.int8), s


def q8_decode_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of q8_encode_rows (exact for the stored codes)."""
    return ftz(q.to(torch.float32) * ftz(s))


def q8s_encode_rows(m: torch.Tensor):
    """(R, LANES) float32, signed -> ((R, LANES) int8, (R, 1) float32):
    codes trunc(m / s) clipped to [-127, 127], rounding toward zero, so
    |m_hat| <= |m|; s from the row max of |m|."""
    m = ftz(m)
    s = _row_scale(m.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.trunc(ftz(m / _safe(s))), -Q8_MAX, Q8_MAX)
    return q.to(torch.int8), s


q8s_decode_rows = q8_decode_rows


def fac_row_stat(g2: torch.Tensor) -> torch.Tensor:
    """The factored codec's per-row statistic: the row max of g^2."""
    return ftz(g2).amax(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Row helpers of the fp8 (e4m3) gradient wire
# ---------------------------------------------------------------------------
#
# The reference's `fp8_*` helpers: a (R, LANES) fp32 slab becomes
# float8_e4m3fn codes and a (R, 1) fp32 scale column, scale = rowmax(|g|) *
# n_summands / FP8_MAX, so that the sum of n_summands codes (what a
# reduce-scatter adds; n_summands is kept for the ZeRO-1 wire) stays inside
# e4m3's finite range. XLA CPU's flush is spelled out as for the int8
# helpers: the scale's fallback for a row whose scale flushes to zero (a
# max below 2^-126 * 448) relies on it. A NaN in a row makes its max NaN
# (torch's amax propagates it, as jnp.max does), and the scale falls back
# to 1.0, so the NaN codes carry the signal to the finite guard.
#
# The cast. Up to 464 in magnitude, torch's float32 -> float8_e4m3fn cast
# and XLA's agree bit for bit (round to nearest even, the subnormal codes
# included; 464 itself, the tie between 448 and the NaN pattern, rounds to
# 448). Above 464, and for +-inf, XLA gives NaN, torch saturates to +-448,
# and so does Hopper's cvt.rn.satfinite.e4m3x2.f32 (the CUDA encoder's).
# The encoder's scale puts a finite row's max at 448, so only a finite
# element of a row that also holds a NaN (whose scale fell back to 1.0)
# can pass 464: the port's code is then +-448 where the reference's is
# NaN. That micro-batch is skipped (its NaN code fails the guard), so no
# state ever sees the difference. The plain version clamps to +-448 before
# torch's cast, so that it saturates on every torch build as the card
# does.

FP8_MAX = 448.0       # largest finite float8_e4m3fn value


def fp8_scale_rows(rowmax: torch.Tensor, n_summands: int = 1) -> torch.Tensor:
    """(R, 1) per-row maxima of |g| -> the (R, 1) fp32 scale column:
    rowmax * f32(n_summands / 448), flushed; a row whose scale flushed to
    zero while its max did not takes the max itself; a zero or NaN max
    takes 1.0."""
    rowmax = ftz(rowmax)
    s = ftz(rowmax * _f32(n_summands / FP8_MAX))
    s = torch.where((s == 0.0) & (rowmax > 0.0), rowmax, s)
    return torch.where(s > 0.0, s, torch.ones_like(s))


def fp8_quantize_rows(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes of a slab under a scale column from fp8_scale_rows: g / s
    (IEEE divide) rounded to nearest even, saturating at +-448."""
    return torch.clamp(g / s, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def fp8_decode_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes (exact in fp32) times their row's scale, flushed."""
    return ftz(q.to(torch.float32) * ftz(s))


def fp8_encode_rows(g: torch.Tensor, n_summands: int = 1):
    """(R, LANES) fp32 -> ((R, LANES) float8_e4m3fn codes, (R, 1) fp32
    scales): the scale from the row's max of |g| (NaN-propagating), then
    the codes. A NaN element stays NaN through the divide; an inf element
    makes its row's scale inf and its own code inf/inf = NaN."""
    g = ftz(g)
    s = fp8_scale_rows(g.abs().amax(dim=-1, keepdim=True), n_summands)
    return fp8_quantize_rows(g, s), s


# rowcol's least column total (float32(1e-30), a normal number)
RC_FLOOR = float(np.float32(1e-30))


def halving_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` (a power of two long) in a halving tree,
    x[i] + x[i + n/2] at each level, each sum flushed: the order in which the
    CUDA kernels add (a warp's shuffles down, a lane's registers, a CTA's
    warps). Keeps `dim`, of length 1."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = ftz(x.narrow(dim, 0, h) + x.narrow(dim, h, h))
    return x


def rowcol_total(vc: torch.Tensor) -> torch.Tensor:
    """sum(vc) of the (1, LANES) column sums, as (1, 1), in the order of
    the apply kernel (csrc/fused_step.cu, rowcol_normalise): thread t's
    columns 4t .. 4t + 3 in a halving tree, then its warp's 32 lanes, then
    the CTA's 8 warps. The reference sums in XLA's order, which no simple
    order reproduces bit for bit."""
    t = ftz(vc).reshape(8, 32, 4)        # (warp, lane, column of the lane)
    for dim in (2, 1, 0):
        t = halving_sum(t, dim)
    return t.reshape(1, 1)


def rowcol_decode(vr: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """The rowcol codec's rank-1 reconstruction (Adafactor) from the
    (R, 1) row sums and the (1, LANES) column sums:
    v_hat = vr * (vc / max(sum(vc), 1e-30)), flushed as XLA CPU does, the
    sum in the port's order (`rowcol_total`). Exact when v is rank one;
    zero rows decode to zero."""
    total = torch.clamp(rowcol_total(vc), min=RC_FLOOR)
    return ftz(ftz(vr) * ftz(ftz(vc) / total))


_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C signature of the launcher in csrc/adama_accum.cu (the trailing pointer
# is the CUDA stream)
SIGNATURES = {"adama_accum_launch": (_P, _P, _P, _I64, _F, _F, _F, _P)}


def check_leaves(fn: str, *ts: torch.Tensor) -> None:
    """Every operand: fp32, contiguous, one shape and one device (CPU or
    CUDA)."""
    ref = ts[0]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: expected float32 operands, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"{fn}: operand shapes differ: "
                             f"{tuple(t.shape)} vs {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{fn}: operands on {t.device} and {ref.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: unsupported device {t.device}")


def _scalars(beta1, beta2, scale):
    """(s, f32(c1*s), c2): the product c1*s is rounded to float32 as the
    reference's constant folding does."""
    s = np.float32(scale)
    return (float(s), float(np.float32(1.0 - beta1) * s), _f32(1.0 - beta2))


def accum_args(m, v, g, beta1, beta2, scale):
    """Arguments of adama_accum_launch, the stream excepted."""
    return (m.data_ptr(), v.data_ptr(), g.data_ptr(), m.numel(),
            *_scalars(beta1, beta2, scale))


def adama_accum_2d_ref(m, v, g, *, beta1: float, beta2: float, scale=1.0):
    """Plain version of `adama_accum_2d` (same operations, same order)."""
    s, cs1, c2 = (torch.tensor(x, dtype=torch.float32, device=m.device)
                  for x in _scalars(beta1, beta2, scale))
    mf, vf, gf = m.view(-1), v.view(-1), g.view(-1)
    for lo in range(0, mf.numel(), _PLAIN_CHUNK):
        mc, vc = mf[lo:lo + _PLAIN_CHUNK], vf[lo:lo + _PLAIN_CHUNK]
        gc = gf[lo:lo + _PLAIN_CHUNK]
        gs = gc * s
        mc.copy_(_fma32(gc, cs1, mc))
        vc.copy_(_fma32(c2, gs * gs, vc))
    return m, v


def adama_accum_2d(m, v, g, *, beta1: float, beta2: float, scale=1.0):
    """Fold one leaf's gradient into its moments, in place:
    m += (1-beta1)*scale*g, v += (1-beta2)*(scale*g)^2. Returns (m, v)."""
    check_leaves("adama_accum_2d", m, v, g)
    if m.device.type == "cpu":
        return adama_accum_2d_ref(m, v, g, beta1=beta1, beta2=beta2,
                                  scale=scale)
    build.launch("adama_accum_2d",
                 build.bind("adama_accum", SIGNATURES).adama_accum_launch, m,
                 *accum_args(m, v, g, beta1, beta2, scale))
    adama_accum_2d.launches += 1
    return m, v


adama_accum_2d.launches = 0
