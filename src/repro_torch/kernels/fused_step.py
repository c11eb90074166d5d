"""Arena-wide fused AdamA kernels: the whole-arena m/v fold (one launch per
micro-batch), the slice fold of Algorithm 2 (one launch per layer and one
for the rest region, per micro-batch) and the bias-corrected apply (one
launch per mini-batch).

Each function has two forms, side by side:

  arena_fold / arena_fold_slice /   the wrappers. On CUDA tensors they launch
  arena_apply                       the hand-written kernel in
                                    csrc/fused_step.cu (or raise); on CPU
                                    tensors they run the plain version.
  arena_fold_ref /                  the plain PyTorch versions: the same
  arena_fold_slice_ref /            operations in the same order, used on
  arena_apply_ref                   the CPU and as the kernels' oracle.

They replace the Pallas kernels of `repro/kernels/fused_step.py` in the
fp32-moment, fp32-wire, unguarded, static-scale form. The m/v (fold) and p
(apply) arenas are updated IN PLACE, where the reference aliases input to
output.

Scalars are rounded to float32 on the host the way JAX's weak-typed Python
floats are: `1 - beta1` is formed in double and then rounded (0.1f for
beta1=0.9, where `1.0f - 0.9f` would give 0.10000002).

The reference's CPU lowering evaluates the fold's `d*m + c*g` pairs and the
apply's final `p - lr*u` (and `u + wd*p`) as fused multiply-adds, and its
`(m/bc1) / (sqrt(v/bc2) + eps)` as `m / (bc1*(sqrt(v/bc2) + eps))`. The
kernels spell out the same operations; the plain versions compute each
fused multiply-add exactly with `_fma32`. Kernel, plain version and
reference therefore agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

LANES = 1024          # arena row width (the reference's 8 x 128 lanes)
BLOCK_ROWS = 256      # arena row-count granularity above 256 rows

# rows per step of the plain versions: bounds their float64 temporaries on
# a full-size arena (results do not depend on it)
_PLAIN_CHUNK_ROWS = 16384


def _f32(x) -> float:
    return float(np.float32(x))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with ONE rounding, like a fused multiply-add.

    a*b is exact in float64 (24+24 significant bits). The float64 sum is
    kept exact as s + err (TwoSum), rounded to odd (if inexact, the last
    bit of s is forced odd toward err), and then rounded to float32; with
    53 >= 24 + 2 bits that double rounding is correct."""
    prod = a.double() * b.double()
    c = c.double()
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).float()


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (torch's CPU kernel is not): the
    float64 root rounded once more to float32 is exact."""
    return torch.sqrt(x.double()).float()


def _check_arenas(fn: str, *ts: torch.Tensor, same_rows: bool = True) -> None:
    """Every operand: fp32, (rows, LANES), contiguous, one shape (or only
    one row width, `same_rows=False`) and one device (CPU or CUDA, 16-byte
    aligned on CUDA for float4 access)."""
    ref = ts[0]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: expected float32 operands, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"{fn}: expected (rows, {LANES}) operands, got "
                             f"{tuple(t.shape)}")
        if same_rows and t.shape != ref.shape:
            raise ValueError(f"{fn}: operand shapes differ: "
                             f"{tuple(t.shape)} vs {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{fn}: operands on {t.device} and {ref.device}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: unsupported device {t.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{fn}: CUDA operands must be 16-byte aligned")


_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C signatures of the launchers in csrc/fused_step.cu (the trailing pointer
# is the CUDA stream)
SIGNATURES = {
    "arena_fold_launch": (_P, _P, _P, _I64, _F, _F, _F, _F, _F, _P),
    "arena_fold_slice_launch": (_P, _P, _P, _I64, _I64, _F, _F, _F, _F, _F,
                                _P),
    "arena_apply_launch": (_P, _P, _P, _I64, _F, _F, _F, _F, _F, _P),
}


def _lib() -> ctypes.CDLL:
    return build.bind("fused_step", SIGNATURES)


# ---------------------------------------------------------------------------
# Fold
# ---------------------------------------------------------------------------


def _fold_scalars(beta1, beta2, scale, decay):
    dm, dv = (1.0, 1.0) if decay is None else decay
    return (_f32(scale), _f32(1.0 - beta1), _f32(1.0 - beta2), _f32(dm),
            _f32(dv))


def fold_args(m, v, g, beta1, beta2, scale, decay):
    """Arguments of arena_fold_launch, the stream excepted."""
    return (m.data_ptr(), v.data_ptr(), g.data_ptr(), m.numel(),
            *_fold_scalars(beta1, beta2, scale, decay))


def arena_fold_ref(m, v, g, *, beta1: float, beta2: float, scale=1.0,
                   decay=None):
    """Plain version of `arena_fold` (same operations, same order)."""
    s, c1, c2, dm, dv = (torch.tensor(x, dtype=torch.float32,
                                      device=m.device)
                         for x in _fold_scalars(beta1, beta2, scale, decay))
    for lo in range(0, m.shape[0], _PLAIN_CHUNK_ROWS):
        mc, vc = m[lo:lo + _PLAIN_CHUNK_ROWS], v[lo:lo + _PLAIN_CHUNK_ROWS]
        gs = g[lo:lo + _PLAIN_CHUNK_ROWS] * s
        mc.copy_(_fma32(dm, mc, c1 * gs))
        vc.copy_(_fma32(dv, vc, c2 * (gs * gs)))
    return m, v


def arena_fold(m, v, g, *, beta1: float, beta2: float, scale=1.0,
               decay=None):
    """Fold one micro-batch's packed gradient `g` into the m/v arenas, in
    place: m = dm*m + (1-beta1)*(scale*g), v = dv*v + (1-beta2)*(scale*g)^2.
    `decay=(dm, dv)` fuses the begin-minibatch decay into this fold (pass
    (beta1, beta2) on the first micro-batch); None means (1, 1).
    Returns (m, v)."""
    _check_arenas("arena_fold", m, v, g)
    if m.device.type == "cpu":
        return arena_fold_ref(m, v, g, beta1=beta1, beta2=beta2, scale=scale,
                              decay=decay)
    build.launch("arena_fold", _lib().arena_fold_launch, m,
                 *fold_args(m, v, g, beta1, beta2, scale, decay))
    arena_fold.launches += 1
    return m, v


arena_fold.launches = 0


def fold_slice_args(m, v, g, row_offset, beta1, beta2, scale, decay):
    """Arguments of arena_fold_slice_launch, the stream excepted."""
    return (m.data_ptr(), v.data_ptr(), g.data_ptr(), row_offset, g.shape[0],
            *_fold_scalars(beta1, beta2, scale, decay))


def _check_slice(m, v, g, row_offset: int, block: int) -> None:
    """The reference's checks (fused_step.py::arena_fold_slice): whole
    blocks of rows, a block-aligned offset, and the slice inside the
    arena."""
    _check_arenas("arena_fold_slice", m, v)
    _check_arenas("arena_fold_slice", m, g, same_rows=False)
    rows_g = g.shape[0]
    if block < 1 or rows_g % block or row_offset % block:
        raise ValueError(f"arena_fold_slice: slab rows {rows_g} and row "
                         f"offset {row_offset} must be multiples of the "
                         f"block {block}")
    if row_offset < 0 or row_offset + rows_g > m.shape[0]:
        raise ValueError(f"arena_fold_slice: rows [{row_offset}, "
                         f"{row_offset + rows_g}) lie outside the arena's "
                         f"{m.shape[0]} rows")


def arena_fold_slice_ref(m, v, g, row_offset: int, *, beta1: float,
                         beta2: float, block: int, scale=1.0, decay=None):
    """Plain version of `arena_fold_slice`: `arena_fold_ref` on the rows
    of the slice (views of m and v). `block` is checked by the wrapper."""
    rows = slice(row_offset, row_offset + g.shape[0])
    arena_fold_ref(m[rows], v[rows], g, beta1=beta1, beta2=beta2, scale=scale,
                   decay=decay)
    return m, v


def arena_fold_slice(m, v, g, row_offset: int, *, beta1: float, beta2: float,
                     block: int, scale=1.0, decay=None):
    """Fold a (rows_g, LANES) gradient slab into arena rows
    [row_offset, row_offset + rows_g) of m and v, in place, with the
    arena_fold arithmetic; every other row is left untouched. `block` is
    the layout's `slice_block` for the region: rows_g and row_offset must
    be multiples of it. Returns (m, v)."""
    _check_slice(m, v, g, row_offset, block)
    if m.device.type == "cpu":
        return arena_fold_slice_ref(m, v, g, row_offset, beta1=beta1,
                                    beta2=beta2, block=block, scale=scale,
                                    decay=decay)
    build.launch("arena_fold_slice", _lib().arena_fold_slice_launch, m,
                 *fold_slice_args(m, v, g, row_offset, beta1, beta2, scale,
                                  decay))
    arena_fold_slice.launches += 1
    return m, v


arena_fold_slice.launches = 0


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _apply_scalars(lr, bc1, bc2, eps, weight_decay):
    return (_f32(lr), _f32(bc1), _f32(bc2), _f32(eps), _f32(weight_decay))


def apply_args(p, m, v, lr, bc1, bc2, eps, weight_decay):
    """Arguments of arena_apply_launch, the stream excepted."""
    return (p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
            *_apply_scalars(lr, bc1, bc2, eps, weight_decay))


def arena_apply_ref(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                    weight_decay: float = 0.0):
    """Plain version of `arena_apply` (same operations, same order)."""
    lr, bc1, bc2, eps, wd = (torch.tensor(x, dtype=torch.float32,
                                          device=p.device)
                             for x in _apply_scalars(lr, bc1, bc2, eps,
                                                     weight_decay))
    for lo in range(0, p.shape[0], _PLAIN_CHUNK_ROWS):
        pc = p[lo:lo + _PLAIN_CHUNK_ROWS]
        u = m[lo:lo + _PLAIN_CHUNK_ROWS] / (
            bc1 * (_sqrt32(v[lo:lo + _PLAIN_CHUNK_ROWS] / bc2) + eps))
        if weight_decay:
            u = _fma32(wd, pc, u)
        pc.copy_(_fma32(-lr, u, pc))
    return p


def arena_apply(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """Bias-corrected Adam apply over the packed param arena, in place:
    p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + weight_decay*p). Returns p."""
    _check_arenas("arena_apply", p, m, v)
    if p.device.type == "cpu":
        return arena_apply_ref(p, m, v, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
                               weight_decay=weight_decay)
    build.launch("arena_apply", _lib().arena_apply_launch, p,
                 *apply_args(p, m, v, lr, bc1, bc2, eps, weight_decay))
    arena_apply.launches += 1
    return p


arena_apply.launches = 0
