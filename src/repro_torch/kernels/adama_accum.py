"""Per-leaf AdamA fold: the fold of the per-leaf state form, one launch per
leaf (or per layer view of a stacked leaf).

  adama_accum_2d      the wrapper. On CUDA tensors it launches the
                      hand-written kernel in csrc/adama_accum.cu (or
                      raises); on CPU tensors it runs the plain version.
  adama_accum_2d_ref  the plain PyTorch version: the same operations in the
                      same order, used on the CPU and as the kernel's
                      oracle.

They replace the Pallas kernel `repro/kernels/adama_accum.py::
adama_accum_2d` for fp32 m, v and g (a bf16 g is queued). The reference
pads each leaf to (R, 1024) rows first (`kernels/ops.py::_to_2d`); the fold
is elementwise, so the port skips the padding and folds the leaf's own
memory in place: m, v and g are contiguous tensors of one shape, any shape.

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
from repro_torch.kernels.fused_step import _f32, _fma32

# elements per step of the plain version (bounds its float64 temporaries)
_PLAIN_CHUNK = 1 << 24

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
