"""Per-leaf bias-corrected Adam apply: the apply of the per-leaf state
form, one launch per param leaf.

  adam_apply_2d      the wrapper. On CUDA tensors it launches the
                     hand-written kernel in csrc/adam_apply.cu (or raises);
                     on CPU tensors it runs the plain version.
  adam_apply_2d_ref  the plain PyTorch version: the same operations in the
                     same order, used on the CPU and as the kernel's oracle.

They replace the Pallas kernel `repro/kernels/adam_apply.py::adam_apply_2d`
for fp32 p, m and v (a bf16 p is queued), on the leaf's own memory without
the reference's (R, 1024) padding, as `adama_accum.py` does. p is updated
in place.

The reference's CPU lowering evaluates the update exactly as it does
arena_apply's: u = m / (bc1*(sqrt(v/bc2) + eps)), u = fma(wd, p, u) when
wd != 0, p = fma(-lr, u, p). Kernel, plain version and reference agree bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adama_accum import check_leaves
from repro_torch.kernels.fused_step import _f32, _fma32, _sqrt32

# elements per step of the plain version (bounds its float64 temporaries)
_PLAIN_CHUNK = 1 << 24

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# C signature of the launcher in csrc/adam_apply.cu (the trailing pointer
# is the CUDA stream)
SIGNATURES = {"adam_apply_launch": (_P, _P, _P, _I64, _F, _F, _F, _F, _F,
                                    _P)}


def _scalars(lr, bc1, bc2, eps, weight_decay):
    return (_f32(lr), _f32(bc1), _f32(bc2), _f32(eps), _f32(weight_decay))


def apply_args(p, m, v, lr, bc1, bc2, eps, weight_decay):
    """Arguments of adam_apply_launch, the stream excepted."""
    return (p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
            *_scalars(lr, bc1, bc2, eps, weight_decay))


def adam_apply_2d_ref(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                      weight_decay: float = 0.0):
    """Plain version of `adam_apply_2d` (same operations, same order)."""
    lr, bc1, bc2, eps, wd = (torch.tensor(x, dtype=torch.float32,
                                          device=p.device)
                             for x in _scalars(lr, bc1, bc2, eps,
                                               weight_decay))
    pf, mf, vf = p.view(-1), m.view(-1), v.view(-1)
    for lo in range(0, pf.numel(), _PLAIN_CHUNK):
        pc = pf[lo:lo + _PLAIN_CHUNK]
        u = mf[lo:lo + _PLAIN_CHUNK] / (
            bc1 * (_sqrt32(vf[lo:lo + _PLAIN_CHUNK] / bc2) + eps))
        if weight_decay:
            u = _fma32(wd, pc, u)
        pc.copy_(_fma32(-lr, u, pc))
    return p


def adam_apply_2d(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                  weight_decay: float = 0.0):
    """Bias-corrected Adam apply on one leaf, in place:
    p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + weight_decay*p). Returns p."""
    check_leaves("adam_apply_2d", p, m, v)
    if p.device.type == "cpu":
        return adam_apply_2d_ref(p, m, v, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
                                 weight_decay=weight_decay)
    build.launch("adam_apply_2d",
                 build.bind("adam_apply", SIGNATURES).adam_apply_launch, p,
                 *apply_args(p, m, v, lr, bc1, bc2, eps, weight_decay))
    adam_apply_2d.launches += 1
    return p


adam_apply_2d.launches = 0
