"""The fp8 (e4m3) gradient wire's encode and error-feedback residual update:
the two passes around each fold of an fp8-wire micro-batch (or layer slab),
the fold itself being `fused_step.arena_fold(_slice)` on the codes with
their `grad_scale` column.

  fp8_encode          the wrappers. On CUDA tensors they launch the
  fp8_ef_update       hand-written kernels in csrc/fp8_wire.cu (or raise);
                      on CPU tensors they run the plain versions.
  fp8_encode_ref      the plain PyTorch versions: the same operations in
  fp8_ef_update_ref   the same order, used on the CPU and as the kernels'
                      oracle.

The reference computes both in plain jnp (`kernels/adama_accum.py::
fp8_encode_rows` after the residual's injection, and the residual's
update, in `core/accumulation.py` and `core/layerwise.py`):

  x    = fma(ef, S, slab)             the residual injected (slab alone
                                      without error feedback)
  codes, s = fp8_encode_rows(x)       e4m3 codes and the (rows, 1) scales
  ok   = ok AND isfinite(x).all()     the guard's flag (fp8_encode)
  ... the guarded fold of (codes, s) ...
  ef   = where(ok, fma(-codes, s, x) / S, ef)        (fp8_ef_update)

S is the live loss scale (Algorithm 1) or 1 / fold_scale (Algorithm 2), a
one-element float32 tensor on the operands' device: the residual is kept
unscaled, so that a dynamic scale may change between micro-batches.
XLA CPU's contractions (the two FMAs) and its flush of subnormals are
spelled out (`_fma32`, `adama_accum.ftz`), so kernel, plain version and
reference agree bit for bit; the codes' one exception (a finite element
above 464 in a row that holds a NaN: +-448 here, NaN in the reference) is
adama_accum.py's. fp8_ef_update forms x again from the slab and the old
residual rather than reading it back, so the slab is never written.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adama_accum import (_fma32, fp8_encode_rows, ftz)

LANES = 1024
# rows per step of the plain versions: bounds their float64 temporaries on
# a full-size arena (results do not depend on it)
_PLAIN_CHUNK_ROWS = 16384

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# C signatures of the launchers in csrc/fp8_wire.cu (the trailing pointer is
# the CUDA stream). fp8_encode_launch: slab, ef (NULL without error
# feedback), S, codes, scale column, ok (NULL: no flag), rows.
# fp8_ef_update_launch: ef, slab, codes, scale column, S, ok, rows.
SIGNATURES = {
    "fp8_encode_launch": (_P, _P, _P, _P, _P, _P, _I64, _P),
    "fp8_ef_update_launch": (_P, _P, _P, _P, _P, _P, _I64, _P),
}


def _lib() -> ctypes.CDLL:
    return build.bind("fp8_wire", SIGNATURES)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rows(fn: str, t: torch.Tensor, dtype, what: str, rows=None,
                device=None) -> None:
    """A (rows, LANES) operand of `dtype`, contiguous, on `device` (CPU or
    CUDA; 16-byte aligned there)."""
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != LANES or (rows is not None
                                                and t.shape[0] != rows):
        raise ValueError(f"{fn}: {what} must be ({rows or 'rows'}, {LANES}), "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{fn}: {what} on {t.device}, the slab on {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{fn}: CUDA operands must be 16-byte aligned")


def _check_scalar(fn: str, t: torch.Tensor, what: str, device) -> None:
    """A one-element contiguous float32 tensor on `device`."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.numel() != 1 or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{fn}: {what} must be one float32 element on "
                         f"{device}")


def _check_scale_col(fn: str, gs: torch.Tensor, rows: int, device) -> None:
    if (gs.dtype != torch.float32 or tuple(gs.shape) != (rows, 1)
            or not gs.is_contiguous() or gs.device != device):
        raise ValueError(f"{fn}: the scale column must be a contiguous "
                         f"({rows}, 1) float32 tensor on {device}, got "
                         f"{tuple(gs.shape)} {gs.dtype} on {gs.device}")


def _inject(slab, ef, scale):
    """x = fma(ef, S, slab), flushed; the slab alone (flushed) without
    ef."""
    x = ftz(slab)
    return x if ef is None else ftz(_fma32(ftz(ef), ftz(scale), x))


def fp8_encode_ref(slab, *, ef=None, scale=None, ok=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `fp8_encode`."""
    rows = slab.shape[0]
    codes = torch.empty(slab.shape, dtype=torch.float8_e4m3fn,
                        device=slab.device)
    gs = torch.empty((rows, 1), dtype=torch.float32, device=slab.device)
    scale = None if ef is None else scale.reshape(())
    finite = torch.ones((), dtype=torch.bool, device=slab.device)
    for lo in range(0, rows, _PLAIN_CHUNK_ROWS):
        hi = lo + _PLAIN_CHUNK_ROWS
        x = _inject(slab[lo:hi], None if ef is None else ef[lo:hi], scale)
        codes[lo:hi], gs[lo:hi] = fp8_encode_rows(x)
        finite &= torch.isfinite(x).all()
    if ok is not None:
        ok.copy_(torch.where(finite, ok, torch.zeros_like(ok)))
    return codes, gs


def fp8_encode(slab: torch.Tensor, *, ef: Optional[torch.Tensor] = None,
               scale: Optional[torch.Tensor] = None,
               ok: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a (rows, LANES) float32 gradient slab for the e4m3 wire:
    with the residual `ef` (the slab's rows of state["ef"], a view) injected
    first at the scale `scale` (one float32 element on the device, the live
    loss scale), x = fma(ef, S, slab); then the (rows, LANES)
    float8_e4m3fn codes of x and their (rows, 1) float32 scale column, both
    new tensors, returned as (codes, scales). `ok` (one float32 element, a
    guard vector's ok slot) is ANDed with x being finite everywhere. The
    slab and ef are read only."""
    fn = "fp8_encode"
    _check_rows(fn, slab, torch.float32, "slab")
    if ef is not None:
        _check_rows(fn, ef, torch.float32, "ef", slab.shape[0], slab.device)
        _check_scalar(fn, scale, "scale", slab.device)
    if ok is not None:
        _check_scalar(fn, ok, "ok", slab.device)
    if slab.device.type == "cpu":
        return fp8_encode_ref(slab, ef=ef, scale=scale, ok=ok)
    codes = torch.empty(slab.shape, dtype=torch.float8_e4m3fn,
                        device=slab.device)
    gs = torch.empty((slab.shape[0], 1), dtype=torch.float32,
                     device=slab.device)
    if slab.numel():
        build.launch(fn, _lib().fp8_encode_launch, slab, slab.data_ptr(),
                     _ptr(ef), None if ef is None else scale.data_ptr(),
                     codes.data_ptr(), gs.data_ptr(), _ptr(ok),
                     slab.shape[0])
        fp8_encode.launches += 1
    return codes, gs


fp8_encode.launches = 0


def fp8_ef_update_ref(ef, slab, codes, gs, *, scale, ok):
    """Plain version of `fp8_ef_update`."""
    keep = ok.reshape(()) == 0
    scale = ftz(scale.reshape(()))
    for lo in range(0, slab.shape[0], _PLAIN_CHUNK_ROWS):
        hi = lo + _PLAIN_CHUNK_ROWS
        e = ef[lo:hi]
        x = _inject(slab[lo:hi], e, scale)
        d = ftz(_fma32(-codes[lo:hi].to(torch.float32), ftz(gs[lo:hi]), x))
        e.copy_(torch.where(keep, e, ftz(d / scale)))
    return ef


def fp8_ef_update(ef: torch.Tensor, slab: torch.Tensor, codes: torch.Tensor,
                  gs: torch.Tensor, *, scale: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """The error-feedback residual's update after the fold of (codes, gs),
    in place: where ok != 0, ef = fma(-code, gs, x) / S, x = fma(ef, S,
    slab) formed again from the slab and the old ef as `fp8_encode` formed
    it (the quantization error, back in unscaled units); with ok == 0 ef
    keeps every byte (the skipped micro-batch's residual is the one before
    it). `scale` and `ok` as in fp8_encode. Returns ef."""
    fn = "fp8_ef_update"
    _check_rows(fn, slab, torch.float32, "slab")
    rows, dev = slab.shape[0], slab.device
    _check_rows(fn, ef, torch.float32, "ef", rows, dev)
    _check_rows(fn, codes, torch.float8_e4m3fn, "codes", rows, dev)
    _check_scale_col(fn, gs, rows, dev)
    _check_scalar(fn, scale, "scale", dev)
    _check_scalar(fn, ok, "ok", dev)
    if dev.type == "cpu":
        return fp8_ef_update_ref(ef, slab, codes, gs, scale=scale, ok=ok)
    if slab.numel():
        build.launch(fn, _lib().fp8_ef_update_launch, slab, ef.data_ptr(),
                     slab.data_ptr(), codes.data_ptr(), gs.data_ptr(),
                     scale.data_ptr(), ok.data_ptr(), rows)
        fp8_ef_update.launches += 1
    return ef


fp8_ef_update.launches = 0
