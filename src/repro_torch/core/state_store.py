"""Optimizer-state store over the arena (`repro/core/state_store.py`):
pluggable codecs for both Adam moments, the paper's composition of AdamA
with optimizer-state memory reduction.

A training configuration picks an (m_codec, v_codec) pair, and every
registered pair runs through the same three fused kernels
(kernels/fused_step.py): one fold per micro-batch (or per layer slice),
one apply per mini-batch.

First-moment codecs (m is signed and carries the update's direction):

  fp32      (rows, LANES) fp32                   exact; the default.
  int8      (rows, LANES) int8 + (rows, 1) fp32  per-row codes over
            scales                               [-127, 127], truncated
            toward zero, so |m_hat| <= |m|: the update is only ever damped.

Second-moment codecs (v >= 0, under the square root):

  fp32      (rows, LANES) fp32                   exact; the default.
  int8      (rows, LANES) int8 + (rows, 1) fp32  ceil codes over [0, 127]:
            0 <= v_hat - v <= rowmax/127 (never-amplify).
  factored  (rows, 1) fp32                       the row max of g^2, decayed
            as v is: an SM3-style upper bound, one cover per arena row.
  rowcol    (rows, 1) + (1, LANES) fp32          Adafactor's marginals: row
            sums and one block of column sums, v_hat = vr * vc / sum(vc);
            exact for a rank-one v, never-amplify not declared.

Every column but rowcol's column sums is row-indexed. That one block is
shared by every row: the fold kernels add into it and leave its decay to
the host, once per micro-batch (`begin_micro`, `begin_micro_state`), since
the layer-wise engine folds a micro-batch in many slices.

A fold's gradient slab is the wire's: float32, bfloat16 upcast to float32
inside the kernel, or float8_e4m3fn codes with their (rows, 1) scale column
(`grad_scale=`, kernels/fp8_wire.py encodes both) decoded inside it. The
slab's dtype names the wire.

The finite guard (`guard=`, the reference's): a fold's guard is True (the
slab checks itself: `finite_and` into a fresh guard vector) or the caller's
device vector [dm, dv, ok, scale] (kernels/fused_step.py::guard_scalars),
which then also carries the decay of the shared columns; the apply's is a
(1,) device flag. With ok == 0 the call is a bitwise no-op, the shared
columns' host-side decay included (`_guarded_begin_micro`). The ZeRO-1
collectives wait for their slice.

The fp8 wire's error-feedback residual (OptimizerConfig.error_feedback):
the state dict carries "ef", an fp32 Arena in unscaled gradient units,
which the engines read and update around each fold (kernels/fp8_wire.py);
`wire_region_bytes` reports it.

Master params (OptimizerConfig.master_params): the state dict carries the
fp32 master region "p" (an Arena) and, with the working-param cache, the
bf16 region "wp". `apply_master_state` updates the master in place and
writes bf16(master) as the working params in the same kernel, into "wp"
when the state has it.

The port updates state IN PLACE: the codec columns a fold or apply is
given are the ones written, and a "new" state shares them with the old.
Each codec declares the reference's conformance contract (`Conformance`),
which tests/test_torch_codecs.py holds the port to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.arena import Arena, ArenaLayout
from repro_torch.kernels import fused_step
from repro_torch.kernels.adama_accum import ftz
from repro_torch.kernels.fused_step import LANES


class MomentState:
    """A codec-encoded Adam moment: a tuple of codec columns plus its
    layout, codec name and moment."""

    def __init__(self, parts, layout: ArenaLayout, codec: str,
                 moment: str = "v"):
        self.parts = tuple(parts)
        self.layout = layout
        self.codec = codec
        self.moment = moment

    def decode(self) -> torch.Tensor:
        """The (rows, LANES) fp32 moment arena."""
        return get_codec(self.codec, self.moment).decode(self.parts)

    def __repr__(self):
        return (f"MomentState({self.moment}_codec={self.codec!r}, "
                f"rows={self.layout.rows}, "
                f"parts={[tuple(p.shape) for p in self.parts]})")


@dataclass(frozen=True)
class Conformance:
    """The codec's declared accuracy contract (the reference's fields and
    values)."""
    # elementwise |p - p_fp32| after one mini-batch, in units of lr; None:
    # no elementwise bound (a lossy statistic)
    drift_lr: Optional[float]
    # the drift the bf16 gradient wire may add, in units of lr
    bf16_wire_lr: float
    # |p_new - p_0| <= |p_new_fp32 - p_0| elementwise, per fold
    never_amplify: bool
    # every column row-indexed
    row_local: bool
    # adama vs adama_layerwise engine parity on the same codec pair
    engine_tol: float
    # the drift the fp8 wire with error feedback may add, in units of lr
    fp8_wire_lr: float = 4.0


class MomentCodec:
    """Host-side half of a codec: storage init, decode and the codec-space
    decay. The kernel-side half (columns and the plain fragments) is
    `self.kernel`."""

    name: str = "?"
    moment: str = "?"
    conformance: Conformance = None

    @property
    def kernel(self) -> fused_step.KernelCodec:
        return fused_step.kernel_codec(self.moment, self.name)

    def init(self, layout: ArenaLayout, device, rows: Optional[int] = None):
        """Zeroed state on `device`, the reference's column shapes: (rows,
        width) for a row-indexed column, (1, width) for a shared one.
        `rows` (default layout.rows) is the rows each row-indexed column
        holds: a ZeRO-1 rank's shard of them (core/zero.py)."""
        rows = layout.rows if rows is None else rows
        return MomentState(tuple(torch.zeros(
            (rows if c.row_indexed else 1, c.width), dtype=c.dtype,
            device=device) for c in self.kernel.cols),
            layout, self.name, self.moment)

    def parts_of(self, state) -> Tuple[torch.Tensor, ...]:
        return state.parts

    def decode(self, parts) -> torch.Tensor:
        """Full (rows, LANES) fp32 reconstruction (host, tests), with XLA
        CPU's flush of subnormals as the reference's decode runs there."""
        rows = parts[0].shape[0]
        return self.kernel.decode(tuple(parts), ftz).expand(rows, LANES)

    def scale_state(self, state, c: float):
        """state <- c * state in codec space, in place (the
        begin-minibatch decay)."""
        raise NotImplementedError

    def begin_micro(self, parts, decay, ok=None):
        """Decay the shared (non-row-indexed) columns, in place, once per
        micro-batch: the fold kernels decay the row-indexed ones, each row
        being folded once per micro-batch, but a shared column would be
        decayed once per slice fold. `decay` is a host number or a device
        scalar; `ok` (a bool tensor) where-selects the decayed values, never
        a multiply by a conditional 1.0 (x*1.0 is no bitwise identity for a
        subnormal under the flush). Nothing for a row-local codec."""
        return parts

    def psum_replicated(self, parts, group=None):
        """Sum the shared columns' per-rank partials over a process group,
        in place (ZeRO-1, once a mini-batch). Nothing for a row-local
        codec."""
        return parts


def _scale_(x: torch.Tensor, c, ok=None) -> None:
    y = ftz(x * c)
    x.copy_(y if ok is None else torch.where(ok, y, x))


class Fp32Codec(MomentCodec):
    """Identity codec: the moment is a full-precision Arena."""

    name = "fp32"
    conformance = Conformance(drift_lr=0.0, never_amplify=True,
                              row_local=True, engine_tol=5e-6,
                              bf16_wire_lr=0.25, fp8_wire_lr=2.0)

    def __init__(self, moment: str):
        self.moment = moment

    def init(self, layout, device, rows=None):
        return Arena.zeros(layout, device, rows)

    def parts_of(self, state):
        return (state.data,)

    def scale_state(self, state, c):
        state.data.mul_(c)
        return state


class Int8Codec(MomentCodec):
    """(rows, LANES) int8 codes + (rows, 1) fp32 row scales. m truncates
    toward zero over [-127, 127]; v takes the ceiling over [0, 127]."""

    name = "int8"
    conformance = Conformance(drift_lr=2.0, never_amplify=True,
                              row_local=True, engine_tol=2e-3,
                              bf16_wire_lr=2.0, fp8_wire_lr=4.0)

    def __init__(self, moment: str):
        self.moment = moment

    def scale_state(self, state, c):
        # c * (q * s) == q * (c * s): the decay touches the scales only
        _scale_(state.parts[1], c)
        return state


class FactoredCodec(MomentCodec):
    """v as one (rows, 1) fp32 per-row statistic (SM3-style)."""

    name = "factored"
    moment = "v"
    conformance = Conformance(drift_lr=None, never_amplify=True,
                              row_local=True, engine_tol=5e-6,
                              bf16_wire_lr=1.0, fp8_wire_lr=2.0)

    def scale_state(self, state, c):
        _scale_(state.parts[0], c)
        return state


class RowColCodec(MomentCodec):
    """v as its rank-1 marginals (Adafactor): (rows, 1) row sums and a
    (1, LANES) block of column sums, v_hat = vr * vc / sum(vc). The
    reconstruction can sit below v, so never-amplify is not declared; its
    contracts are exact marginals and an exact rank-one reconstruction."""

    name = "rowcol"
    moment = "v"
    conformance = Conformance(drift_lr=None, never_amplify=False,
                              row_local=False, engine_tol=2e-3,
                              bf16_wire_lr=1.0, fp8_wire_lr=2.0)

    def scale_state(self, state, c):
        # both marginals are linear in v
        for x in state.parts:
            _scale_(x, c)
        return state

    def begin_micro(self, parts, decay, ok=None):
        _scale_(parts[1], decay, ok)
        return parts

    def psum_replicated(self, parts, group=None):
        collectives.all_reduce(parts[1], group)
        return parts


M_CODECS = {c.name: c for c in (Fp32Codec("m"), Int8Codec("m"))}
V_CODECS = {c.name: c for c in (Fp32Codec("v"), Int8Codec("v"),
                                FactoredCodec(), RowColCodec())}
_REGISTRIES = {"m": M_CODECS, "v": V_CODECS}


def get_codec(name, moment: str = "v") -> MomentCodec:
    if isinstance(name, MomentCodec):
        return name
    reg = _REGISTRIES[moment]
    try:
        return reg[name]
    except KeyError:
        raise KeyError(f"unknown {moment}-codec {name!r}; "
                       f"available: {sorted(reg)}") from None


def codec_of(state, moment: str = "v") -> MomentCodec:
    """The codec backing an arena-backed moment state object."""
    if isinstance(state, Arena):
        return _REGISTRIES[moment]["fp32"]
    if isinstance(state, MomentState):
        return _REGISTRIES[state.moment][state.codec]
    raise TypeError(f"not an arena-backed moment: {type(state)!r}")


def is_arena_backed(state) -> bool:
    return isinstance(state, (Arena, MomentState))


def registered_combinations() -> Tuple[Tuple[str, str], ...]:
    """Every (m_codec, v_codec) pair the store supports."""
    return tuple((m, v) for m in sorted(M_CODECS) for v in sorted(V_CODECS))


# ---------------------------------------------------------------------------
# Pair-level fused ops: ONE kernel updates both moments
# ---------------------------------------------------------------------------


def _resolve_guard(guard, g, scale=1.0, decay=None):
    """A fold's guard vector: None (unguarded) stays None; True self-checks,
    a fresh vector [dm, dv, 1, scale] on g's device whose ok `finite_and`
    clears if the slab holds an Inf or a NaN, before anything commits; a
    tensor is the caller's vector, used verbatim (its scale and decay
    replace the arguments')."""
    if guard is None:
        return None
    if guard is True:
        vec = fused_step.guard_scalars(decay, True, scale, device=g.device)
        fused_step.finite_and(g, vec[2:3])
        return vec
    if decay is not None or not (isinstance(scale, (int, float))
                                 and scale == 1.0):
        raise ValueError("a guard vector carries the scale and the decay: "
                         "pass neither beside it")
    return guard


def _guarded_begin_micro(codec, parts, decay, flag):
    """begin_micro with the shared columns' decay predicated on the finite
    flag (a bool tensor, or None): a skipped micro-batch must be a bitwise
    no-op, and rowcol's column sums decay outside the kernel, so the decayed
    and original values are where-selected instead of multiplying by a
    conditional 1.0 (x*1.0 is no bitwise identity for every float)."""
    return codec.begin_micro(tuple(parts), decay, flag)


def fold(m_codec, v_codec, m_parts, v_parts, g, *, beta1, beta2, scale=1.0,
         decay=None, replicated_decay=None, grad_scale=None, guard=None):
    """Whole-arena fold of one micro-batch's gradient arena into both
    moments, in place: one fused kernel. `g` is the wire's slab (float32,
    bfloat16 upcast in the kernel, or e4m3 codes decoded in it by their
    scale column `grad_scale`). `decay=(dm, dv)` fuses the
    begin-minibatch decay into it for the row-indexed columns; the shared
    ones are decayed here first (`begin_micro`), as the reference's `fold`
    does. `replicated_decay` (host numbers or device scalars) replaces the
    shared columns' decay only: ZeRO-1 passes dv/M, so that the ranks'
    partial column sums add up to the whole arena's
    (`psum_replicated_state`). `guard` (True, or a guard vector,
    `_resolve_guard`) makes the whole fold, that decay included, a bitwise
    no-op when its ok is 0; the vector's (dm, dv) then decay the shared
    columns unless `replicated_decay` is given (True without a decay
    decays nothing, as unguarded). Returns (m_parts, v_parts), and the
    guard vector as a third item when guarded."""
    mc, vc = get_codec(m_codec, "m"), get_codec(v_codec, "v")
    vec = _resolve_guard(guard, g, scale, decay)
    if vec is not None:
        if replicated_decay is not None or decay is not None \
                or guard is not True:
            rdm, rdv = (vec[0], vec[1]) if replicated_decay is None \
                else replicated_decay
            ok = vec[2] != 0
            _guarded_begin_micro(mc, m_parts, rdm, ok)
            _guarded_begin_micro(vc, v_parts, rdv, ok)
        m, v = fused_step.arena_fold(tuple(m_parts), tuple(v_parts), g,
                                     beta1=beta1, beta2=beta2,
                                     m_codec=mc.kernel, v_codec=vc.kernel,
                                     grad_scale=grad_scale, guard=vec)
        return m, v, vec
    if decay is not None or replicated_decay is not None:
        rdm, rdv = replicated_decay or decay
        mc.begin_micro(tuple(m_parts), rdm)
        vc.begin_micro(tuple(v_parts), rdv)
    return fused_step.arena_fold(tuple(m_parts), tuple(v_parts), g,
                                 beta1=beta1, beta2=beta2, scale=scale,
                                 decay=decay, m_codec=mc.kernel,
                                 v_codec=vc.kernel, grad_scale=grad_scale)


def fold_slice(m_codec, v_codec, m_parts, v_parts, g, row_offset, *,
               beta1, beta2, block, scale=1.0, decay=None, grad_scale=None,
               guard=None):
    """Fold a gradient slab into rows [row_offset, row_offset + rows_g) of
    both moments, in place: one slice-fold kernel. Unlike `fold`, the
    shared columns are not decayed here: a micro-batch is many slice folds,
    and the engine decays them once before them (`begin_micro_state`, with
    the same flag when guarded). `grad_scale` and `guard` as in `fold`; the
    return gains the guard vector when guarded."""
    mc, vc = get_codec(m_codec, "m"), get_codec(v_codec, "v")
    vec = _resolve_guard(guard, g, scale, decay)
    kw = (dict(scale=scale, decay=decay) if vec is None
          else dict(guard=vec))
    out = fused_step.arena_fold_slice(tuple(m_parts), tuple(v_parts), g,
                                      row_offset, beta1=beta1, beta2=beta2,
                                      block=block, m_codec=mc.kernel,
                                      v_codec=vc.kernel,
                                      grad_scale=grad_scale, **kw)
    return out if vec is None else (*out, vec)


def apply(m_codec, v_codec, p, m_parts, v_parts, *, lr, bc1, bc2, eps=1e-8,
          weight_decay=0.0, work_dtype=None, work=None, guard=None):
    """Bias-corrected apply over the packed param arena, decoding both
    moments in-pass; p updated in place. `guard` (a (1,) device flag): when
    0 the params keep every byte (an all-skipped mini-batch applies
    nothing). `work_dtype` selects the master form (p the fp32 master; the
    return is (p, work), work = bf16 of the new p, written into `work` if
    given)."""
    mc, vc = get_codec(m_codec, "m"), get_codec(v_codec, "v")
    return fused_step.arena_apply(p, tuple(m_parts), tuple(v_parts), lr=lr,
                                  bc1=bc1, bc2=bc2, eps=eps,
                                  weight_decay=weight_decay,
                                  m_codec=mc.kernel, v_codec=vc.kernel,
                                  work_dtype=work_dtype, work=work,
                                  guard=guard)


# ---------------------------------------------------------------------------
# State-dict-level helpers (state = {"m": ..., "v": ..., "step": ...})
# ---------------------------------------------------------------------------


def state_codecs(state) -> Tuple[MomentCodec, MomentCodec]:
    return codec_of(state["m"], "m"), codec_of(state["v"], "v")


def has_master(state) -> bool:
    """Whether the state dict carries the fp32 master-param region
    (OptimizerConfig.master_params; see apply_master_state)."""
    return "p" in state


def fold_state(state, g, *, beta1, beta2, scale=1.0, decay=None,
               replicated_decay=None, grad_scale=None, guard=None):
    """One fused fold of a packed gradient arena into the state dict, in
    place (`grad_scale`: the e4m3 wire's scale column; `replicated_decay`:
    the shared columns' own decay, see `fold`). With `guard` the return is
    (state, guard vector) — see `fold`."""
    mc, vc = state_codecs(state)
    out = fold(mc, vc, mc.parts_of(state["m"]), vc.parts_of(state["v"]), g,
               beta1=beta1, beta2=beta2, scale=scale, decay=decay,
               replicated_decay=replicated_decay, grad_scale=grad_scale,
               guard=guard)
    return (state, out[2]) if len(out) == 3 else state


def begin_micro_state(state, decay, guard=None):
    """Decay the state dict's shared codec columns (rowcol's column sums)
    by this micro-batch's decay pair (host numbers or device scalars), in
    place, before its slice folds; nothing for row-local codecs or
    `decay=None`. `guard` (a one-element float tensor, e.g. the layer-wise
    engine's running verdict) predicates the decay: a skipped micro-batch
    leaves the shared columns bitwise."""
    if decay is not None:
        ok = None if guard is None else guard.reshape(()) != 0
        mc, vc = state_codecs(state)
        _guarded_begin_micro(mc, mc.parts_of(state["m"]), decay[0], ok)
        _guarded_begin_micro(vc, vc.parts_of(state["v"]), decay[1], ok)
    return state


def fold_slice_state(state, g, row_offset, *, beta1, beta2, block,
                     scale=1.0, decay=None, grad_scale=None, guard=None):
    """One fused slice fold of a gradient slab into rows
    [row_offset, row_offset + g.shape[0]) of the state dict, in place
    (`grad_scale`: the e4m3 wire's scale column). With `guard` the return
    is (state, guard vector)."""
    mc, vc = state_codecs(state)
    out = fold_slice(mc, vc, mc.parts_of(state["m"]),
                     vc.parts_of(state["v"]), g, row_offset, beta1=beta1,
                     beta2=beta2, block=block, scale=scale, decay=decay,
                     grad_scale=grad_scale, guard=guard)
    return (state, out[2]) if len(out) == 3 else state


def apply_state(p, state, *, lr, bc1, bc2, eps=1e-8, weight_decay=0.0,
                guard=None):
    """One fused bias-corrected apply of the state dict onto a param arena,
    p updated in place; `guard` as in `apply`."""
    mc, vc = state_codecs(state)
    return apply(mc, vc, p, mc.parts_of(state["m"]), vc.parts_of(state["v"]),
                 lr=lr, bc1=bc1, bc2=bc2, eps=eps, weight_decay=weight_decay,
                 guard=guard)


def apply_master_state(state, *, lr, bc1, bc2, eps=1e-8, weight_decay=0.0,
                       work_dtype=torch.bfloat16, guard=None):
    """Master-param apply: one fused kernel updates the fp32 master region
    state["p"] in place AND writes the `work_dtype` working params, bf16 of
    the new master, which the next forward reads. With the working-param
    cache (state["wp"]) the kernel writes straight into it, so no work
    buffer is allocated and nothing is copied. `guard` as in `apply`: when
    0 the master keeps every byte and work is still bf16(master). Returns
    (work, state): the (rows, LANES) working-param arena and the state,
    whose regions were updated in place."""
    mc, vc = state_codecs(state)
    _, work = apply(mc, vc, state["p"].data, mc.parts_of(state["m"]),
                    vc.parts_of(state["v"]), lr=lr, bc1=bc1, bc2=bc2,
                    eps=eps, weight_decay=weight_decay, work_dtype=work_dtype,
                    work=state["wp"].data if "wp" in state else None,
                    guard=guard)
    return work, state


def row_indexed_mask(state):
    """{"m": ..., "v": ...}: a bool per codec column of each moment, True
    where the column is row-indexed (it shards and slices with the arena
    rows), False for a shared accumulator (rowcol's column sums). From
    each codec's declared kernel columns, as the reference derives it."""
    mc, vc = state_codecs(state)
    return {"m": tuple(c.row_indexed for c in mc.kernel.cols),
            "v": tuple(c.row_indexed for c in vc.kernel.cols)}


def psum_replicated_state(state, group=None):
    """Sum the per-rank partials of the shared codec columns over the
    process group, in place (nothing for a row-local pair): ZeRO-1 calls
    it once a mini-batch, before the apply. Returns the state."""
    mc, vc = state_codecs(state)
    mc.psum_replicated(mc.parts_of(state["m"]), group)
    vc.psum_replicated(vc.parts_of(state["v"]), group)
    return state


def _bytes(t: torch.Tensor) -> int:
    return int(np.prod(t.shape)) * t.element_size()


def optimizer_state_bytes(state) -> int:
    """Bytes of the state's m and v columns."""
    mc, vc = state_codecs(state)
    return sum(_bytes(p)
               for p in mc.parts_of(state["m"]) + vc.parts_of(state["v"]))


def param_region_bytes(state) -> dict:
    """Bytes of the state's param regions, beside the m and v columns of
    `optimizer_state_bytes`: the fp32 master "p" and the bf16 working-param
    cache "wp", each where the state has it."""
    return {k: _bytes(state[k].data) for k in ("p", "wp") if k in state}


def wire_region_bytes(state) -> dict:
    """Bytes of the fp8 wire's error-feedback residual "ef" (an fp32
    arena), where the state has it: beside `param_region_bytes`, what the
    wire keeps on the device between steps."""
    return {"ef": _bytes(state["ef"].data)} if "ef" in state else {}
