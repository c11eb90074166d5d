"""Arena-wide fused AdamA kernels: the whole-arena m/v fold (one launch per
micro-batch), the slice fold of Algorithm 2 (one launch per layer and one
for the rest region, per micro-batch) and the bias-corrected apply (one
launch per mini-batch, in a plain and a master-param form), for every
ported (m codec, v codec) pair, each in an unguarded and a guarded form;
and `finite_and`, the finite flag that the guarded forms read.

Each function has two forms, side by side:

  arena_fold / arena_fold_slice /   the wrappers. On CUDA tensors they launch
  arena_apply                       the hand-written kernel in
                                    csrc/fused_step.cu (or raise); on CPU
                                    tensors they run the plain version.
  arena_fold_ref /                  the plain PyTorch versions: the same
  arena_fold_slice_ref /            operations in the same order, used on
  arena_apply_ref                   the CPU and as the kernels' oracle.
  finite_and / finite_and_ref       ok <- ok AND every element finite.

They replace the Pallas kernels of `repro/kernels/fused_step.py`, the
folds on the reference's three gradient wires:

  fp32        g is a float32 slab.
  bf16        g is a bfloat16 slab (core/arena.py packs it at half the
              bytes); the fold upcasts each value to float32 where it reads
              it, exactly (a bf16 value is a float32 whose low 16 bits are
              zero), and then runs the fp32 wire's arithmetic, so a fold of
              a bf16 slab equals the fp32 fold of the same slab upcast on
              the host bit for bit (the reference's `_fold_body`:
              `g.astype(float32) * s`). `grad_dtype=` declares the wire the
              caller packed; a slab of another dtype raises TypeError.
  e4m3        g is a float8_e4m3fn slab of codes and `grad_scale` its
              (rows_g, 1) float32 scale column (kernels/fp8_wire.py encodes
              both); the fold widens each code exactly and decodes it in
              the reference's order, (code * s) * grad_scale[row], and then
              runs the fp32 wire's arithmetic. Codes and their scale come
              in a pair: either one alone raises TypeError, as in the
              reference.

The apply has a master-param form (`work_dtype=torch.bfloat16`, the
reference's `emit_work`): p is the fp32 MASTER region, updated in place,
and the same pass writes `work`, a (rows, LANES) bfloat16 arena of the new
master rounded to nearest even (torch's and XLA's cast): the working params
the next forward reads. The caller may pass the buffer (the engines' bf16
working-param cache), or the wrapper allocates it.

Every form comes unguarded and guarded:

  unguarded   host scalars: the static scale and the decay pair.
  guarded     `guard=`: a device float32 vector [dm, dv, ok, scale] for a
              fold (`guard_scalars`, the reference's SMEM `_guard_scalars`),
              [ok] for the apply. The scale is traced (any device value),
              and with ok == 0 the call is a bitwise no-op on every state
              column, rowcol's column sums included, and on p (the
              reference's `_GuardedRef` and the apply's `where`, which also
              drop the NaNs of a bc1 = 0 apply); the master form then still
              writes work = bf16(p) of the unchanged p. The engines fill the
              vector on the device and AND the finite flag into its ok
              with `finite_and`, so no flag is read on the host.

The state (fold) and p (apply) are updated IN PLACE, where the reference
aliases input to output; in place, the kernels' ok == 0 is an early return
and the plain versions' a `where` against the old values.

A codec is data (`KernelCodec`, as in the reference): the arena columns
its moment rides in and its number in the CUDA source, plus the plain
decode and update that the plain versions run. A moment is a bare tensor
for fp32 and a tuple of columns otherwise:

  fp32      (rows, LANES) float32
  int8      (rows, LANES) int8 codes + (rows, 1) float32 row scales; m
            truncates toward zero over [-127, 127], v takes the ceiling
            over [0, 127] (adama_accum.q8s_encode_rows / q8_encode_rows)
  factored  (v only) (rows, 1) float32: the row max of g^2, decayed
  rowcol    (v only) (rows, 1) float32 row sums of g^2 + one (1, LANES)
            float32 block of column sums (Adafactor's marginals), decoded
            as vr * (vc / max(sum(vc), 1e-30))

Every column but rowcol's column sums is row-indexed. The column sums are
the one column shared by every row (`Col.row_indexed=False`, shape
(1, LANES)): every fold and slice fold adds its rows' (scale*g)^2 column
sums into it, and its decay is the caller's, once per micro-batch
(core/state_store.py), so the kernels' `decay` leaves it alone. A CUDA
block cannot carry a sum to the next as a TPU grid step does, so the
kernel cuts the rows into ranges fixed by the row count alone
(`rowcol_partition`), sums each range in a fixed order and adds the
ranges' sums in order; the plain versions take the same partition and the
same trees (`_rowcol_row_sums`, `_rowcol_col_sums`), never `torch.sum`.
Kernel and plain version therefore agree bit for bit; both differ from the
reference, whose sums take XLA's own order, by a few float32 roundings
(tests/test_torch_codecs.py states the tolerance).

Scalars are rounded to float32 on the host the way JAX's weak-typed Python
floats are: `1 - beta1` is formed in double and then rounded (0.1f for
beta1=0.9, where `1.0f - 0.9f` would give 0.10000002).

The reference's CPU lowering (XLA) contracts some multiply-add pairs into
fused multiply-adds, and which operand it fuses depends on the codec:

  fp32 moment    d*m + c*x          as fma(d, m, c*x)
  int8 m         d*(q*s) + c*x      as fma(c, x, d*(q*s)); on the e4m3
                                    wire as fma(d, q*s, c*x)
  int8 v         d*(q*s) + c*x      as fma(d, q*s, c*x)
  factored v     d*f + c*max(x)     as fma(d, f, c*max(x))
  rowcol v       d*vr + c*sum(x)    as fma(d, vr, c*sum(x))
                 vc + c*sum(x)      as fma(c, sum(x), vc)
  apply          p - lr*u           as fma(-lr, u, p)
                 u + wd*p           as fma(wd, p, u)
                 (m/bc1) / (sqrt(v/bc2) + eps)
                                    as m / (bc1*(sqrt(v/bc2) + eps))

with x = scale*g for m and (scale*g)^2 for v. The kernels spell out the
same operations; the plain versions compute each fused multiply-add
exactly with `_fma32`. XLA CPU also reads subnormal operands as zero and
flushes subnormal results to zero. Every pair but fp32/fp32 does the same,
explicitly, after every operation (`adama_accum.ftz`); the fp32/fp32 pair
keeps IEEE subnormals (`_flush`). Kernel, plain version and reference
therefore agree bit for bit (fp32/fp32 only where no value falls below
2^-126).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.adama_accum import (_f32, _fma32, _sqrt32,
                                             fac_row_stat, ftz, halving_sum,
                                             q8_decode_rows, q8_encode_rows,
                                             q8s_encode_rows, rowcol_decode)

LANES = 1024          # arena row width (the reference's 8 x 128 lanes)
BLOCK_ROWS = 256      # arena row-count granularity above 256 rows

# rows per step of the plain versions: bounds their float64 temporaries on
# a full-size arena (results do not depend on it)
_PLAIN_CHUNK_ROWS = 16384
# rows per step of rowcol's plain column sums (whole ranges; results do not
# depend on it either)
_PLAIN_COL_ROWS = 1 << 17

# rowcol's row partition: at most RC_MAX_RANGES ranges (so the fold's
# (ranges, LANES) fp32 scratch stays within 3 MiB), of at least
# RC_MIN_RANGE_ROWS rows; RC_WARPS warps fold a range, warp w taking its
# rows w, w + RC_WARPS, ... (csrc/fused_step.cu, rowcol_fold_kernel)
RC_MAX_RANGES = 768
RC_MIN_RANGE_ROWS = 64
RC_WARPS = 8


# ---------------------------------------------------------------------------
# Codec descriptors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    """One arena column of a codec's state: (rows, width) when
    `row_indexed`, else one (1, width) block shared by every row (rowcol's
    column sums)."""
    width: int
    dtype: torch.dtype
    row_indexed: bool = True


@dataclass(frozen=True)
class KernelCodec:
    """What a codec contributes to the fused kernels: its columns, its
    number in csrc/fused_step.cu (`kind`), and the plain decode and update
    of the codec forms."""
    name: str
    cols: Tuple[Col, ...]
    kind: int
    # decode(parts, fl) -> float32, broadcastable to (rows, LANES)
    decode: Callable = field(repr=False)
    # update(parts, x, decay, coeff, fl) -> new row-indexed parts, over a
    # chunk of rows: decay*moment + coeff*x; `fl` is the pair's flush
    # (`_flush`)
    update: Callable = field(repr=False)
    # fold_columns(parts, g, scale, coeff, ok, gs): adds coeff * the column
    # sums of x^2 over all of g's rows into the shared columns, in place
    # (where the bool tensor ok holds, if given), x being g decoded and
    # scaled (`_scaled_g`; gs: the e4m3 wire's scale column); None for a
    # codec whose columns are all row-indexed
    fold_columns: Optional[Callable] = field(default=None, repr=False)
    # the update on the e4m3 wire, where the reference contracts the fold
    # otherwise (int8 m); None: `update`
    e4m3_update: Optional[Callable] = field(default=None, repr=False)


def _ieee(x):
    return x


def _flush(mk: KernelCodec, vk: KernelCodec):
    """The pair's subnormal handling: XLA CPU's flush (`ftz`) for every
    pair but fp32/fp32, which keeps IEEE subnormals."""
    return _ieee if mk.kind == vk.kind == 0 else ftz


def _fp32_decode(parts, fl):
    return fl(parts[0])


def _fp32_update(parts, x, decay, coeff, fl):
    return (fl(_fma32(decay, fl(parts[0]), fl(coeff * x))),)


# the int8 and factored codecs only ride in flushing pairs (fl is ftz)
def _q8_decode(parts, fl):
    return q8_decode_rows(parts[0], parts[1])


def _q8u_update(parts, x, decay, coeff, fl):
    return q8_encode_rows(
        ftz(_fma32(decay, _q8_decode(parts, fl), ftz(coeff * x))))


def _q8s_update(parts, x, decay, coeff, fl):
    return q8s_encode_rows(
        ftz(_fma32(coeff, x, ftz(decay * _q8_decode(parts, fl)))))


def _q8s_update_e4m3(parts, x, decay, coeff, fl):
    # on the e4m3 wire XLA CPU contracts int8 m's fold as it does int8 v's
    return q8s_encode_rows(
        ftz(_fma32(decay, _q8_decode(parts, fl), ftz(coeff * x))))


def _fac_update(parts, x, decay, coeff, fl):
    return (ftz(_fma32(decay, ftz(parts[0]), ftz(coeff * fac_row_stat(x)))),)


def _rowcol_decode(parts, fl):
    return rowcol_decode(parts[0], parts[1])


def _rowcol_update(parts, x, decay, coeff, fl):
    # the row sums; the shared column sums are _rowcol_fold_columns'
    return (ftz(_fma32(decay, ftz(parts[0]),
                       ftz(coeff * _rowcol_row_sums(x)))),)


def _rowcol_fold_columns(parts, g, s, coeff, ok=None, gs=None):
    vc = parts[1]
    _write((vc,), (ftz(_fma32(coeff, _rowcol_col_sums(g, s, ftz, gs),
                              ftz(vc))),), ok)


def rowcol_partition(rows: int) -> Tuple[int, int]:
    """(ranges, range_rows) of rowcol's fold over `rows` rows: range p is
    rows [p * range_rows, min((p + 1) * range_rows, rows)). A function of
    the row count alone, so the sums' order is the same on every card and
    in the plain version."""
    range_rows = max(RC_MIN_RANGE_ROWS, -(-rows // RC_MAX_RANGES))
    return -(-rows // range_rows), range_rows


def _rowcol_row_sums(x):
    """(n, LANES) -> (n, 1) row sums in the kernel's order: the lane's 32
    values (value j = 4k + e of lane l at column 4 * (32k + l) + e) in a
    halving tree, then the 32 lanes in a halving tree (shuffles down)."""
    n = x.shape[0]
    t = x.reshape(n, 8, 32, 4).permute(0, 2, 1, 3).reshape(n, 32, 32)
    return halving_sum(halving_sum(t, 2), 1).reshape(n, 1)


def _scaled_g(g, s, gs, fl):
    """The fold's x = s*g of slab rows `g` as float32: a bf16 slab upcast
    first; e4m3 codes widened and decoded in the reference's order,
    (code * s) * gs (gs: their rows of the scale column, else None)."""
    x = fl(fl(g.float()) * s)
    return x if gs is None else fl(x * fl(gs))


def _rowcol_col_sums(g, s, fl, gs=None):
    """(1, LANES) column sums of fl(x^2), x = `_scaled_g`, in the kernel's
    order:
    per range, warp w adds rows w, w + 8, ... one after another, the 8
    warps meet in a halving tree, and the ranges' sums are added in
    order."""
    rows = g.shape[0]
    ranges, rr = rowcol_partition(rows)
    steps = -(-rr // RC_WARPS)
    group = max(1, _PLAIN_COL_ROWS // rr)
    partials = []
    for p0 in range(0, ranges, group):
        n = min(ranges, p0 + group) - p0
        lo, hi = p0 * rr, min((p0 + n) * rr, rows)
        x = _scaled_g(g[lo:hi], s, None if gs is None else gs[lo:hi], fl)
        xp = x.new_zeros((n * rr, LANES))        # zero rows add exactly 0
        xp[:hi - lo] = fl(x * x)
        xp = torch.nn.functional.pad(xp.view(n, rr, LANES),
                                     (0, 0, 0, steps * RC_WARPS - rr))
        xp = xp.view(n, steps, RC_WARPS, LANES)
        acc = xp[:, 0]
        for k in range(1, steps):
            acc = fl(acc + xp[:, k])
        partials.append(halving_sum(acc, 1).view(n, LANES))
    partials = torch.cat(partials)
    total = partials[0]
    for p in range(1, ranges):
        total = fl(total + partials[p])
    return total.view(1, LANES)


_F32_COLS = (Col(LANES, torch.float32),)
_Q8_COLS = (Col(LANES, torch.int8), Col(1, torch.float32))
_KERNEL_CODECS = {
    "m": {
        "fp32": KernelCodec("fp32", _F32_COLS, 0, _fp32_decode, _fp32_update),
        "int8": KernelCodec("int8", _Q8_COLS, 1, _q8_decode, _q8s_update,
                            e4m3_update=_q8s_update_e4m3),
    },
    "v": {
        "fp32": KernelCodec("fp32", _F32_COLS, 0, _fp32_decode, _fp32_update),
        "int8": KernelCodec("int8", _Q8_COLS, 1, _q8_decode, _q8u_update),
        "factored": KernelCodec("factored", (Col(1, torch.float32),), 2,
                                _fp32_decode, _fac_update),
        "rowcol": KernelCodec("rowcol",
                              (Col(1, torch.float32),
                               Col(LANES, torch.float32, row_indexed=False)),
                              3, _rowcol_decode, _rowcol_update,
                              _rowcol_fold_columns),
    },
}


def kernel_codec(moment: str, name) -> KernelCodec:
    """Resolve a kernel codec by (moment, name); KernelCodec passes
    through."""
    if isinstance(name, KernelCodec):
        return name
    try:
        return _KERNEL_CODECS[moment][name]
    except KeyError:
        raise KeyError(f"unknown {moment}-codec kernel {name!r}; available: "
                       f"{sorted(_KERNEL_CODECS[moment])}") from None


def _as_parts(x):
    """A moment as a column tuple, and whether it came bare (fp32)."""
    if isinstance(x, (tuple, list)):
        return tuple(x), False
    return (x,), True


def _check_parts(fn: str, parts, kc: KernelCodec, rows: int, device) -> None:
    """A codec's columns: their count, shapes ((rows, width), or (1, width)
    for a shared column), dtypes, contiguity and device (16-byte aligned on
    CUDA)."""
    if len(parts) != len(kc.cols):
        raise ValueError(f"{fn}: {kc.name} takes {len(kc.cols)} columns, "
                         f"got {len(parts)}")
    for p, c in zip(parts, kc.cols):
        if p.dtype != c.dtype:
            raise TypeError(f"{fn}: {kc.name} column must be {c.dtype}, "
                            f"got {p.dtype}")
        want = (rows if c.row_indexed else 1, c.width)
        if tuple(p.shape) != want:
            raise ValueError(f"{fn}: {kc.name} column must be {want}, got "
                             f"{tuple(p.shape)}")
        if not p.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
        if p.device != device:
            raise ValueError(f"{fn}: operands on {p.device} and {device}")
        if p.device.type == "cuda" and p.data_ptr() % 16:
            raise ValueError(f"{fn}: CUDA operands must be 16-byte aligned")


# the gradient wires the folds take (the reference's GRAD_WIRE_DTYPES),
# each dtype's number in csrc/fused_step.cu
WIRES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_grad_dtype(fn: str, g: torch.Tensor, grad_dtype,
                      grad_scale=None) -> None:
    """The reference's `_check_grad_dtype`, with its messages: a declared
    wire (`grad_dtype`, a torch dtype; None infers it from the slab) must
    be the slab's, the slab's dtype one of WIRES, and an e4m3 slab and a
    `grad_scale` column come in a pair, the column (rows_g, 1) float32; on
    the operands' device and contiguous besides, for the kernel."""
    if grad_dtype is not None and g.dtype != grad_dtype:
        raise TypeError(f"{fn}: gradient slab dtype {g.dtype} != declared "
                        f"grad_dtype {grad_dtype}")
    if g.dtype not in WIRES:
        raise TypeError(f"{fn}: unsupported gradient wire dtype {g.dtype}; "
                        f"expected one of {tuple(WIRES)}")
    is_fp8 = g.dtype == torch.float8_e4m3fn
    if is_fp8 and grad_scale is None:
        raise TypeError(f"{fn}: fp8 gradient slab requires its per-row "
                        f"grad_scale column (see "
                        f"kernels/adama_accum.fp8_encode_rows); codes without "
                        f"the scale would fold garbage")
    if grad_scale is None:
        return
    if not is_fp8:
        raise TypeError(f"{fn}: grad_scale column passed with a "
                        f"{_dtype_name(g.dtype)} slab; the scale column pairs "
                        f"only with an fp8 (float8_e4m3fn) wire")
    if (tuple(grad_scale.shape) != (g.shape[0], 1)
            or grad_scale.dtype != torch.float32):
        raise TypeError(f"{fn}: grad_scale must be ({g.shape[0]}, 1) fp32, "
                        f"got {tuple(grad_scale.shape)} "
                        f"{_dtype_name(grad_scale.dtype)}")
    if not grad_scale.is_contiguous() or grad_scale.device != g.device:
        raise ValueError(f"{fn}: grad_scale must be contiguous, on "
                         f"{g.device}")


def _check_lead(fn: str, t: torch.Tensor, wire: bool = False) -> None:
    """g (or p, for the apply): fp32 (g: a dtype of WIRES), (rows, LANES),
    contiguous, on the CPU or CUDA (16-byte aligned there, for vector
    access)."""
    if t.dtype not in (WIRES if wire else (torch.float32,)):
        raise TypeError(f"{fn}: expected float32 operands, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != LANES:
        raise ValueError(f"{fn}: expected (rows, {LANES}) operands, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: operands must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{fn}: CUDA operands must be 16-byte aligned")


def _check_state(fn, mk, vk, m_parts, v_parts, lead, rows,
                 wire: bool = False) -> None:
    """`lead` (g, or p for the apply), then the m and v columns over
    `rows` arena rows on its device. `wire`: lead is a fold's g, whose
    dtype `_check_grad_dtype` has checked."""
    _check_lead(fn, lead, wire)
    _check_parts(fn, m_parts, mk, rows, lead.device)
    _check_parts(fn, v_parts, vk, rows, lead.device)


_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
# C signatures of the launchers in csrc/fused_step.cu: the two codecs'
# kinds, two column pointers per moment (the second NULL for a one-column
# codec), ..., the CUDA stream. arena_fold_launch serves the whole-arena
# fold (row offset 0) and the slice fold; g's pointer is followed by its
# wire (WIRES); its (ranges, range_rows, scratch) serve rowcol's column
# sums (0, 0, NULL for the other codecs). arena_apply_launch takes p and
# then the master form's bf16 work arena (NULL for the plain form) before
# the moments' columns. A guarded
# launcher takes the unguarded one's arguments and then the guard's
# pointer. The e4m3 wire's launchers (`_e4m3` in the name) take the
# fp32/bf16 ones' arguments and then grad_scale's pointer (before the
# guard's). finite_and_launch: x, its element bytes, (head, n16, tail) of
# `_finite_split`, ok, the stream.
_FOLD_ARGS = (_I, _I, _P, _P, _P, _P, _P, _I, _I64, _I64, _I64, _I64, _P, _F,
              _F, _F, _F, _F)
_APPLY_ARGS = (_I, _I, _P, _P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _F)
SIGNATURES = {
    "arena_fold_launch": _FOLD_ARGS + (_P,),
    "arena_apply_launch": _APPLY_ARGS + (_P,),
    "arena_fold_guarded_launch": _FOLD_ARGS + (_P, _P),
    "arena_apply_guarded_launch": _APPLY_ARGS + (_P, _P),
    "arena_fold_e4m3_launch": _FOLD_ARGS + (_P, _P),
    "arena_fold_e4m3_guarded_launch": _FOLD_ARGS + (_P, _P, _P),
    "finite_and_launch": (_P, _I, _I64, _I64, _I64, _P, _P),
    "fold_exactness_launch": (_I, _P, _P),
}


def _lib() -> ctypes.CDLL:
    return build.bind("fused_step", SIGNATURES)


# fold_exactness_launch's checks, in the order of csrc/fused_step.cu's XCheck.
# EXACTNESS_USED: the substitutions the int8-m rowcol fold makes, each of
# which must equal the expression it replaces on every input checked. "mul"
# and "fma" count where the card's own flush of a product and of an fma
# (mul.rn.ftz, fma.rn.ftz) parts from fl of the IEEE result, which is why
# the kernel rounds those IEEE and flushes after (csrc/fused_step.cu).
EXACTNESS_CHECKS = ("decode", "flush", "add", "square", "mul", "fma", "quot")
EXACTNESS_USED = ("decode", "flush", "add", "square", "quot")


def fold_exactness(check: str, device="cuda") -> dict:
    """Run one of the card's checks of the rowcol fold's int8-m
    substitutions (EXACTNESS_CHECKS; csrc/fused_step.cu says what each
    holds against what, over which inputs): the kernel's instruction
    sequence and the expression it stands for, computed side by side on the
    card for every input of the check. Returns the number of results compared, how
    many differ, how many NaN results differ only in their payload, and the
    least input index that differs (None if none does). CUDA only."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("fold_exactness runs on the card only")
    counts = torch.tensor([0, 0, 0, -1], dtype=torch.int64, device=device)
    build.launch("fold_exactness", _lib().fold_exactness_launch, counts,
                 EXACTNESS_CHECKS.index(check), counts.data_ptr())
    compared, differ, nan_payload, first = counts.tolist()
    return {"check": check, "compared": compared, "differing": differ,
            "nan_payloads_differing": nan_payload,
            "first_differing_index": first if differ else None}


def _ptrs(parts):
    return tuple(p.data_ptr() for p in parts) + (None,) * (2 - len(parts))


def _rows(kc: KernelCodec, parts, lo: int, hi: int):
    """Rows [lo, hi) of a codec's row-indexed columns; a shared column
    whole."""
    return tuple(p[lo:hi] if c.row_indexed else p
                 for p, c in zip(parts, kc.cols))


def _write(parts, new, ok=None) -> None:
    """parts <- new, in place; where the bool tensor `ok` holds, if given
    (the guarded forms' predicated write: where() selects, so a NaN of the
    discarded side never reaches the state)."""
    for p, x in zip(parts, new):
        p.copy_(x if ok is None else torch.where(ok, x, p))


def _scalars_on(device, *xs):
    """Host scalars as float32 tensors on `device` (torch on CUDA divides
    by a host scalar as a multiply by its reciprocal)."""
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in xs)


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------


def guard_scalars(decay=None, ok=True, scale=1.0, *, device):
    """A fold's guard vector [dm, dv, ok, scale] (float32, on `device`) from
    host values, the reference's `_guard_scalars`: ok is 1.0 or 0.0, the
    numbers round to float32 as JAX's weak-typed floats do. The engines
    build theirs on the device instead, so that no call copies from the
    host."""
    dm, dv = (1.0, 1.0) if decay is None else decay
    return torch.tensor([_f32(dm), _f32(dv), 1.0 if ok else 0.0,
                         _f32(scale)], dtype=torch.float32, device=device)


def _check_guard(fn: str, guard, n: int, device, scale=1.0,
                 decay=None) -> None:
    """A guard: a contiguous float32 (n,) tensor on the operands' device
    (4n-byte aligned on CUDA). A fold's scale and decay ride in its guard
    vector, so they must be left unset beside one."""
    if not isinstance(guard, torch.Tensor):
        raise TypeError(f"{fn}: guard must be a float32 tensor, got "
                        f"{type(guard).__name__}")
    if guard.dtype != torch.float32 or tuple(guard.shape) != (n,):
        raise ValueError(f"{fn}: guard must be a ({n},) float32 tensor, got "
                         f"{tuple(guard.shape)} {guard.dtype}")
    if not guard.is_contiguous() or guard.device != device:
        raise ValueError(f"{fn}: guard must be contiguous, on {device}")
    if guard.device.type == "cuda" and guard.data_ptr() % (4 * n):
        raise ValueError(f"{fn}: a CUDA guard must be {4 * n}-byte "
                         f"aligned")
    if decay is not None or not (isinstance(scale, (int, float))
                                 and scale == 1.0):
        raise ValueError(f"{fn}: with guard=, the scale and the decay ride "
                         f"in the guard vector [dm, dv, ok, scale]")


def _launch(fn: str, launcher: str, lead, args, guard) -> None:
    """Launch `launcher` (unguarded) or its guarded twin with the guard's
    pointer after `args`."""
    lib = _lib()
    if guard is None:
        build.launch(fn, getattr(lib, launcher), lead, *args)
    else:
        build.launch(fn, getattr(lib, launcher.replace(
            "_launch", "_guarded_launch")), lead, *args, guard.data_ptr())


def finite_and_ref(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Plain version of `finite_and`."""
    ok.copy_(torch.where(torch.isfinite(x).all(), ok, torch.zeros_like(ok)))
    return ok


def _finite_split(x: torch.Tensor) -> Tuple[int, int, int]:
    """(head, n16, tail) of finite_and_launch: the elements before x's
    first 16-byte boundary, the 16-byte words after it, the elements
    left."""
    n, b = x.numel(), x.element_size()
    head = min(n, (-x.data_ptr() % 16) // b)
    n16 = (n - head) * b // 16
    return head, n16, n - head - n16 * 16 // b


def finite_and(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """ok <- ok AND (every element of x is finite), in place: one pass over
    a contiguous float32 or bfloat16 tensor. `ok` is a one-element float32
    tensor on x's device (1.0 or 0.0; a guard vector's ok slot, `vec[2:3]`,
    or the apply's guard). Returns ok. The reference computes this flag
    with `jnp.isfinite(g).all()`; the kernel reads x once and allocates
    nothing."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"finite_and: expected float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("finite_and: x must be contiguous")
    if (ok.dtype != torch.float32 or ok.numel() != 1
            or ok.device != x.device):
        raise ValueError(f"finite_and: ok must be one float32 element on "
                         f"{x.device}, got {tuple(ok.shape)} {ok.dtype} on "
                         f"{ok.device}")
    if x.device.type == "cpu":
        return finite_and_ref(x, ok)
    if x.device.type != "cuda":
        raise ValueError(f"finite_and: unsupported device {x.device}")
    if x.numel():
        build.launch("finite_and", _lib().finite_and_launch, x,
                     x.data_ptr(), x.element_size(), *_finite_split(x),
                     ok.data_ptr())
        finite_and.launches += 1
    return ok


finite_and.launches = 0


def _guard_values(g, guard, beta1, beta2, scale, decay):
    """The plain versions' scalars as float32 tensors on g's device: (s,
    c1, c2, dm, dv, ok), ok a bool tensor or None; a guard vector supplies
    s, dm, dv and ok."""
    s, c1, c2, dm, dv = _scalars_on(g.device, *_fold_scalars(
        beta1, beta2, scale, decay))
    if guard is None:
        return s, c1, c2, dm, dv, None
    dm, dv, ok, s = guard.unbind(0)
    return s, c1, c2, dm, dv, ok != 0


# ---------------------------------------------------------------------------
# Fold
# ---------------------------------------------------------------------------


def _fold_scalars(beta1, beta2, scale, decay):
    dm, dv = (1.0, 1.0) if decay is None else decay
    return (_f32(scale), _f32(1.0 - beta1), _f32(1.0 - beta2), _f32(dm),
            _f32(dv))


def fold_scratch(vk: KernelCodec, rows_g: int, device):
    """(ranges, range_rows, scratch) for a fold of rows_g rows: for
    rowcol, its partition and a (ranges * LANES + 4)-float fp32 buffer
    (the ranges' column sums, then the kernel's ticket; at most
    RC_MAX_RANGES * 4 KiB + 16 B, 3,145,744 B); (0, 0, None) otherwise."""
    if vk.fold_columns is None:
        return 0, 0, None
    ranges, range_rows = rowcol_partition(rows_g)
    return ranges, range_rows, torch.empty(ranges * LANES + 4,
                                           dtype=torch.float32, device=device)


def fold_args(mk, vk, m_parts, v_parts, g, row_offset, beta1, beta2,
              scale, decay, scratch=(0, 0, None), grad_scale=None):
    """Arguments of arena_fold_launch, the stream excepted; with the e4m3
    wire's `grad_scale`, of arena_fold_e4m3_launch (its pointer last).
    `scratch` is fold_scratch's triple."""
    ranges, range_rows, buf = scratch
    gs = () if grad_scale is None else (grad_scale.data_ptr(),)
    return (mk.kind, vk.kind, *_ptrs(m_parts), *_ptrs(v_parts), g.data_ptr(),
            WIRES[g.dtype], row_offset, g.shape[0], ranges, range_rows,
            None if buf is None else buf.data_ptr(),
            *_fold_scalars(beta1, beta2, scale, decay), *gs)


def _fold_launcher(grad_scale) -> str:
    return "arena_fold_launch" if grad_scale is None else \
        "arena_fold_e4m3_launch"


def arena_fold_ref(m, v, g, *, beta1: float, beta2: float, scale=1.0,
                   decay=None, m_codec="fp32", v_codec="fp32",
                   grad_scale=None, guard=None):
    """Plain version of `arena_fold` (same operations, same order; guarded,
    every write where-predicated on ok). A bf16 `g` is upcast first, then
    scaled; e4m3 codes are scaled and then decoded by `grad_scale`, as the
    kernel and the reference's `_fold_body` do (`_scaled_g`)."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, _), (v_parts, _) = _as_parts(m), _as_parts(v)
    s, c1, c2, dm, dv, ok = _guard_values(g, guard, beta1, beta2, scale,
                                          decay)
    fl = _flush(mk, vk)
    m_update = mk.update if grad_scale is None or mk.e4m3_update is None \
        else mk.e4m3_update
    for lo in range(0, g.shape[0], _PLAIN_CHUNK_ROWS):
        hi = lo + _PLAIN_CHUNK_ROWS
        x = _scaled_g(g[lo:hi], s, None if grad_scale is None
                      else grad_scale[lo:hi], fl)
        mp, vp = _rows(mk, m_parts, lo, hi), _rows(vk, v_parts, lo, hi)
        _write(mp, m_update(mp, x, dm, c1, fl), ok)
        _write(vp, vk.update(vp, fl(x * x), dv, c2, fl), ok)
    if vk.fold_columns is not None:
        vk.fold_columns(v_parts, g, s, c2, ok, grad_scale)
    return m, v


def arena_fold(m, v, g, *, beta1: float, beta2: float, scale=1.0,
               decay=None, m_codec="fp32", v_codec="fp32", grad_dtype=None,
               grad_scale=None, guard=None):
    """Fold one micro-batch's packed gradient `g` into both moments, in
    place: m = dm*m + (1-beta1)*(scale*g), v = dv*v + (1-beta2)*(scale*g)^2,
    each in its codec's space. `m`/`v` are the codecs' column tuples (bare
    tensors for fp32). `g` is a float32 or bfloat16 wire slab (bf16 is
    upcast in the kernel), or float8_e4m3fn codes with their (rows, 1)
    float32 scale column `grad_scale` (decoded in the kernel);
    `grad_dtype`, if given, is the wire the caller declares, checked
    against g's dtype. `decay=(dm, dv)` fuses the
    begin-minibatch decay into this fold for the row-indexed columns (pass
    (beta1, beta2) on the first micro-batch); None means (1, 1). A shared
    column (rowcol's column sums) is decayed by the caller. `guard` (the
    guarded form): the device vector [dm, dv, ok, scale] (`guard_scalars`)
    in place of `scale` and `decay`; with ok == 0 nothing is written.
    Returns (m, v)."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, _), (v_parts, _) = _as_parts(m), _as_parts(v)
    _check_grad_dtype("arena_fold", g, grad_dtype, grad_scale)
    _check_state("arena_fold", mk, vk, m_parts, v_parts, g, g.shape[0],
                 wire=True)
    if guard is not None:
        _check_guard("arena_fold", guard, 4, g.device, scale, decay)
    if g.device.type == "cpu":
        return arena_fold_ref(m, v, g, beta1=beta1, beta2=beta2, scale=scale,
                              decay=decay, m_codec=mk, v_codec=vk,
                              grad_scale=grad_scale, guard=guard)
    _launch("arena_fold", _fold_launcher(grad_scale), g,
            fold_args(mk, vk, m_parts, v_parts, g, 0, beta1, beta2, scale,
                      decay, fold_scratch(vk, g.shape[0], g.device),
                      grad_scale), guard)
    arena_fold.launches += 1
    return m, v


arena_fold.launches = 0


def _check_slice(mk, vk, m_parts, v_parts, g, row_offset: int,
                 block: int, grad_dtype=None, grad_scale=None) -> None:
    """The reference's checks (fused_step.py::arena_fold_slice): g's wire,
    whole blocks of rows, a block-aligned offset, and the slice inside the
    arena."""
    rows = m_parts[0].shape[0]
    _check_grad_dtype("arena_fold_slice", g, grad_dtype, grad_scale)
    _check_state("arena_fold_slice", mk, vk, m_parts, v_parts, g, rows,
                 wire=True)
    rows_g = g.shape[0]
    if block < 1 or rows_g % block or row_offset % block:
        raise ValueError(f"arena_fold_slice: slab rows {rows_g} and row "
                         f"offset {row_offset} must be multiples of the "
                         f"block {block}")
    if row_offset < 0 or row_offset + rows_g > rows:
        raise ValueError(f"arena_fold_slice: rows [{row_offset}, "
                         f"{row_offset + rows_g}) lie outside the arena's "
                         f"{rows} rows")


def arena_fold_slice_ref(m, v, g, row_offset: int, *, beta1: float,
                         beta2: float, block: int, scale=1.0, decay=None,
                         m_codec="fp32", v_codec="fp32", grad_scale=None,
                         guard=None):
    """Plain version of `arena_fold_slice`: `arena_fold_ref` on the rows
    of the slice (views of every column). `block` is checked by the
    wrapper."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, m_bare), (v_parts, v_bare) = _as_parts(m), _as_parts(v)
    hi = row_offset + g.shape[0]
    ms = _rows(mk, m_parts, row_offset, hi)
    vs = _rows(vk, v_parts, row_offset, hi)
    arena_fold_ref(ms[0] if m_bare else ms, vs[0] if v_bare else vs, g,
                   beta1=beta1, beta2=beta2, scale=scale, decay=decay,
                   m_codec=mk, v_codec=vk, grad_scale=grad_scale, guard=guard)
    return m, v


def arena_fold_slice(m, v, g, row_offset: int, *, beta1: float, beta2: float,
                     block: int, scale=1.0, decay=None, m_codec="fp32",
                     v_codec="fp32", grad_dtype=None, grad_scale=None,
                     guard=None):
    """Fold a (rows_g, LANES) gradient slab into arena rows
    [row_offset, row_offset + rows_g) of both moments, in place, with the
    arena_fold arithmetic; every other row is left untouched. `block` is
    the layout's `slice_block` for the region: rows_g and row_offset must
    be multiples of it. `g`'s wire, `grad_dtype`, `grad_scale` and `guard`
    as in arena_fold. Returns (m, v)."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, _), (v_parts, _) = _as_parts(m), _as_parts(v)
    _check_slice(mk, vk, m_parts, v_parts, g, row_offset, block, grad_dtype,
                 grad_scale)
    if guard is not None:
        _check_guard("arena_fold_slice", guard, 4, g.device, scale, decay)
    if g.device.type == "cpu":
        return arena_fold_slice_ref(m, v, g, row_offset, beta1=beta1,
                                    beta2=beta2, block=block, scale=scale,
                                    decay=decay, m_codec=mk, v_codec=vk,
                                    grad_scale=grad_scale, guard=guard)
    _launch("arena_fold_slice", _fold_launcher(grad_scale), g,
            fold_args(mk, vk, m_parts, v_parts, g, row_offset, beta1, beta2,
                      scale, decay, fold_scratch(vk, g.shape[0], g.device),
                      grad_scale), guard)
    arena_fold_slice.launches += 1
    return m, v


arena_fold_slice.launches = 0


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _apply_scalars(lr, bc1, bc2, eps, weight_decay):
    return (_f32(lr), _f32(bc1), _f32(bc2), _f32(eps), _f32(weight_decay))


def apply_args(mk, vk, p, m_parts, v_parts, lr, bc1, bc2, eps,
               weight_decay, work=None):
    """Arguments of arena_apply_launch, the stream excepted; `work` is the
    master form's bf16 output (None: the plain form, a NULL pointer)."""
    return (mk.kind, vk.kind, p.data_ptr(),
            None if work is None else work.data_ptr(), *_ptrs(m_parts),
            *_ptrs(v_parts), p.shape[0],
            *_apply_scalars(lr, bc1, bc2, eps, weight_decay))


def _work_buffer(fn: str, p: torch.Tensor, work_dtype, work):
    """The master form's output: None for the plain form (then `work` must
    be None too); else the caller's `work`, checked (bfloat16, the kernel's
    store; p's shape, contiguous, on p's device, 16-byte aligned on CUDA),
    or a new torch.empty one. p must be the fp32 master (the reference's
    assertion, made before any other check)."""
    if work_dtype is None:
        if work is not None:
            raise ValueError(f"{fn}: work= is the master form's output; pass "
                             f"work_dtype=torch.bfloat16 with it")
        return None
    if p.dtype != torch.float32:
        raise TypeError(f"master-param apply requires an fp32 master region, "
                        f"got {p.dtype}")
    if work_dtype != torch.bfloat16:
        raise TypeError(f"{fn}: work_dtype must be torch.bfloat16, got "
                        f"{work_dtype}")
    if work is None:
        return torch.empty(p.shape, dtype=work_dtype, device=p.device)
    if work.dtype != work_dtype or work.shape != p.shape:
        raise ValueError(f"{fn}: work must be a {tuple(p.shape)} "
                         f"{work_dtype} tensor, got {tuple(work.shape)} "
                         f"{work.dtype}")
    if not work.is_contiguous() or work.device != p.device:
        raise ValueError(f"{fn}: work must be contiguous, on {p.device}")
    if work.device.type == "cuda" and work.data_ptr() % 16:
        raise ValueError(f"{fn}: CUDA operands must be 16-byte aligned")
    return work


def arena_apply_ref(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                    weight_decay: float = 0.0, m_codec="fp32",
                    v_codec="fp32", work_dtype=None, work=None, guard=None):
    """Plain version of `arena_apply` (same operations, same order;
    guarded, p is where-selected on ok). The master form then writes
    work = p.to(work_dtype) of the final p (bf16(p) where ok is 0) and
    returns (p, work)."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, _), (v_parts, _) = _as_parts(m), _as_parts(v)
    work = _work_buffer("arena_apply", p, work_dtype, work)
    lr, bc1, bc2, eps, wd = _scalars_on(p.device, *_apply_scalars(
        lr, bc1, bc2, eps, weight_decay))
    ok = None if guard is None else guard.reshape(()) != 0
    fl = _flush(mk, vk)
    for lo in range(0, p.shape[0], _PLAIN_CHUNK_ROWS):
        hi = lo + _PLAIN_CHUNK_ROWS
        pc = p[lo:hi]
        pf = fl(pc)
        vh = vk.decode(_rows(vk, v_parts, lo, hi), fl)  # (rows, 1) factored
        den = fl(bc1 * fl(fl(_sqrt32(fl(vh / bc2))) + eps))
        u = fl(mk.decode(_rows(mk, m_parts, lo, hi), fl) / den)
        if weight_decay:
            u = fl(_fma32(wd, pf, u))
        _write((pc,), (fl(_fma32(-lr, u, pf)),), ok)
        if work is not None:
            work[lo:hi].copy_(pc.to(work.dtype))
    return p if work is None else (p, work)


def arena_apply(p, m, v, *, lr, bc1, bc2, eps: float = 1e-8,
                weight_decay: float = 0.0, m_codec="fp32", v_codec="fp32",
                work_dtype=None, work=None, guard=None):
    """Bias-corrected Adam apply over the packed param arena, in place,
    decoding both moments in-pass:
    p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + weight_decay*p). `guard` (the
    guarded form): a (1,) float32 device tensor; with 0.0 p keeps every
    byte, whatever bc1 is. Returns p.

    `work_dtype=torch.bfloat16` selects the master-param form: p is the
    fp32 master, and the same launch also writes the working params
    work = bf16(p_new) (bf16(p) when the guard's ok is 0) into `work` (the
    caller's (rows, LANES) bf16 buffer, e.g. the working-param cache) or
    into a new one. Returns (p, work)."""
    mk, vk = kernel_codec("m", m_codec), kernel_codec("v", v_codec)
    (m_parts, _), (v_parts, _) = _as_parts(m), _as_parts(v)
    work = _work_buffer("arena_apply", p, work_dtype, work)
    _check_state("arena_apply", mk, vk, m_parts, v_parts, p, p.shape[0])
    if guard is not None:
        _check_guard("arena_apply", guard, 1, p.device)
    if p.device.type == "cpu":
        return arena_apply_ref(p, m, v, lr=lr, bc1=bc1, bc2=bc2, eps=eps,
                               weight_decay=weight_decay, m_codec=mk,
                               v_codec=vk, work_dtype=work_dtype, work=work,
                               guard=guard)
    _launch("arena_apply", "arena_apply_launch", p,
            apply_args(mk, vk, p, m_parts, v_parts, lr, bc1, bc2, eps,
                       weight_decay, work), guard)
    arena_apply.launches += 1
    return p if work is None else (p, work)


arena_apply.launches = 0
