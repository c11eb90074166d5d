"""The port's fp8 (e4m3) gradient wire and its error-feedback residual
against the reference's (tests/test_fp8_wire.py, kernels/fused_step.py's
`grad_scale`, the guarded engines' fp8 branches), on the CPU:

  - the row helpers (fp8_encode_rows, fp8_scale_rows, fp8_quantize_rows,
    fp8_decode_rows) bit for bit against the reference's on the same
    inputs, and the reference's unit contracts on the port's: the
    round-trip bound, summand headroom, NaN/inf as NaN codes, zero and
    denormal-scale rows; the one exception (NAN_ROW_CODES) stated;
  - torch's float8_e4m3fn cast against XLA's up to 464, ties included;
  - the plain e4m3 fold and slice fold, every (m, v) pair, unguarded and
    guarded (ok = 1 at the traced scale, ok = 0 on NaN codes), against the
    Pallas kernels with `grad_scale` (interpret mode), bit for bit but
    rowcol's sums (RC_REL_TOL);
  - the plain encode with the residual injected and the residual's update
    against the reference's jitted expressions, bit for bit;
  - the wrappers' TypeErrors against the reference's messages, and the
    launch arguments against the declared C signatures;
  - guarded adama (every pair) and adama_layerwise (fp32/fp32,
    int8/rowcol) on reduced stablelm-1.6b against the reference's engines,
    a caught NaN equal to a forced skip bit for bit (ef included),
    error_feedback=False, dynamic loss scaling, and the CLI.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.core import arena as jarena
from repro.core import state_store as jss
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import adama_accum as jaa
from repro.kernels import fused_step as jfs
from repro.train import faults as jfaults
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.kernels import adama_accum as taa
from repro_torch.kernels import build
from repro_torch.kernels import fp8_wire as tfw
from repro_torch.kernels import fused_step as tfs
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.train import faults as tfaults
from test_torch_codecs import (B1, B2, CODE_FLIP_FRAC, LOSS_FLIP_TOL,
                               LOSS_TOL, LR, PAIRS, _assert_bitwise,
                               _assert_state_matches, _pair_arenas, _t)
from test_torch_engines import ENGINE_TOL
from test_torch_guard import (ARCH, N_MICRO, STEPS, _guard_vec, _init_params,
                              _jax_guard)
from test_torch_wire import _data

torch.set_num_threads(1)

E4M3 = torch.float8_e4m3fn
# The one place where the port's codes differ from the reference's
# (kernels/adama_accum.py): a finite element above 464 in a row that also
# holds a NaN. Its row's scale falls back to 1.0, and XLA's cast gives NaN
# above 464 where the port saturates to +-448 (torch's cast, and
# Hopper's cvt.rn.satfinite). The micro-batch is skipped either way (its
# NaN code fails the guard), so no state sees the difference.
NAN_ROW_CODES = "a finite element above 464 in a NaN row: +-448, not NaN"
# The fp8-wire engines against the reference's on reduced stablelm-1.6b:
# the two models' gradients differ by float32 roundings (~1e-7), so an
# element within that of an e4m3 rounding boundary takes the neighbouring
# code on one side, one e4m3 step (2^-3 of the code) apart; its fold moves
# m by (1 - b1) x that step, the update by up to ~lr, and its residual takes
# the other side of the step. Measured over 2 steps (every pair, adama and
# adama_layerwise alike), the share of elements beyond ENGINE_TOL (params)
# or beyond FP8_REL of the largest value (m, v and ef, decoded): with an
# fp32 m, params up to 0.18% (largest 1.7e-4), m 0.32%, v 0.06%; with int8
# m, whose code flips move a row's scale and so every code of the row (as
# CODE_FLIP_FRAC says), params up to 5.4% (largest 1.8e-3), m 8.6%, v
# 0.65%; the residual after step 1 (the same params on both sides) 0.017%.
# After step 2 the params have moved apart by those flips, so the gradients
# and with them most of the residual differ: each residual is then held to
# its own size, at most half a code step, as the other's (no element apart
# by more than the two largest residuals together, measured 1.33 of the
# reference's; neither largest residual twice the other's).
FP8_FLIP_FRAC = 5e-3
FP8_CODE_FLIP_FRAC = 0.12
FP8_REL = 1e-5


def _codes(x):
    """A JAX float8_e4m3fn array as a torch tensor of the same bits."""
    return torch.from_numpy(np.asarray(x).view(np.uint8).copy()).view(E4M3)


def _code_bits(x):
    return (x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.uint8))


def _nan_codes(bits):
    return (bits & 0x7F) == 0x7F


def _assert_codes_equal(got, want, label, allow=None):
    """Codes bit for bit, or both NaN (the sign of a NaN is the divide's);
    `allow` (a bool mask) exempts the NAN_ROW_CODES elements, which must
    then be +-448 here and NaN there."""
    a, b = _code_bits(got), _code_bits(want)
    na, nb = _nan_codes(a), _nan_codes(b)
    if allow is not None:
        assert (nb[allow] & (np.abs(_t(a).view(E4M3).float().numpy()[allow])
                             == taa.FP8_MAX)).all(), label
        na, nb = na & ~allow, nb & ~allow
        a, b = np.where(allow, 0, a), np.where(allow, 0, b)
    assert np.array_equal(na, nb), label
    assert np.array_equal(a[~na], b[~nb]), (label, int((a != b).sum()))


# ---------------------------------------------------------------------------
# The row helpers: bit for bit, and the reference's unit contracts
# ---------------------------------------------------------------------------


def _edge_slab(seed=0):
    """(16, LANES) fp32 rows over 40 decades, and the wire's edge rows: a
    zero row, a row whose max is 1e-37 (scale fallback) with subnormal
    elements, rows holding a NaN (beside a finite 1000: NAN_ROW_CODES),
    +inf and -inf, and a row of e4m3 ties +-1 ulp under scale 1."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((16, 1024)) * np.logspace(-36, 3, 16)[:, None]
         ).astype(np.float32)
    g[0] = 0.0
    g[1] = np.clip(g[1], -1, 1).astype(np.float32) * np.float32(1e-37)
    g[1, 0] = np.float32(1e-37)
    g[2, 5], g[2, 9] = np.nan, 1000.0
    g[3, 3], g[4, 700] = np.inf, -np.inf
    g[5] = 0.0
    g[5, 0] = taa.FP8_MAX
    ties = _tie_values()
    g[5, 1:1 + ties.size] = ties
    return g


def _tie_values():
    """Every midpoint of two neighbouring finite non-negative e4m3 values
    and one float32 ulp either side of it, both signs."""
    v = np.arange(0x7f, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(
        np.float32)
    mid = (v[:-1] + v[1:]) / np.float32(2)
    pos = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                          np.nextafter(mid, np.float32(0))])
    return np.concatenate([pos, -pos]).astype(np.float32)


def test_fp8_encode_rows_is_the_references_bit_for_bit():
    """Codes and scales of the edge slab equal the reference's, but for
    NAN_ROW_CODES; the zero row's scale is 1.0, the 1e-37 row's its max,
    the tie row's exactly 1.0; FP8_MAX is the reference's."""
    g = _edge_slab()
    jc, js = jaa.fp8_encode_rows(jnp.asarray(g))
    tc, ts = taa.fp8_encode_rows(_t(g))
    assert tc.dtype == E4M3 and tuple(ts.shape) == (16, 1)
    allow = np.zeros(g.shape, bool)
    allow[2, 9] = True
    _assert_codes_equal(tc, jc, "codes", allow)
    _assert_bitwise(ts, np.asarray(js), "scales")
    assert ts[0, 0] == 1.0 and ts[5, 0] == 1.0
    assert ts[1, 0] == np.float32(1e-37)
    assert taa.FP8_MAX == jaa.FP8_MAX
    # and the tie row's codes are torch's cast of it
    _assert_bitwise(tc[5].view(torch.uint8), _t(g[5]).to(E4M3).view(
        torch.uint8), "tie row vs torch's cast")


@pytest.mark.parametrize("n", [1, 4])
def test_fp8_scale_quantize_decode_are_the_references(n):
    """fp8_scale_rows (with summand headroom), fp8_quantize_rows and
    fp8_decode_rows bit for bit against the reference's, on finite rows."""
    g = _edge_slab(1)[np.r_[0:2, 6:16]]
    rowmax = np.abs(g).max(axis=1, keepdims=True)
    js = jaa.fp8_scale_rows(jnp.asarray(rowmax), n_summands=n)
    ts = taa.fp8_scale_rows(_t(rowmax), n_summands=n)
    _assert_bitwise(ts, np.asarray(js), "scales")
    jq = jaa.fp8_quantize_rows(jnp.asarray(g), js)
    tq = taa.fp8_quantize_rows(_t(g), ts)
    _assert_codes_equal(tq, jq, "codes")
    _assert_bitwise(taa.fp8_decode_rows(tq, ts),
                    np.asarray(jaa.fp8_decode_rows(jq, js)), "decode")


def test_fp8_roundtrip_error_bound():
    """tests/test_fp8_wire.py's round trip on the port: each element within
    half a mantissa step (2^-4) of itself plus the subnormal-code floor
    (scale * 2^-9), the row max at the top of the range; the reference's
    codes on the same input, bit for bit."""
    g = np.asarray(jax.random.normal(jax.random.key(0), (16, 1024),
                                     jnp.float32)
                   * jnp.logspace(-6, 3, 16)[:, None])
    codes, s = taa.fp8_encode_rows(_t(g))
    dec = taa.fp8_decode_rows(codes, s).numpy()
    bound = np.abs(g) * 2.0 ** -4 + s.numpy() * 2.0 ** -9
    assert (np.abs(dec - g) <= bound + 1e-30).all()
    np.testing.assert_allclose(s.numpy()[:, 0],
                               np.abs(g).max(axis=-1) / taa.FP8_MAX,
                               rtol=1e-6)
    jc, js = jaa.fp8_encode_rows(jnp.asarray(g))
    _assert_codes_equal(codes, jc, "codes")
    _assert_bitwise(s, np.asarray(js), "scales")


def test_fp8_summand_headroom():
    """n_summands=M widens the scale by M: each code at most FP8_MAX / M,
    and the fp32 sum of M slabs' codes decodes to the sum of the slabs
    within their own errors (tests/test_fp8_wire.py's contract)."""
    M = 4
    ks = jax.random.split(jax.random.key(1), M)
    slabs = [np.asarray(jax.random.normal(k, (8, 1024), jnp.float32) * 3.0)
             for k in ks]
    rowmax = np.abs(np.stack(slabs)).max(axis=(0, 2))[:, None]
    s = taa.fp8_scale_rows(_t(rowmax), n_summands=M)
    codes = [taa.fp8_quantize_rows(_t(g), s) for g in slabs]
    for c in codes:
        assert float(c.float().abs().max()) <= taa.FP8_MAX / M
    got = taa.fp8_decode_rows(sum(c.float() for c in codes), s).numpy()
    bound = sum(np.abs(g) * 2.0 ** -4 for g in slabs) + M * s.numpy() \
        * 2.0 ** -9
    assert np.isfinite(got).all()
    assert (np.abs(got - sum(slabs)) <= bound + 1e-30).all()


def test_fp8_nonfinite_propagates_as_nan_codes():
    """A NaN element stays NaN (its row's scale falls back to 1.0); an inf
    makes its own code NaN and its row's others zero; clean rows of the
    same slab decode finite."""
    g = np.ones((4, 1024), np.float32)
    g[1, 3] = np.nan
    codes, s = taa.fp8_encode_rows(_t(g))
    assert torch.isnan(codes.float()[1, 3]) and s[1, 0] == 1.0
    g = np.ones((4, 1024), np.float32)
    g[2, 7] = np.inf
    codes, s = taa.fp8_encode_rows(_t(g))
    assert not torch.isfinite(codes.float()[2, 7])
    assert torch.isfinite(taa.fp8_decode_rows(codes, s)[0]).all()


def test_fp8_nan_row_exception_is_the_only_difference():
    """NAN_ROW_CODES: in a NaN row (scale 1.0), a finite 1000 and -470 are
    +-448 here and NaN in the reference; 463 is 448 on both sides."""
    g = np.ones((2, 1024), np.float32)
    g[0, :4] = [np.nan, 1000.0, -470.0, 463.0]
    tc, _ = taa.fp8_encode_rows(_t(g))
    jc, _ = jaa.fp8_encode_rows(jnp.asarray(g))
    t, j = tc.float().numpy(), np.asarray(jc).astype(np.float32)
    assert np.isnan(j[0, 1]) and np.isnan(j[0, 2]) and j[0, 3] == 448.0
    assert t[0, 1] == 448.0 and t[0, 2] == -448.0 and t[0, 3] == 448.0
    allow = np.zeros(g.shape, bool)
    allow[0, 1:3] = True
    _assert_codes_equal(tc, jc, NAN_ROW_CODES, allow)


def test_fp8_zero_and_denormal_scale_rules():
    """A zero row takes scale 1.0 and zero codes; a row whose natural scale
    would be subnormal falls back to scale = its max, and decodes its max
    exactly."""
    g = np.zeros((2, 1024), np.float32)
    g[1, 0] = np.float32(1e-37)
    codes, s = taa.fp8_encode_rows(_t(g))
    assert s[0, 0] == 1.0 and not codes.float()[0].any()
    assert s[1, 0] == np.float32(1e-37)
    assert taa.fp8_decode_rows(codes, s)[1, 0] == np.float32(1e-37)


def test_torch_cast_is_xlas_up_to_464():
    """torch's float32 -> float8_e4m3fn cast equals XLA's bit for bit on
    every value the encoder can give a finite row: random values over the
    range, e4m3's subnormals, every tie between two e4m3 values and one
    ulp either side, both signs, up to 464 (the tie between 448 and the
    NaN pattern, rounded to even 448 by both); above 464 XLA gives NaN and
    torch +-448 (NAN_ROW_CODES)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        (rng.uniform(-463.99, 463.99, 200_000)).astype(np.float32),
        (rng.standard_normal(100_000) * 2.0 ** -8).astype(np.float32),
        (rng.standard_normal(100_000) * 2.0 ** rng.integers(-30, 8, 100_000)
         ).astype(np.float32).clip(-463.99, 463.99),
        _tie_values(), np.float32([0.0, -0.0, 463.99, -463.99, 448.0,
                                   464.0, -464.0])])
    _assert_codes_equal(_t(x).to(E4M3), jnp.asarray(x).astype(
        jnp.float8_e4m3fn), "cast up to 464")
    big = np.float32([np.nextafter(np.float32(464), np.float32(500)), -470.0,
                      1000.0, np.inf])
    assert np.isnan(np.asarray(jnp.asarray(big).astype(
        jnp.float8_e4m3fn)).astype(np.float32)).all()
    assert (_t(big).to(E4M3).float().abs() == 448.0).all()


# ---------------------------------------------------------------------------
# The e4m3 folds: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _encoded(g):
    """The reference's codes and scales of a slab, and the port's copies."""
    jc, js = jaa.fp8_encode_rows(jnp.asarray(g))
    return jc, js, _codes(jc), _t(np.asarray(js))


@pytest.mark.parametrize("mode", ["unguarded", "slice", "ok=1", "ok=0"])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_e4m3_fold_plain_version_vs_reference(m_codec, v_codec, mode):
    """Two chained folds (decay fused at scale 1, then scale 1/4) of e4m3
    codes with their scale column, through arena_fold, arena_fold_slice
    (rows [16, 48), block 8) or the guarded form at the traced scale (ok =
    0: codes holding NaN codes): every column as the reference's with
    `grad_scale`, bit for bit (rowcol's sums to RC_REL_TOL); with ok = 0
    every byte unchanged."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=2)
    before = [x.clone() for x in tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0]]
    ok = mode != "ok=0"
    base = dict(beta1=B1, beta2=B2, m_codec=m_codec, v_codec=v_codec)
    for k, kw in enumerate((dict(scale=1.0, decay=(B1, B2)),
                            dict(scale=0.25, decay=None))):
        src = (g if k == 0 else np.flip(g, 0)).copy()
        if not ok:
            src[3, 5] = np.nan
        if mode == "slice":
            src = src[8:40]
        jc, js, tc, ts = _encoded(src)
        if mode == "slice":
            jm, jv = jfs.arena_fold_slice(jm, jv, jc, 16, block=8,
                                          grad_scale=js, interpret=True,
                                          **base, **kw)
            tfs.arena_fold_slice(tm, tv, tc, 16, block=8, grad_scale=ts,
                                 grad_dtype=E4M3, **base, **kw)
        elif mode == "unguarded":
            jm, jv = jfs.arena_fold(jm, jv, jc, grad_scale=js,
                                    interpret=True, **base, **kw)
            out = tfs.arena_fold(tm, tv, tc, grad_scale=ts, **base, **kw)
            assert out[0] is tm and out[1] is tv               # in place
        else:
            jm, jv, _ = jfs.arena_fold(jm, jv, jc, grad_scale=js,
                                       interpret=True, **base,
                                       **_jax_guard(kw["decay"], ok))
            tfs.arena_fold(tm, tv, tc, grad_scale=ts, **base,
                           guard=_guard_vec(kw["decay"], ok))
        _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv,
                              f"{mode} {kw}")
    if not ok:
        _assert_bitwise(tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0],
                        tuple(before), "ok = 0 wrote")


def test_e4m3_fold_decodes_in_the_references_order():
    """A fold of codes with their scales equals the fp32 fold of
    fl(fl(code * s) * gs) with the decode folded into the codes at scale 1
    where that is exact: a power-of-two scale column (fp32/fp32)."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((16, 1024)).astype(np.float32)
    codes, _ = taa.fp8_encode_rows(_t(g))
    gs = torch.full((16, 1), 2.0 ** -3)
    m, v = torch.zeros(16, 1024), torch.zeros(16, 1024)
    mu, vu = m.clone(), v.clone()
    tfs.arena_fold(m, v, codes, beta1=B1, beta2=B2, scale=0.25,
                   grad_scale=gs)
    tfs.arena_fold(mu, vu, codes.float() * gs, beta1=B1, beta2=B2,
                   scale=0.25)
    _assert_bitwise((m, v), (mu, vu), "decoded fold")


# ---------------------------------------------------------------------------
# The encode with the residual and the residual's update
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_wire_fns():
    """The reference's single-device expressions, jitted as its engines
    jit them: Algorithm 1's injection and update by the live scale S,
    Algorithm 2's by ef_scale = 1 / fold_scale (layerwise.py's
    `_fp8_wire_slab` / `_fp8_ef_update`)."""
    def inject(slab, ef, s):
        return slab + ef * s

    def encode(slab, ef, s):
        x = slab + ef * s
        return x, jaa.fp8_encode_rows(x)

    def update(x, codes, gs, s):
        return (x - jaa.fp8_decode_rows(codes, gs)) / s
    return jax.jit(inject), jax.jit(encode), jax.jit(update)


def _wire_case(seed, s):
    rng = np.random.default_rng(seed)
    slab = _edge_slab(seed)
    ef = (rng.standard_normal(slab.shape) * 1e-3).astype(np.float32)
    ef[0] = 0.0
    ef[6, :8] = np.float32(3e-39)           # subnormal residual entries
    return slab, ef, np.float32(s)


@pytest.mark.parametrize("s", [1.0, 2.0 ** 15, 1000.0,
                               float(np.float32(1) / np.float32(1 / 1000))])
def test_plain_encode_and_update_are_the_references(s):
    """fp8_encode_ref with the residual: the injected slab, its codes and
    scales, and the finite flag as the reference's jitted `slab + ef * S`
    and fp8_encode_rows (XLA contracts the injection into fma(ef, S,
    slab)); fp8_ef_update_ref as its `(x - decode) / S` (fma(-q, s, x) /
    S), bit for bit on the finite rows; the flag clears on the non-finite
    ones; with ok = 0 the residual keeps every byte. The last S is
    Algorithm 2's 1 / f32(1 / 1000)."""
    inject, encode, update = _jax_wire_fns()
    slab, ef, sv = _wire_case(5, s)
    x, (jc, js) = encode(jnp.asarray(slab), jnp.asarray(ef), sv)
    scale = torch.tensor([sv])
    ok = torch.ones(1)
    tc, ts = tfw.fp8_encode(_t(slab), ef=_t(ef), scale=scale, ok=ok)
    assert ok.item() == 0.0            # the slab holds NaN and inf rows
    allow = np.zeros(slab.shape, bool)
    allow[2, 9] = True
    _assert_codes_equal(tc, jc, "codes", allow)
    _assert_bitwise(ts, np.asarray(js), "scales")
    _assert_bitwise(tfw._inject(_t(slab), _t(ef), scale.reshape(())),
                    np.asarray(inject(jnp.asarray(slab), jnp.asarray(ef),
                                      sv)), "injection")
    fin = np.r_[0:2, 5:16]
    want = np.asarray(update(x, jc, js, sv))[fin]
    e = _t(ef)
    tfw.fp8_ef_update(e, _t(slab), tc, ts, scale=scale,
                      ok=torch.ones(1))
    _assert_bitwise(e[fin], want, "residual")
    e0 = _t(ef)
    tfw.fp8_ef_update(e0, _t(slab), tc, ts, scale=scale, ok=torch.zeros(1))
    _assert_bitwise(e0, ef, "ok = 0 wrote")
    ok = torch.ones(1)
    tfw.fp8_encode(_t(slab[fin]), ef=_t(ef[fin]), scale=scale, ok=ok)
    assert ok.item() == 1.0


def test_encode_without_the_residual_is_fp8_encode_rows():
    slab = _edge_slab(6)
    ok = torch.ones(1)
    tc, ts = tfw.fp8_encode(_t(slab), ok=ok)
    wc, ws = taa.fp8_encode_rows(_t(slab))
    _assert_codes_equal(tc, wc, "codes")
    _assert_bitwise(ts, ws, "scales")
    assert ok.item() == 0.0


def test_fp8_wrappers_check_their_operands():
    slab = torch.zeros(8, 1024)
    with pytest.raises(ValueError, match="scale"):
        tfw.fp8_encode(slab, ef=torch.zeros(8, 1024))
    with pytest.raises(ValueError, match="ef must be"):
        tfw.fp8_encode(slab, ef=torch.zeros(4, 1024), scale=torch.ones(1))
    with pytest.raises(TypeError, match="slab"):
        tfw.fp8_encode(slab.double())
    codes, gs = tfw.fp8_encode(slab)
    with pytest.raises(ValueError, match="ok"):
        tfw.fp8_ef_update(torch.zeros(8, 1024), slab, codes, gs,
                          scale=torch.ones(1), ok=torch.ones(2))
    with pytest.raises(ValueError, match="scale column"):
        tfw.fp8_ef_update(torch.zeros(8, 1024), slab, codes, gs[:4],
                          scale=torch.ones(1), ok=torch.ones(1))


# ---------------------------------------------------------------------------
# The wrappers' wire checks and launch arguments
# ---------------------------------------------------------------------------


def _messages(fn_jax, fn_port):
    """The reference's TypeError message and the port's without its
    function prefix."""
    with pytest.raises(TypeError) as j:
        fn_jax()
    with pytest.raises(TypeError) as t:
        fn_port()
    return str(j.value), str(t.value).split(": ", 1)[1]


@pytest.mark.parametrize("fold", ["arena_fold", "arena_fold_slice"])
@pytest.mark.parametrize("case", ["codes without scale", "scale with fp32",
                                  "scale with bf16", "scale shape",
                                  "scale dtype"])
def test_wire_pairing_errors_match_the_reference(fold, case):
    """An e4m3 slab without its grad_scale, a grad_scale beside an fp32 or
    bf16 slab, and a grad_scale not (rows, 1) float32 each raise TypeError
    with the reference's message, from both folds."""
    rows = 8
    jg = {"codes without scale": jnp.zeros((rows, 1024), jnp.float8_e4m3fn),
          "scale with fp32": jnp.zeros((rows, 1024)),
          "scale with bf16": jnp.zeros((rows, 1024), jnp.bfloat16)}.get(
        case, jnp.zeros((rows, 1024), jnp.float8_e4m3fn))
    js = {"codes without scale": None,
          "scale shape": jnp.ones((rows, 2)),
          "scale dtype": jnp.ones((rows, 1), jnp.bfloat16)}.get(
        case, jnp.ones((rows, 1)))
    tg = torch.from_numpy(np.asarray(jg).view(np.uint8).copy()).view(E4M3) \
        if jg.dtype == jnp.float8_e4m3fn else (
            torch.zeros(rows, 1024, dtype=torch.bfloat16)
            if jg.dtype == jnp.bfloat16 else torch.zeros(rows, 1024))
    ts = None if js is None else (torch.ones(rows, 2)
                                  if case == "scale shape" else
                                  torch.ones(rows, 1, dtype=torch.bfloat16)
                                  if case == "scale dtype"
                                  else torch.ones(rows, 1))
    jm = jnp.zeros((rows, 1024))
    tm = torch.zeros(rows, 1024)
    kw = dict(beta1=B1, beta2=B2)
    if fold == "arena_fold":
        want, got = _messages(
            lambda: jfs.arena_fold(jm, jm, jg, grad_scale=js, **kw),
            lambda: tfs.arena_fold(tm, tm.clone(), tg, grad_scale=ts, **kw))
    else:
        want, got = _messages(
            lambda: jfs.arena_fold_slice(jm, jm, jg, 0, block=8,
                                         grad_scale=js, **kw),
            lambda: tfs.arena_fold_slice(tm, tm.clone(), tg, 0, block=8,
                                         grad_scale=ts, **kw))
    assert got == want


def test_e4m3_launch_arguments_match_the_declared_c_signatures():
    """The e4m3 launchers take the fp32/bf16 ones' arguments, then
    grad_scale's pointer (then the guard's); fp8_wire's launchers take
    their pointers (NULL for an absent residual or flag) and the rows."""
    import ctypes
    mk, vk = tfs.kernel_codec("m", "int8"), tfs.kernel_codec("v", "rowcol")
    g = torch.zeros(8, 1024, dtype=E4M3)
    gs = torch.ones(8, 1)
    m = (torch.zeros(8, 1024, dtype=torch.int8), torch.zeros(8, 1))
    v = (torch.zeros(8, 1), torch.zeros(1, 1024))
    vec = _guard_vec(None, True)
    args = tfs.fold_args(mk, vk, m, v, g, 0, B1, B2, 0.125, None,
                         tfs.fold_scratch(vk, 8, g.device), gs)
    for name, extra in (("arena_fold_e4m3_launch", ()),
                        ("arena_fold_e4m3_guarded_launch",
                         (vec.data_ptr(),))):
        got = []
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *tfs.SIGNATURES[name])
        assert proto(lambda *a: got.append(a) or 0)(*args, *extra, 0) == 0
        assert got[0][7] == tfs.WIRES[E4M3] == 2
        assert got[0][18] == gs.data_ptr()
        assert got[0][19:-1] == extra
    assert tfs._fold_launcher(gs) == "arena_fold_e4m3_launch"
    assert tfs._fold_launcher(None) == "arena_fold_launch"
    slab, ef = torch.zeros(8, 1024), torch.zeros(8, 1024)
    codes = torch.zeros(8, 1024, dtype=E4M3)
    s, ok = torch.ones(1), torch.ones(1)
    for name, call in (
            ("fp8_encode_launch", (slab.data_ptr(), None, None,
                                   codes.data_ptr(), gs.data_ptr(), None, 8)),
            ("fp8_ef_update_launch", (ef.data_ptr(), slab.data_ptr(),
                                      codes.data_ptr(), gs.data_ptr(),
                                      s.data_ptr(), ok.data_ptr(), 8))):
        got = []
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *tfw.SIGNATURES[name])
        assert proto(lambda *a: got.append(a) or 0)(*call, 0) == 0
        assert got[0][:-1] == call


def test_cpu_fp8_forms_count_no_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    before = (tfw.fp8_encode.launches, tfw.fp8_ef_update.launches,
              tfs.arena_fold.launches, tfs.arena_fold_slice.launches)
    slab, ef = torch.randn(8, 1024), torch.zeros(8, 1024)
    s, ok = torch.ones(1), torch.ones(1)
    codes, gs = tfw.fp8_encode(slab, ef=ef, scale=s, ok=ok)
    m, v = torch.zeros(8, 1024), torch.zeros(8, 1024)
    tfs.arena_fold(m, v, codes, beta1=B1, beta2=B2, grad_scale=gs)
    tfs.arena_fold_slice(m, v, codes, 0, beta1=B1, beta2=B2, block=8,
                         grad_scale=gs)
    tfw.fp8_ef_update(ef, slab, codes, gs, scale=s, ok=ok)
    assert (tfw.fp8_encode.launches, tfw.fp8_ef_update.launches,
            tfs.arena_fold.launches, tfs.arena_fold_slice.launches) == before


def test_state_store_threads_grad_scale_and_reports_the_residual():
    """state_store's folds pass grad_scale on; guard=True on codes raises
    (finite_and takes no codes: their flag is the encoder's);
    init_arena(error_feedback=True) adds a zeroed fp32 "ef" of the arena's
    bytes, the reference's region."""
    from repro_torch.core import adama as tadama
    tree = {"w": torch.zeros(3, 700)}
    st = tadama.init_arena(tree, error_feedback=True)
    lay = st["m"].layout
    assert tuple(st["ef"].data.shape) == (lay.rows, 1024)
    assert not st["ef"].data.any()
    assert tss.wire_region_bytes(st) == {"ef": lay.rows * 1024 * 4}
    assert tss.wire_region_bytes(tadama.init_arena(tree)) == {}
    g = torch.randn(lay.rows, 1024)
    codes, gs = tfw.fp8_encode(g)
    m0 = st["m"].data.clone()
    tss.fold_state(st, codes, beta1=B1, beta2=B2, grad_scale=gs)
    assert not st["m"].data.equal(m0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tss.fold_state(st, codes, beta1=B1, beta2=B2, grad_scale=gs,
                       guard=True)


# ---------------------------------------------------------------------------
# Engines on reduced stablelm-1.6b, fp8 wire
# ---------------------------------------------------------------------------


def _moments(state, moment, port):
    """A state's moment decoded to a (rows, LANES) fp32 numpy array (the
    port's codec decode, for the reference's columns too)."""
    if port:
        mc = tss.codec_of(state[moment], moment)
        parts = mc.parts_of(state[moment])
    else:
        jc = jss.codec_of(state[moment], moment)
        mc = tss.get_codec(jc.name, moment)
        parts = tuple(torch.from_numpy(np.asarray(x).copy())
                      for x in jc.parts_of(state[moment]))
    return mc.decode(tuple(parts)).numpy().copy()


@functools.lru_cache(maxsize=None)
def _reference_run(engine, m_codec, v_codec, fault=None, steps=STEPS,
                   **over):
    """The reference's guarded fp8-wire run: per step the metrics, packed
    params, the decoded moments and ef."""
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, state_codec=v_codec,
                             m_codec=m_codec, grad_dtype="fp8_e4m3",
                             finite_guard=True, **over)
    step, init = jax_make_train_step(tiny(ARCH), opt,
                                     fault=jfaults.parse_fault(fault))
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _init_params())
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _data(steps):
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(dict(metrics={k: float(v) for k, v in mx.items()},
                        params=np.asarray(jarena.pack(params, layout)),
                        m=_moments(state, "m", False),
                        v=_moments(state, "v", False),
                        ef=(np.asarray(state["ef"].data) if "ef" in state
                            else None)))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(engine, m_codec, v_codec, fault=None, steps=STEPS,
              grad_dtype="fp8_e4m3", **over):
    """The port's guarded run from the reference's params: per step the
    metrics, step counter, packed params, moments (decoded and as raw
    bytes) and ef (None without it)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          state_codec=v_codec, m_codec=m_codec,
                          grad_dtype=grad_dtype, finite_guard=True, **over)
    tree = tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                    "cpu")).tree()
    step, init = make_train_step(cfg, opt, fault=tfaults.parse_fault(fault))
    state = init(tree)
    out = []
    for batch in _data(steps):
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            raw = [x.numpy().copy() for mo in ("m", "v")
                   for x in tss.codec_of(state[mo], mo).parts_of(state[mo])]
            out.append(dict(
                metrics={k: float(v) for k, v in mx.items()},
                step=state["step"],
                params=tarena.pack(tree, state["m"].layout).numpy().copy(),
                m=_moments(state, "m", True), v=_moments(state, "v", True),
                raw=raw, ef=(state["ef"].data.numpy().copy()
                             if "ef" in state else None)))
    return out


def _share_beyond(a, b, tol):
    return float((np.abs(np.asarray(a, np.float64) - b) > tol).mean())


def _assert_fp8_engine_close(got, want, m_codec, v_codec, k, label):
    """Step k's params, moments and residual against the reference's, as
    FP8_FLIP_FRAC's comment says."""
    confs = [tss.get_codec(n, mo).conformance
             for mo, n in (("m", m_codec), ("v", v_codec))]
    frac = FP8_CODE_FLIP_FRAC if m_codec == "int8" else FP8_FLIP_FRAC
    p, wp = got["params"], want["params"]
    assert _share_beyond(p, wp, ENGINE_TOL) <= frac, label
    bound = ENGINE_TOL + sum((c.drift_lr or 0.0) + c.fp8_wire_lr
                             for c in confs) * LR
    assert np.abs(p - wp).max() <= bound, (label, np.abs(p - wp).max())
    for mo in ("m", "v"):
        ref = want[mo]
        assert _share_beyond(got[mo], ref, FP8_REL * np.abs(ref).max()) \
            <= frac, (label, mo)
    ef, wef = got["ef"], want["ef"]
    top, wtop = np.abs(ef).max(), np.abs(wef).max()
    assert np.isfinite(ef).all() and top > 0, label
    if k == 0:
        assert _share_beyond(ef, wef, FP8_REL * wtop) <= FP8_FLIP_FRAC, label
    assert (np.abs(ef - wef) <= top + wtop).all(), label
    assert top <= 2 * wtop and wtop <= 2 * top, (label, top, wtop)


ENGINE_CASES = [("adama", m, v) for m, v in PAIRS] + [
    ("adama_layerwise", "fp32", "fp32"), ("adama_layerwise", "int8",
                                          "rowcol")]


@pytest.mark.parametrize("engine,m_codec,v_codec", ENGINE_CASES)
def test_fp8_engine_matches_reference(engine, m_codec, v_codec):
    """Two guarded steps on the fp8 wire with error feedback against the
    reference's: the counters exactly, losses within LOSS_TOL (int8 m's
    step 2 within LOSS_FLIP_TOL), params, m, v and ef as
    `_assert_fp8_engine_close` holds them; and the port's step-1 loss its
    fp32-wire run's bit for bit (the forward never sees the wire), its
    params after step 1 within the pair's declared fp8_wire_lr x lr of
    that run's."""
    want = _reference_run(engine, m_codec, v_codec)
    got = _port_run(engine, m_codec, v_codec)
    fp32 = _port_run(engine, m_codec, v_codec, grad_dtype="fp32")
    tol = sum(tss.get_codec(n, mo).conformance.fp8_wire_lr
              for mo, n in (("m", m_codec), ("v", v_codec))) * LR
    for k, (a, b) in enumerate(zip(got, want)):
        label = f"step {k + 1}"
        for name in ("skipped_micro_batches", "loss_scale"):
            assert a["metrics"][name] == b["metrics"][name], (label, name)
        np.testing.assert_allclose(
            a["metrics"]["loss"], b["metrics"]["loss"], rtol=0,
            atol=LOSS_FLIP_TOL if m_codec == "int8" and k else LOSS_TOL)
        _assert_fp8_engine_close(a, b, m_codec, v_codec, k, label)
    assert got[0]["metrics"]["loss"] == fp32[0]["metrics"]["loss"]
    assert np.abs(got[0]["params"] - fp32[0]["params"]).max() <= tol


def _same(a, b):
    return (np.array_equal(a["params"].view(np.uint8),
                           b["params"].view(np.uint8))
            and all(np.array_equal(x.view(np.uint8), y.view(np.uint8))
                    for x, y in zip(a["raw"] + [a["ef"]],
                                    b["raw"] + [b["ef"]])))


@pytest.mark.parametrize("engine,m_codec,v_codec", [
    ("adama", "fp32", "fp32"), ("adama_layerwise", "int8", "rowcol")])
def test_fp8_caught_nan_equals_forced_skip_bitwise(engine, m_codec,
                                                  v_codec):
    """A NaN at micro-batch 1 of step 1 leaves params, m, v and ef bit for
    bit as a forced skip there, one skip counted, the step counter full;
    and the skip took the micro-batch away (the clean run differs)."""
    n = _port_run(engine, m_codec, v_codec, "nan@micro=1,step=1")[-1]
    s = _port_run(engine, m_codec, v_codec, "skip@micro=1,step=1")[-1]
    c = _port_run(engine, m_codec, v_codec)[-1]
    assert _same(n, s) and not _same(n, c)
    assert n["step"] == STEPS == s["step"]
    assert n["metrics"]["skipped_micro_batches"] == 1 == \
        s["metrics"]["skipped_micro_batches"]


def test_fp8_without_error_feedback():
    """error_feedback=False: no "ef" in the state (as the reference's
    use_error_feedback), the wire still quantizes, and the params differ
    from the run with the residual; the reference's run without it agrees
    as the engine check holds params."""
    got = _port_run("adama", "fp32", "fp32", error_feedback=False)
    with_ef = _port_run("adama", "fp32", "fp32")
    assert got[-1]["ef"] is None
    want = _reference_run("adama", "fp32", "fp32", error_feedback=False)
    assert want[-1]["ef"] is None
    assert not np.array_equal(got[-1]["params"], with_ef[-1]["params"])
    for k, (a, b) in enumerate(zip(got, want)):
        assert _share_beyond(a["params"], b["params"], ENGINE_TOL) \
            <= FP8_FLIP_FRAC, k
        np.testing.assert_allclose(a["metrics"]["loss"],
                                   b["metrics"]["loss"], rtol=0,
                                   atol=LOSS_TOL)


@pytest.mark.parametrize("engine", ["adama", "adama_layerwise"])
def test_fp8_dynamic_scale_backs_off_with_a_finite_residual(engine):
    """Dynamic loss scaling on the fp8 wire with a NaN at micro-batch 1 of
    step 1: the scale backs off once (2^15 -> 2^14), one skip, the step
    counter full, the residual finite and non-zero (stored unscaled, so
    the new scale reads it in the same units), the params finite."""
    got = _port_run(engine, "fp32", "fp32", "nan@micro=1,step=1",
                    steps=3, loss_scale="dynamic")
    last = got[-1]
    assert last["metrics"]["loss_scale"] == 2.0 ** 14
    assert last["metrics"]["skipped_micro_batches"] == 1.0
    assert last["step"] == 3
    assert np.isfinite(last["ef"]).all() and np.abs(last["ef"]).max() > 0
    assert all(np.isfinite(x["params"]).all() for x in got)


def test_fp8_cli_runs_on_the_cpu(capsys):
    """`--grad-dtype fp8_e4m3` with dynamic scaling and a NaN backs the
    scale off to 16384; `--no-error-feedback` runs too."""
    base = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "2",
            "--global-batch", "4", "--micro-batches", "2", "--seq-len",
            "16", "--log-every", "1", "--device", "cpu", "--grad-dtype",
            "fp8_e4m3"]
    tlaunch.main(base + ["--loss-scale", "dynamic", "--inject-fault",
                         "nan@micro=1,step=1"])
    out = capsys.readouterr().out
    assert "loss_scale 16384, skipped 1 micro-batches" in out
    tlaunch.main(base + ["--finite-guard", "--no-error-feedback"])
    assert "skipped 0 micro-batches" in capsys.readouterr().out
