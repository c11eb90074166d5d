"""The port's compressed optimizer state (int8 m, int8 v, factored v,
rowcol v) against the reference's, on the CPU:

  - the row helpers (repro_torch.kernels.adama_accum) against
    repro.kernels.adama_accum, bit for bit, on edge rows (rowcol's decode
    to RC_DECODE_TOL: its column total is summed in another order);
  - the plain versions of the codec forms of arena_fold, arena_fold_slice
    and arena_apply against the Pallas kernels (interpret mode), bit for
    bit for every row-local (m, v) pair; the rowcol pairs' row and column
    sums to RC_REL_TOL and their applies to RC_APPLY_TOL, m bit for bit;
  - the codec registry (Conformance, registered_combinations, get_codec,
    the kernel columns) field for field against repro.core.state_store;
  - the engines on reduced stablelm-1.6b with compressed state against the
    reference's engines, and the codecs' declared contracts (never-amplify,
    the adama vs adama_layerwise engine tolerance) on the port itself.

The CUDA forms are held against these plain versions on the card by
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
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.core import state_store as jss
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import adama_accum as jaa
from repro.kernels import fused_step as jfs
from repro.models import model as jmodel
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import adama_accum as taa
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel

torch.set_num_threads(1)

B1, B2 = 0.9, 0.999
LR = 1e-3                          # OptimizerConfig's default
TINY = np.float32(np.finfo(np.float32).tiny)
PAIRS = tss.registered_combinations()
CODEC_PAIRS = [pr for pr in PAIRS if pr != ("fp32", "fp32")]
RC_PAIRS = [pr for pr in PAIRS if pr[1] == "rowcol"]
# Rowcol's sums (a row's 1024 values, a column over the arena, the column
# total of the decode) take XLA's order in the reference and the CUDA
# kernel's fixed partition and trees in the port (kernels/fused_step.py);
# no simple order reproduces XLA CPU's bit for bit, and each lies within a
# few float32 roundings of the exact sum (2.3e-7 relative for the
# reference's). So the row and column sums are held relatively: measured
# 3.5e-7 on a 512-row arena (whole-arena and slice folds) and 3.3e-7 on the
# 64-row edge arena, against RC_REL_TOL. The decode divides by the total
# and multiplies (measured 1.9e-7 on fresh sums, 8.0e-7 after two folds).
# The apply moves p by lr * m / sqrt(v), so a relative difference of v
# moves the update by half of it; p's own rounding adds up to 2 ulps of p
# (measured: 4.1e-7 of the update beyond those 2 ulps).
RC_REL_TOL = 1e-6
RC_DECODE_TOL = 1e-6
RC_APPLY_TOL = 1e-6      # of the update |p - p0|, beside 2 ulps of p


def edge_arenas(rows=64, seed=0, subnormal=True):
    """m, v (fp32), g and p of a small arena whose first rows are the edge
    cases of the codecs: 0 a zero row; 1 rows of m and v whose max/127 is
    subnormal before and after a fold (g ~ 1e-35); 2 subnormal g^2 terms
    and subnormal state entries; 3 values on exact code boundaries (k*s)
    with a zero gradient; 4 a row of one sign; 5 -0.0 in m beside zero
    gradients of both signs. `subnormal=False` leaves rows 1 and 2 random
    (the fp32/fp32 form keeps IEEE subnormals, where the reference flushes
    them: ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    sh = (rows, tfs.LANES)
    m = (rng.standard_normal(sh) * 1e-3).astype(np.float32)
    v = (np.abs(rng.standard_normal(sh)) * 1e-6).astype(np.float32)
    g = rng.standard_normal(sh).astype(np.float32)
    p = (rng.standard_normal(sh) * 0.02).astype(np.float32)
    m[0] = v[0] = g[0] = 0.0
    if subnormal:
        u = rng.random(tfs.LANES).astype(np.float32)
        m[1] = (u - np.float32(0.5)) * np.float32(100) * TINY
        v[1] = u * np.float32(60) * TINY
        g[1] = (rng.standard_normal(tfs.LANES) * 1e-35).astype(np.float32)
        g[2, ::3] = np.float32(1e-20)
        g[2, 1::3] = np.float32(-3e-21)
        m[2, ::5] = np.float32(3e-40)
        v[2, ::7] = np.float32(2e-41)
    s = np.float32(3e-5)
    k = rng.integers(0, 128, tfs.LANES).astype(np.float32)
    k[0] = 127
    v[3] = k * s
    m[3] = (k - np.float32(64)) * s
    g[3] = 0.0
    m[4] = -np.abs(m[4])
    g[4] = -np.abs(g[4])
    m[5, ::2] = -0.0
    g[5, ::4] = 0.0
    g[5, 2::8] = -0.0
    return m, v, g, p


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bits(x):
    """Bytes of an array or tensor (equal bytes: equal bits, signed zeros
    included)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def _assert_bitwise(got, want, label):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), label
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape, (label, k)
        assert np.array_equal(a, b), (label, k, int((a != b).sum()))


# ---------------------------------------------------------------------------
# Row helpers
# ---------------------------------------------------------------------------


def _helper_inputs(seed):
    m, v, g, _ = edge_arenas(seed=seed)
    sub = np.zeros((3, tfs.LANES), np.float32)     # all-subnormal rows
    sub[0, ::3] = np.float32(3e-40)
    sub[1] = np.float32(-2e-39)
    sub[2, 5] = np.float32(1e-38)
    return {"m": np.concatenate([m, m * np.float32(1e4), sub]),
            "v": np.concatenate([v, np.abs(g), np.abs(sub)]),
            "g2": np.concatenate([g * g, sub * sub, np.abs(sub)])}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("helper,data", [
    ("q8_encode_rows", "v"), ("q8s_encode_rows", "m"),
    ("fac_row_stat", "g2")])
def test_row_helpers_bitwise_vs_reference(helper, data, seed):
    """Codes, scales and statistics equal the reference's bit for bit,
    edge rows included (XLA CPU reads subnormals as zero and flushes
    subnormal results; the port spells that out)."""
    x = _helper_inputs(seed)[data]
    want = getattr(jaa, helper)(jnp.asarray(x))
    got = getattr(taa, helper)(_t(x))
    _assert_bitwise(got, want if isinstance(want, tuple) else (want,),
                    helper)
    assert taa.Q8_MAX == jaa.Q8_MAX


@pytest.mark.parametrize("helper", ["q8_decode_rows", "q8s_decode_rows"])
def test_row_decodes_bitwise_vs_reference(helper):
    x = _helper_inputs(0)
    enc = "q8_encode_rows" if helper == "q8_decode_rows" else \
        "q8s_encode_rows"
    q, s = getattr(jaa, enc)(jnp.asarray(x["v" if "s_" not in helper
                                           else "m"]))
    want = getattr(jaa, helper)(q, s)
    got = getattr(taa, helper)(_t(q), _t(s))
    _assert_bitwise(got, want, helper)


def _ulp_below(x):
    return x - np.nextafter(x, np.float32(-np.inf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codecs_keep_their_one_sided_contracts(seed):
    """v_hat >= v (ceil), except the reference's dip of at most one ulp at
    a row's max, where 127 * s can round below it (ROADMAP queue 3 (a)),
    and except values the flush reads as zero; |m_hat| <= |m| with the sign
    kept (truncation toward zero)."""
    x = _helper_inputs(seed)
    v = x["v"][np.all(np.abs(x["v"]) >= TINY, axis=1) |
               np.all(x["v"] == 0, axis=1)]
    q, s = taa.q8_encode_rows(_t(v))
    vh = taa.q8_decode_rows(q, s).numpy()
    rowmax = v.max(axis=1, keepdims=True)
    dip = v - vh
    at_max = v == rowmax
    assert (dip[~at_max] <= 0).all()
    assert (dip[at_max] <= _ulp_below(v[at_max])).all()
    assert (vh - v <= s.numpy()).all()              # error <= the scale
    m = x["m"][np.all((np.abs(x["m"]) >= TINY) | (x["m"] == 0), axis=1)]
    q, s = taa.q8s_encode_rows(_t(m))
    mh = taa.q8s_decode_rows(q, s).numpy()
    assert (np.abs(mh) <= np.abs(m)).all()
    assert (mh * m >= 0).all()
    assert (np.abs(m - mh) <= s.numpy()).all()


# ---------------------------------------------------------------------------
# Codec forms of the three kernels, plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------


def _initial_state(moment, codec, x):
    """One moment in the reference's codec (encoded from fp32 x), as JAX
    arrays and as port tensors."""
    if codec == "fp32":
        j = jnp.asarray(x)
        return j, _t(x)
    if codec == "int8":
        enc = jaa.q8s_encode_rows if moment == "m" else jaa.q8_encode_rows
        j = tuple(enc(jnp.asarray(x)))
    elif codec == "rowcol":
        j = (jnp.sum(jnp.asarray(x), axis=1, keepdims=True),
             jnp.sum(jnp.asarray(x), axis=0, keepdims=True))
    else:
        j = (jaa.fac_row_stat(jnp.asarray(x)),)
    return j, tuple(_t(a) for a in j)


def _rowcol_init(x):
    return (x.sum(1, keepdim=True), x.sum(0, keepdim=True))


def _pair_arenas(m_codec, v_codec, seed=0, rows=64):
    m, v, g, p = edge_arenas(rows, seed,
                             subnormal=(m_codec, v_codec) != ("fp32", "fp32"))
    jm, tm = _initial_state("m", m_codec, m)
    jv, tv = _initial_state("v", v_codec, v)
    return jm, tm, jv, tv, g, p


def _port_arenas(m_codec, v_codec, rows):
    """The port's state alone (encoded by the port's helpers)."""
    m, v, g, p = edge_arenas(rows)
    enc = {"int8": (taa.q8s_encode_rows, taa.q8_encode_rows),
           "factored": (None, lambda x: (taa.fac_row_stat(x),)),
           "rowcol": (None, _rowcol_init)}
    tm = _t(m) if m_codec == "fp32" else enc[m_codec][0](_t(m))
    tv = _t(v) if v_codec == "fp32" else enc[v_codec][1](_t(v))
    return tm, tv, g, p


FOLDS = (dict(scale=1.0, decay=(B1, B2)), dict(scale=0.25, decay=None))


def _rel_gap(got, want):
    """Largest |got - want| / |want| (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    rel = np.divide(d, np.abs(want), out=np.where(d == 0, 0.0, np.inf),
                    where=want != 0)
    return float(rel.max())


def _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv, label):
    """m bit for bit; v bit for bit, or for rowcol each sum within
    RC_REL_TOL of the reference's."""
    _assert_bitwise(tm, jm, f"m {label}")
    if v_codec != "rowcol":
        _assert_bitwise(tv, jv, f"v {label}")
        return
    for k, (a, b) in enumerate(zip(tv, jv)):
        assert a.shape == b.shape, (label, k)
        assert _rel_gap(a.numpy(), b) <= RC_REL_TOL, (label, k,
                                                      _rel_gap(a.numpy(), b))


def _assert_apply_matches(v_codec, tp, jp, p0, label):
    """p bit for bit; for rowcol, each update within RC_APPLY_TOL of the
    reference's, beside 2 ulps of p."""
    if v_codec != "rowcol":
        _assert_bitwise(tp, jp, label)
        return
    got, want = tp.numpy(), np.asarray(jp)
    slack = RC_APPLY_TOL * np.abs(want - p0) + 2 * np.spacing(np.abs(want))
    assert (np.abs(got - want) <= slack).all(), (
        label, float(np.abs(got - want).max()))


@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_fold_plain_version_bitwise_vs_reference(m_codec, v_codec):
    """A first fold (decay fused, scale 1) and a later fold (scale 1/4),
    chained, every column bit for bit (rowcol's sums to RC_REL_TOL)."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec)
    g2 = np.flip(g, 0).copy()
    for grad, kw in zip((g, g2), FOLDS):
        jm, jv = jfs.arena_fold(jm, jv, jnp.asarray(grad), beta1=B1,
                                beta2=B2, m_codec=m_codec, v_codec=v_codec,
                                **kw)
        out = tfs.arena_fold(tm, tv, _t(grad), beta1=B1, beta2=B2,
                             m_codec=m_codec, v_codec=v_codec, **kw)
        assert out[0] is tm and out[1] is tv               # in place
        _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv, str(kw))


@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_slice_fold_plain_version_bitwise_vs_reference(m_codec, v_codec):
    """Rows [16, 48) folded (block 16), with and without the decay; the
    rows outside keep their bits (rowcol's shared column sums take the
    slab's, undecayed)."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=3)
    rows_of = [x for st, mo, name in ((tm, "m", m_codec), (tv, "v", v_codec))
               for x, c in zip(tfs._as_parts(st)[0],
                               tfs.kernel_codec(mo, name).cols)
               if c.row_indexed]
    before = [x.clone() for x in rows_of]
    for off, kw in ((16, FOLDS[0]), (0, FOLDS[1])):
        slab = g[off + 8:off + 40] if off else g[32:64]
        jm, jv = jfs.arena_fold_slice(jm, jv, jnp.asarray(slab), off,
                                      beta1=B1, beta2=B2, block=16,
                                      m_codec=m_codec, v_codec=v_codec,
                                      **kw)
        tfs.arena_fold_slice(tm, tv, _t(slab), off, beta1=B1, beta2=B2,
                             block=16, m_codec=m_codec, v_codec=v_codec,
                             **kw)
        _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv,
                              f"off={off}")
        if off:
            for x, x0 in zip(rows_of, before):
                assert torch.equal(x[:16], x0[:16])
                assert torch.equal(x[48:], x0[48:])
    with pytest.raises(ValueError, match="multiples of the block"):
        tfs.arena_fold_slice(tm, tv, _t(g[:24]), 8, beta1=B1, beta2=B2,
                             block=16, m_codec=m_codec, v_codec=v_codec)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_apply_plain_version_bitwise_vs_reference(m_codec, v_codec, wd):
    """The apply after a fold, decoding both moments in-pass."""
    jm, tm, jv, tv, g, p = _pair_arenas(m_codec, v_codec, seed=4)
    jm, jv = jfs.arena_fold(jm, jv, jnp.asarray(g), beta1=B1, beta2=B2,
                            decay=(B1, B2), m_codec=m_codec, v_codec=v_codec)
    tfs.arena_fold(tm, tv, _t(g), beta1=B1, beta2=B2, decay=(B1, B2),
                   m_codec=m_codec, v_codec=v_codec)
    t = np.float32(1)
    bc1 = np.float32(1) - np.float32(B1) ** t
    bc2 = np.float32(1) - np.float32(B2) ** t
    kw = dict(lr=np.float32(LR), bc1=bc1, bc2=bc2, eps=1e-8,
              weight_decay=wd, m_codec=m_codec, v_codec=v_codec)
    jp = jfs.arena_apply(jnp.asarray(p), jm, jv, **kw)
    tp = _t(p)
    assert tfs.arena_apply(tp, tm, tv, **kw) is tp
    _assert_apply_matches(v_codec, tp, jp, p, "p")


@pytest.mark.parametrize("m_codec,v_codec", CODEC_PAIRS)
def test_codec_forms_reject_malformed_columns(m_codec, v_codec):
    tm, tv, g, p = _port_arenas(m_codec, v_codec, 64)
    mp = tfs._as_parts(tm)[0]
    kw = dict(beta1=B1, beta2=B2, m_codec=m_codec, v_codec=v_codec)
    with pytest.raises(ValueError, match="columns"):
        tfs.arena_fold(mp + (mp[0],), tv, _t(g), **kw)
    with pytest.raises(ValueError, match="column must be"):
        tfs.arena_fold(tuple(x[:32] for x in mp) if len(mp) > 1 else
                       mp[0][:32], tv, _t(g), **kw)
    with pytest.raises(TypeError, match="column must be"):
        tfs.arena_apply(_t(p), tm, tuple(x.double() for x in
                                         tfs._as_parts(tv)[0]),
                        lr=LR, bc1=0.1, bc2=0.001, m_codec=m_codec,
                        v_codec=v_codec)


@pytest.mark.parametrize("m_codec,v_codec", CODEC_PAIRS)
def test_codec_launch_arguments_match_the_declared_c_signatures(m_codec,
                                                                v_codec):
    """ctypes converts every argument the codec wrappers pass: the kinds
    and g's wire as int, a one-column codec's second pointer as NULL, the
    slice's offset and rows as int64, the scalars as float32. The apply's
    p is followed by the master form's work pointer (NULL for the plain
    form), so its moments' pointers sit one position later."""
    import ctypes
    mk, vk = tfs.kernel_codec("m", m_codec), tfs.kernel_codec("v", v_codec)
    tm, tv, g, p = _port_arenas(m_codec, v_codec, 8)
    mp, vp = tfs._as_parts(tm)[0], tfs._as_parts(tv)[0]
    g, p = _t(g), _t(p)
    scratch = tfs.fold_scratch(vk, 4, g.device)
    cases = {"arena_fold_launch": tfs.fold_args(
                 mk, vk, mp, vp, g[:4], 4, B1, B2, 0.125, (B1, B2),
                 scratch),
             "arena_apply_launch": tfs.apply_args(
                 mk, vk, p, mp, vp, 1e-3, 0.1, 0.001, 1e-8, 0.01)}
    calls = {}
    for name, args in cases.items():
        got = []
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *tfs.SIGNATURES[name])
        assert proto(lambda *a: got.append(a) or 0)(*args, 0) == 0
        calls[name] = got[0]
        assert got[0][:2] == (mk.kind, vk.kind)
        if name.startswith("arena_fold"):
            ptrs = got[0][2:7]
            assert ptrs[0] == mp[0].data_ptr()
        else:
            assert got[0][2:4] == (p.data_ptr(), None)
            ptrs = (p.data_ptr(),) + got[0][4:8]
            assert got[0][8] == p.shape[0]
        assert sum(x is None for x in ptrs) == 4 - len(mp) - len(vp)
        assert got[0][len(args) - 5:len(args)] == tuple(
            float(np.float32(s)) for s in args[-5:])
    # g's wire (0: fp32), then the slice's offset and rows
    assert cases["arena_fold_launch"][7:10] == (0, 4, 4)
    # rowcol's partition of the 4 rows and its scratch; none for the others
    want = ((1, 64, scratch[2].data_ptr()) if v_codec == "rowcol"
            else (0, 0, None))
    assert calls["arena_fold_launch"][10:13] == want


def test_cpu_codec_forms_count_no_launch(monkeypatch):
    from repro_torch.kernels import build

    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    before = (tfs.arena_fold.launches, tfs.arena_fold_slice.launches,
              tfs.arena_apply.launches)
    tm, tv, g, p = _port_arenas("int8", "factored", 16)
    kw = dict(m_codec="int8", v_codec="factored")
    tfs.arena_fold(tm, tv, _t(g), beta1=B1, beta2=B2, **kw)
    tfs.arena_fold_slice(tm, tv, _t(g[:8]), 8, beta1=B1, beta2=B2, block=8,
                         **kw)
    tfs.arena_apply(_t(p), tm, tv, lr=LR, bc1=0.1, bc2=0.001, **kw)
    assert (tfs.arena_fold.launches, tfs.arena_fold_slice.launches,
            tfs.arena_apply.launches) == before


# ---------------------------------------------------------------------------
# Rowcol: its decode, its sums' order, and slice folds as Algorithm 2 runs
# them
# ---------------------------------------------------------------------------


def _rowcol_arenas(rows, seed):
    """m, v (fp32), g and p of a `rows`-row arena of random rows (no edge
    rows): the rowcol tests' inputs."""
    rng = np.random.default_rng(seed)
    sh = (rows, tfs.LANES)
    return ((rng.standard_normal(sh) * 1e-3).astype(np.float32),
            (np.abs(rng.standard_normal(sh)) * 1e-6).astype(np.float32),
            rng.standard_normal(sh).astype(np.float32),
            (rng.standard_normal(sh) * 0.02).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rowcol_decode_vs_reference(seed):
    """v_hat = vr * vc / max(sum(vc), 1e-30) within RC_DECODE_TOL of the
    reference's (its column total sums in XLA's order; measured 1.9e-7),
    zero rows to exactly zero."""
    _, v, _, _ = _rowcol_arenas(96, seed)
    v[5] = 0.0
    vr = v.sum(1, keepdims=True, dtype=np.float32)
    vc = v.sum(0, keepdims=True, dtype=np.float32)
    want = np.asarray(jaa.rowcol_decode(jnp.asarray(vr), jnp.asarray(vc)))
    got = taa.rowcol_decode(_t(vr), _t(vc)).numpy()
    assert got.shape == want.shape == v.shape
    assert _rel_gap(got, want) <= RC_DECODE_TOL
    assert (got[5] == 0).all()
    # the codec's host decode is the same function
    st = tss.MomentState((_t(vr), _t(vc)), None, "rowcol", "v")
    assert np.array_equal(st.decode().numpy(), got)


# the reference's rowcol property tests (tests/test_codec_properties.py)
# on the port's decode, at fixed draws
ROWCOL_ROWS = 64


@pytest.mark.parametrize("seed,scale_exp,zero_row", [
    (0, 0.0, False), (1, -20.0, True), (2, 3.0, False), (3, -7.5, True)])
def test_rowcol_rank1_reconstruction_exact(seed, scale_exp, zero_row):
    """The Adafactor guarantee: when v IS rank one, its marginals
    reconstruct it (to float32 rounding); a zero row decodes to zeros."""
    rng = np.random.RandomState(seed)
    r = rng.rand(ROWCOL_ROWS).astype(np.float32) * np.float32(10.0) ** \
        np.float32(scale_exp)
    c = rng.rand(tfs.LANES).astype(np.float32)
    if zero_row:
        r[0] = 0.0
    v = np.outer(r, c).astype(np.float32)
    vhat = taa.rowcol_decode(_t(v.sum(axis=1, keepdims=True)),
                             _t(v.sum(axis=0, keepdims=True))).numpy()
    np.testing.assert_allclose(vhat, v, rtol=2e-4, atol=1e-30)
    if zero_row:
        assert (vhat[0] == 0).all()


@pytest.mark.parametrize("seed,scale_exp,rank", [
    (0, 0.0, 1), (1, -20.0, 3), (2, 3.0, 8), (3, -5.0, 2)])
def test_rowcol_marginals_and_error_bound(seed, scale_exp, rank):
    """For general non-negative v the reconstruction keeps both marginals
    and |v_hat - v| <= min(row sum, column sum)."""
    rng = np.random.RandomState(seed)
    scale = np.float64(10.0) ** np.float64(scale_exp)
    v = sum(np.outer(rng.rand(ROWCOL_ROWS), rng.rand(tfs.LANES))
            for _ in range(rank)) * scale
    vr = v.sum(axis=1, keepdims=True)
    vc = v.sum(axis=0, keepdims=True)
    vhat = taa.rowcol_decode(_t(vr.astype(np.float32)),
                             _t(vc.astype(np.float32))).numpy()
    vhat = vhat.astype(np.float64)
    assert (vhat >= 0).all()
    np.testing.assert_allclose(vhat.sum(axis=1), vr[:, 0], rtol=1e-3)
    np.testing.assert_allclose(vhat.sum(axis=0), vc[0], rtol=1e-3)
    cap = np.minimum(vr, vc)
    assert (np.abs(vhat - v) <= cap * (1 + 1e-3) + 1e-30).all()


@pytest.mark.parametrize("rows", [1, 8, 64, 65, 1000, 49_153, 50_240,
                                  401_472, 1_607_424, 10_000_000])
def test_rowcol_partition_depends_on_the_row_count_only(rows):
    """The ranges cover the rows, none empty, at most RC_MAX_RANGES of at
    least RC_MIN_RANGE_ROWS rows (the scratch stays within 3 MiB); the
    same count gives the same partition whatever else differs (it takes
    no device, SM count or chunk size)."""
    ranges, rr = tfs.rowcol_partition(rows)
    assert (ranges - 1) * rr < rows <= ranges * rr
    assert 1 <= ranges <= tfs.RC_MAX_RANGES and rr >= tfs.RC_MIN_RANGE_ROWS
    assert tfs.rowcol_partition(rows) == (ranges, rr)
    _, _, buf = tfs.fold_scratch(tfs.kernel_codec("v", "rowcol"), rows,
                                 "meta")
    assert buf.numel() * 4 == 4 * (ranges * tfs.LANES + 4) <= 3 * 2**20 + 16


@pytest.mark.parametrize("m_codec", ["fp32", "int8"])
def test_rowcol_plain_sums_take_the_partition_not_the_chunks(m_codec,
                                                             monkeypatch):
    """The plain fold's column sums follow rowcol_partition: the chunk
    sizes that bound its temporaries change no bit (a 1000-row arena, 16
    ranges, the last one short)."""
    m, v, g, _ = _rowcol_arenas(1000, 4)
    outs = []
    for chunk, col_rows in ((16384, 1 << 17), (24, 100), (7, 1)):
        monkeypatch.setattr(tfs, "_PLAIN_CHUNK_ROWS", chunk)
        monkeypatch.setattr(tfs, "_PLAIN_COL_ROWS", col_rows)
        tm = _t(m) if m_codec == "fp32" else taa.q8s_encode_rows(_t(m))
        tv = _rowcol_init(_t(v))
        tfs.arena_fold(tm, tv, _t(g), beta1=B1, beta2=B2, decay=(B1, B2),
                       m_codec=m_codec, v_codec="rowcol")
        outs.append(tfs._as_parts(tm)[0] + tv)
    for other in outs[1:]:
        _assert_bitwise(other, outs[0], "chunked")


@pytest.mark.parametrize("m_codec", ["fp32", "int8"])
def test_rowcol_whole_arena_folds_vs_reference(m_codec):
    """Two whole-arena folds through the state store on a 512-row arena (8
    ranges): with the decay (the column sums decayed on the host first, as
    the reference's fold does), then without; the sums within RC_REL_TOL
    (measured 3.4e-7), m bit for bit, then the apply (RC_APPLY_TOL)."""
    m, v, g, p = _rowcol_arenas(512, 5)
    jm, tm = _initial_state("m", m_codec, m)
    jv, tv = _initial_state("v", "rowcol", v)
    jmp, jvp = (jm if m_codec != "fp32" else (jm,)), jv
    tmp, tvp = (tm if m_codec != "fp32" else (tm,)), tv
    for grad, kw in zip((g, np.flip(g, 0).copy()), FOLDS):
        jmp, jvp = jss.fold(m_codec, "rowcol", jmp, jvp, jnp.asarray(grad),
                            beta1=B1, beta2=B2, **kw)
        tss.fold(m_codec, "rowcol", tmp, tvp, _t(grad), beta1=B1, beta2=B2,
                 **kw)
        _assert_state_matches(m_codec, "rowcol", tmp, jmp, tvp, jvp, str(kw))
    kw = dict(lr=np.float32(LR), bc1=np.float32(0.19),
              bc2=np.float32(0.001999), eps=1e-8)
    jp = jss.apply(m_codec, "rowcol", jnp.asarray(p), jmp, jvp, **kw)
    tp = _t(p)
    tss.apply(m_codec, "rowcol", tp, tmp, tvp, **kw)
    _assert_apply_matches("rowcol", tp, jp, p, "p")


@pytest.mark.parametrize("m_codec", ["fp32", "int8"])
def test_rowcol_slice_folds_with_one_replicated_decay_vs_reference(m_codec):
    """Algorithm 2's schedule on a 512-row arena: the column sums decayed
    once (begin_micro_state), then slice folds covering every row in
    backward order, each with the row-indexed decay fused; a second
    micro-batch with the identity decay. Sums within RC_REL_TOL, m bit for
    bit."""
    m, v, g, _ = _rowcol_arenas(512, 6)
    jm, tm = _initial_state("m", m_codec, m)
    jv, tv = _initial_state("v", "rowcol", v)
    lay = jarena.build_layout({"w": jnp.zeros((512 * tfs.LANES,))})
    jst = {"m": jss.get_codec(m_codec, "m").wrap(lay, jm if m_codec != "fp32"
                                                  else (jm,)),
           "v": jss.get_codec("rowcol", "v").wrap(lay, jv),
           "step": jnp.zeros((), jnp.int32)}
    tst = {"m": tss.MomentState(tm if m_codec != "fp32" else (tm,), None,
                                m_codec, "m"),
           "v": tss.MomentState(tv, None, "rowcol", "v")}
    if m_codec == "fp32":
        tst["m"] = tarena.Arena(tm, None)
    slices = ((384, 128), (128, 256), (0, 128))
    for mb, decay in enumerate(((B1, B2), (1.0, 1.0))):
        jst = jss.begin_micro_state(jst, decay)
        tss.begin_micro_state(tst, decay)
        for off, n in slices:
            slab = np.roll(g, mb, 0)[off:off + n]
            jst = jss.fold_slice_state(jst, jnp.asarray(slab), off, beta1=B1,
                                       beta2=B2, block=64, decay=decay)
            tss.fold_slice_state(tst, _t(slab), off, beta1=B1, beta2=B2,
                                 block=64, decay=decay)
        _assert_state_matches(
            m_codec, "rowcol",
            tss.codec_of(tst["m"], "m").parts_of(tst["m"]),
            jss.codec_of(jst["m"], "m").parts_of(jst["m"]),
            tst["v"].parts, jst["v"].parts, f"micro-batch {mb}")


def test_rowcol_state_bytes_on_the_stablelm_layout():
    """int8/rowcol state over stablelm-1.6b's arena (1,607,424 rows): m's
    codes and row scales, v's row sums and ONE (1, 1024) block of column
    sums: 1,658,865,664 B (MomentCodec.init makes the shared column
    (1, width), and optimizer_state_bytes counts it once)."""
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jax_get_config("stablelm_1_6b"),
                                   jax.random.key(0)))
    tree = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"),
                        shapes)
    lay = tarena.build_layout(tree)
    assert lay.rows == 1_607_424
    st = {"m": tss.get_codec("int8", "m").init(lay, "meta"),
          "v": tss.get_codec("rowcol", "v").init(lay, "meta")}
    assert [tuple(x.shape) for x in st["v"].parts] == [(lay.rows, 1),
                                                       (1, tfs.LANES)]
    assert tss.optimizer_state_bytes(st) == 1_658_865_664


def test_rowcol_scale_and_begin_micro_match_the_reference():
    """scale_state decays both marginals, begin_micro the column sums only,
    bit for bit with the reference's (XLA flushes subnormal products)."""
    _, v, _, _ = _rowcol_arenas(64, 7)
    v[3, :7] = np.float32(3e-38)
    vr = v.sum(1, keepdims=True, dtype=np.float32)
    vc = v.sum(0, keepdims=True, dtype=np.float32)
    vc[0, 3] = np.float32(2e-38)
    lay = jarena.build_layout({"w": jnp.zeros((64 * tfs.LANES,))})
    jc, tc = jss.get_codec("rowcol"), tss.get_codec("rowcol")
    want = jc.scale_state(jc.wrap(lay, (jnp.asarray(vr), jnp.asarray(vc))),
                          B2)
    got = tc.scale_state(tss.MomentState((_t(vr), _t(vc)), None, "rowcol"),
                         B2)
    _assert_bitwise(got.parts, want.parts, "scale_state")
    parts = (_t(vr), _t(vc))
    want = jc.begin_micro((jnp.asarray(vr), jnp.asarray(vc)), 0.5)
    assert tc.begin_micro(parts, 0.5) is parts
    _assert_bitwise(parts, want, "begin_micro")
    assert np.array_equal(parts[0].numpy(), vr)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_registered_combinations_are_the_references_but_rowcol():
    """Every (m, v) pair of the reference's registry, rowcol's included
    since it was ported (the name dates from before)."""
    want = jss.registered_combinations()
    assert tss.registered_combinations() == want
    assert len(want) == 8


@pytest.mark.parametrize("moment,name", [
    (mo, n) for mo, reg in (("m", tss.M_CODECS), ("v", tss.V_CODECS))
    for n in sorted(reg)])
def test_conformance_and_columns_match_the_reference(moment, name):
    """Each ported codec declares the reference's contract field for field,
    and its kernel columns are the reference's (width, dtype,
    row_indexed)."""
    want, got = jss.get_codec(name, moment), tss.get_codec(name, moment)
    assert dataclasses.asdict(got.conformance) == \
        dataclasses.asdict(want.conformance)
    assert [f.name for f in dataclasses.fields(tss.Conformance)] == \
        [f.name for f in dataclasses.fields(jss.Conformance)]
    assert got.name == name and got.moment == moment
    assert [(c.width, str(c.dtype).replace("torch.", ""), c.row_indexed)
            for c in got.kernel.cols] == \
        [(c.width, jnp.dtype(c.dtype).name, c.row_indexed)
         for c in want.kernel.cols]


@pytest.mark.parametrize("moment,name,err", [
    ("v", "rowcol", None), ("v", "nope", KeyError),
    ("m", "nope", KeyError), ("m", "factored", KeyError),
    ("m", "rowcol", KeyError)])
def test_get_codec_errors_match_the_reference(moment, name, err):
    """Unknown names raise the reference's KeyError; a known one (the v
    codec rowcol) resolves on both sides."""
    if err is None:
        assert jss.get_codec(name, moment).name == \
            tss.get_codec(name, moment).name == name
        return
    with pytest.raises(KeyError, match="unknown"):
        jss.get_codec(name, moment)
    with pytest.raises(err, match="unknown"):
        tss.get_codec(name, moment)


@pytest.mark.parametrize("kw,err", [
    (dict(state_codec="rowcol"), None),
    (dict(state_codec="nope"), ValueError),
    (dict(m_codec="factored"), ValueError),
    (dict(state_codec="int8", arena=False), ValueError),
    (dict(m_codec="int8", arena=False), ValueError)])
def test_optimizer_config_validates_codecs(kw, err):
    """As the reference's optimizer_capability: known names only, and a
    compressed codec requires arena state; rowcol builds with either m
    codec and every arena engine."""
    ref_kw = {k: v for k, v in kw.items() if k != "arena"}
    if err is None:
        for engine in ("ga", "adama", "adama_layerwise"):
            for m_codec in ("fp32", "int8"):
                JaxOptimizerConfig(name="adama", use_pallas=True, arena=True,
                                   accumulation=engine, m_codec=m_codec,
                                   **ref_kw)
                OptimizerConfig(accumulation=engine, m_codec=m_codec, **kw)
        return
    with pytest.raises(ValueError):
        JaxOptimizerConfig(name="adama", use_pallas=True,
                           arena=kw.get("arena", True), **ref_kw)
    with pytest.raises(err):
        OptimizerConfig(**kw)
    OptimizerConfig(state_codec="factored", m_codec="int8")


def test_moment_state_decodes_and_scales_in_codec_space():
    """init -> fold -> decode equals the reference's decode; scale_state
    (the begin-minibatch decay in codec space) touches the int8 scales
    only, as the reference's does, bit for bit. begin_minibatch refuses
    arena state: the arena engines fuse the decay into the first fold."""
    from repro_torch.core import adama
    params = {"w": torch.zeros(3, 5), "b": torch.zeros(7)}
    state = adama.init_arena(params, codec="int8", m_codec="int8")
    lay = state["m"].layout
    g = np.random.default_rng(0).standard_normal(
        (lay.rows, tfs.LANES)).astype(np.float32)
    tss.fold_state(state, _t(g), beta1=B1, beta2=B2, decay=(B1, B2))
    jstate = {"m": jss.get_codec("int8", "m").init(
        jarena.build_layout({"w": jnp.zeros((3, 5)), "b": jnp.zeros(7)})),
              "v": jss.get_codec("int8", "v").init(
        jarena.build_layout({"w": jnp.zeros((3, 5)), "b": jnp.zeros(7)})),
              "step": jnp.zeros((), jnp.int32)}
    jstate = jss.fold_state(jstate, jnp.asarray(g), beta1=B1, beta2=B2,
                            decay=(B1, B2))
    for k in ("m", "v"):
        _assert_bitwise(state[k].decode().contiguous(), jstate[k].decode(),
                        k)
    codes = state["m"].parts[0].clone()
    with pytest.raises(ValueError, match="first fold"):
        adama.begin_minibatch(state, B1, B2)
    for k, c in (("m", B1), ("v", B2)):
        tss.codec_of(state[k], k).scale_state(state[k], c)
    assert torch.equal(state["m"].parts[0], codes)
    for k, c in (("m", B1), ("v", B2)):
        want = jss.codec_of(jstate[k], k).scale_state(jstate[k], c)
        _assert_bitwise(state[k].parts, want.parts, f"{k} decay")
    assert tss.optimizer_state_bytes(state) == 2 * lay.rows * (1024 + 4)


# ---------------------------------------------------------------------------
# Engines on reduced stablelm-1.6b
# ---------------------------------------------------------------------------

ARCH, N_MICRO, GLOBAL_BATCH, SEQ, STEPS = "stablelm_1_6b", 2, 4, 16, 2
ENGINE_CODEC_PAIRS = [("int8", "int8"), ("int8", "factored"),
                      ("fp32", "rowcol"), ("int8", "rowcol")]
# The port and the reference differ in their model's float32 rounding
# (~1e-7), so a code near a boundary can round the other way. Such a flip
# moves p by at most the codec's declared drift_lr x lr per mini-batch, and
# the pair's bound is the sum over its codecs, as the reference's
# conformance test sums them. So each param step is held two ways
# (`_assert_params_close`): every element within FP32_ENGINE_TOL + that
# bound, and at most CODE_FLIP_FRAC of the elements beyond FP32_ENGINE_TOL
# (5e-6, Fp32Codec's engine_tol and the fp32 engine parity tests',
# tests/test_torch_engines.py). A wrong, missing or sign-flipped update
# moves nearly every element by ~lr and fails the second. Factored declares
# no drift (drift_lr None) and its statistic is an order-free row max; its
# flips come from m's int8 codes. Measured (2 steps, per step): int8/int8
# beyond 5e-6 0.32% and 2.87% of the elements, largest 2.6e-4 and 3.9e-4
# (bound 4.0e-3); int8/factored 0.066% and 0.45%, 1.0e-5 and 2.1e-5 (bound
# 2.0e-3); losses within 5.3e-6. fp32/rowcol: every element within 1.2e-7
# (its sums' other order), losses within 9.6e-7; int8/rowcol: 0.28% and
# 2.6% beyond 5e-6, largest 1.7e-4 and 2.4e-4 (bound 2.0e-3). With rowcol v
# the flips of int8 m move the next loss more (rowcol's v_hat sits below v
# where v is not rank one, so those updates are larger): int8/rowcol's
# step-2 loss differs by 1.8e-5 (adama, adama_layerwise), so a pair with
# int8 m and rowcol v holds its losses after step 1 to LOSS_FLIP_TOL; step
# 1, before any apply, to 1e-5 as every pair.
FP32_ENGINE_TOL = 5e-6
CODE_FLIP_FRAC = 0.06
LOSS_TOL = 1e-5
LOSS_FLIP_TOL = 5e-5


def _assert_params_close(p, want, m_codec, v_codec, label):
    drift = sum(tss.get_codec(n, mo).conformance.drift_lr or 0.0
                for mo, n in (("m", m_codec), ("v", v_codec)))
    d = np.abs(p - want)
    off = float((d > FP32_ENGINE_TOL).mean())
    assert off <= CODE_FLIP_FRAC, (label, off)
    assert d.max() <= FP32_ENGINE_TOL + drift * LR, (label, d.max())


def _data():
    cfg = get_config(ARCH).reduced()
    data = make_data(cfg, SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _init_params():
    """The reference's initial params (numpy), shared by both sides."""
    return jax.tree.map(np.asarray,
                        jmodel.init_params(tiny(ARCH), jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _reference_run(engine, m_codec, v_codec):
    cfg = tiny(ARCH)
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, state_codec=v_codec,
                             m_codec=m_codec)
    step, init = jax_make_train_step(cfg, opt)
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _init_params())
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _data():
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]),
                    np.asarray(jarena.pack(params, layout))))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(engine, m_codec, v_codec, micro_batches=N_MICRO, steps=STEPS):
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    opt = OptimizerConfig(accumulation=engine, micro_batches=micro_batches,
                          state_codec=v_codec, m_codec=m_codec)
    tree = tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                    "cpu")).tree()
    step, init = make_train_step(cfg, opt)
    state = init(tree)
    out = []
    for batch in _data()[:steps]:
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            out.append((float(metrics["loss"]),
                        tarena.pack(tree, state["m"].layout).numpy().copy()))
    return out, state


@pytest.mark.parametrize("engine", ["adama", "ga", "adama_layerwise"])
@pytest.mark.parametrize("m_codec,v_codec", ENGINE_CODEC_PAIRS)
def test_engine_with_compressed_state_matches_reference(engine, m_codec,
                                                        v_codec):
    """Two steps of each engine with the same codecs as the reference's:
    equal losses (the codecs act only from the first apply), params within
    the pair's tolerances (`_assert_params_close`; measured: see the
    comment above)."""
    want = _reference_run(engine, m_codec, v_codec)
    got, state = _port_run(engine, m_codec, v_codec)
    assert state["step"] == STEPS
    assert isinstance(state["v"], tss.MomentState)
    flips = m_codec == "int8" and v_codec == "rowcol"
    for k, ((loss, p), (wloss, wp)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            loss, wloss, rtol=0,
            atol=LOSS_FLIP_TOL if flips and k else LOSS_TOL)
        _assert_params_close(p, wp, m_codec, v_codec, f"step {k + 1}")


@pytest.mark.parametrize("m_codec,v_codec", [
    pr for pr in CODEC_PAIRS
    if all(tss.get_codec(n, mo).conformance.never_amplify
           for mo, n in zip(("m", "v"), pr))])
def test_never_amplify_on_a_single_fold_minibatch(m_codec, v_codec):
    """The pairs whose codecs declare never-amplify (rowcol does not, as
    in the reference's conformance suite): with one fold per mini-batch
    the compressed state's update is elementwise no larger than
    fp32/fp32's (int8 m shrinks |m|, int8 and factored v only
    over-estimate v)."""
    m_conf = tss.get_codec(m_codec, "m").conformance
    v_conf = tss.get_codec(v_codec, "v").conformance
    assert m_conf.never_amplify and v_conf.never_amplify
    tree = tmodel.params_from_jax(_init_params(), "cpu")
    p0 = tarena.pack(tree, tarena.build_layout(tree)).numpy()
    (_, pf), = _port_run("adama", "fp32", "fp32", 1, 1)[0]
    (_, pc), = _port_run("adama", m_codec, v_codec, 1, 1)[0]
    assert (np.abs(pc - p0) <= np.abs(pf - p0) + 1e-8).all()
    assert np.abs(pc - pf).max() > 0                  # the codec acted


# adama vs adama_layerwise on rowcol state: the column sums of whole-arena
# and slice folds take other partitions, so the params differ by roundings
# (measured 1.2e-7 after one step, both rowcol pairs), far inside rowcol's
# declared engine_tol (2e-3)
RC_ENGINE_TOL = 1e-6


@pytest.mark.parametrize("m_codec,v_codec", CODEC_PAIRS)
def test_layerwise_engine_matches_adama_within_engine_tol(m_codec, v_codec):
    """Algorithm 2 (per-layer slice folds) and Algorithm 1 (whole-arena
    folds) on the same codec pair agree within the pair's declared
    engine_tol after one step (measured: bit for bit, every row-local
    pair), rowcol's within RC_ENGINE_TOL."""
    tol = max(tss.get_codec(m_codec, "m").conformance.engine_tol,
              tss.get_codec(v_codec, "v").conformance.engine_tol)
    if v_codec == "rowcol":
        tol = RC_ENGINE_TOL
    (la, pa), = _port_run("adama", m_codec, v_codec, steps=1)[0]
    (ll, pl), = _port_run("adama_layerwise", m_codec, v_codec, steps=1)[0]
    assert abs(la - ll) < 1e-5
    assert np.abs(pa - pl).max() < tol
