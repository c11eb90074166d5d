"""The port's fused fold/apply (repro_torch.kernels.fused_step) against the
reference's Pallas kernels (repro.kernels.fused_step, interpret mode on the
CPU), bit for bit, plus the wrappers' input checks and CPU dispatch. The
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_step as jfs
from repro_torch.core import adama, state_store
from repro_torch.kernels import adama_accum as tacc
from repro_torch.kernels import build
from repro_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

B1, B2 = 0.9, 0.999


def _arenas(rows, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, tfs.LANES)
    m = rng.standard_normal(shape).astype(np.float32) * 1e-3
    v = np.abs(rng.standard_normal(shape).astype(np.float32)) * 1e-6
    v[0, :7] = 0.0                                  # sqrt(0) + eps path
    g = rng.standard_normal(shape).astype(np.float32)
    g[0, 7:11] = 0.0
    p = rng.standard_normal(shape).astype(np.float32) * 0.02
    return m, v, g, p


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("rows", [8, 256, 1280])
def test_fold_plain_version_bitwise_vs_reference(rows):
    """First fold of a mini-batch (decay fused in) and a later fold with
    scale 1/4, chained, against the Pallas kernel."""
    m, v, g, _ = _arenas(rows)
    g2 = np.flip(g, 0).copy()
    jm, jv = jnp.asarray(m), jnp.asarray(v)
    tm, tv = _t(m), _t(v)
    for grad, kw in ((g, dict(scale=1.0, decay=(B1, B2))),
                     (g2, dict(scale=1.0 / 4, decay=None))):
        jm, jv = jfs.arena_fold(jm, jv, jnp.asarray(grad), beta1=B1,
                                beta2=B2, **kw)
        out = tfs.arena_fold(tm, tv, _t(grad), beta1=B1, beta2=B2, **kw)
        assert out[0] is tm and out[1] is tv          # in place
        assert np.array_equal(np.asarray(jm), tm.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("rows", [8, 256, 1280])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_apply_plain_version_bitwise_vs_reference(rows, wd):
    m, v, _, p = _arenas(rows, seed=1)
    t = np.float32(3)
    lr = np.float32(1e-3)
    bc1 = np.float32(1) - np.float32(B1) ** t
    bc2 = np.float32(1) - np.float32(B2) ** t
    jp = jfs.arena_apply(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                         lr=lr, bc1=bc1, bc2=bc2, eps=1e-8, weight_decay=wd)
    tp = _t(p)
    assert tfs.arena_apply(tp, _t(m), _t(v), lr=lr, bc1=bc1, bc2=bc2,
                           eps=1e-8, weight_decay=wd) is tp
    assert np.array_equal(np.asarray(jp), tp.numpy())


def _round_to_f32(r):
    """Exact rational -> nearest float32, ties to even."""
    from fractions import Fraction
    f = np.float32(float(r))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - r),
                                     int(np.array(x).view(np.int32)) & 1))


def test_fma32_is_a_correctly_rounded_fused_multiply_add():
    from fractions import Fraction
    rng = np.random.default_rng(2)
    a = rng.standard_normal(2048).astype(np.float32)
    b = (rng.standard_normal(2048) * 1e-3).astype(np.float32)
    c = (rng.standard_normal(2048) * 1e-4).astype(np.float32)
    # hard cases: exact cancellation, near-ties, tiny addends, subnormals
    a[:6] = [1.0, 1.0 + 2 ** -23, 3.0, 1e-20, -2.0, 1.5]
    b[:6] = [1.0, 1.0 - 2 ** -23, 1.0 / 3, 1e-20, 2.0 ** -24, 2.0 ** -130]
    c[:6] = [-1.0, -1.0, 2 ** -40, 1e-45, 1.0, 0.0]
    # double-rounding cases: a*b = +-(2^-24 - 2^-60) onto c = 1 + 2^-23,
    # and +-(2^-150 - 2^-186) onto the subnormal c = (2^22 + 1) 2^-149;
    # the exact sum lies 2^-60 (2^-186) off a float32 midpoint, the
    # float64 sum on it, and float32 ties to even round it the wrong way
    # (the CPU path's tie branch)
    near = (1 + 2 ** -18, 1 - 2 ** -18)
    for i, (scale, z) in enumerate(((2.0 ** -12, 1 + 2 ** -23),
                                    (2.0 ** -75, (2 ** 22 + 1) * 2.0 ** -149))):
        a[6 + 2 * i:8 + 2 * i] = [scale * near[0], -scale * near[0]]
        b[6 + 2 * i:8 + 2 * i] = scale * near[1]
        c[6 + 2 * i:8 + 2 * i] = z
    got = tfs._fma32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_round_to_f32(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    assert np.array_equal(got, want)
    assert np.array_equal(tacc._fma32_exact(_t(a), _t(b), _t(c)).numpy(),
                          want)
    # the float64 sum rounded once more is wrong on each of them
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice[6:10] != want[6:10]).all()
    assert np.abs(want[8:10]).max() < np.finfo(np.float32).tiny
    # and it is not the twice-rounded a*b + c
    assert not np.array_equal(got, a * b + c)


@pytest.mark.parametrize("bad, err", [
    (lambda m: m.double(), TypeError),
    (lambda m: m[:, :512], ValueError),
    (lambda m: m.reshape(-1), ValueError),
    (lambda m: m.t().contiguous().t(), ValueError),
    (lambda m: m[:4], ValueError),
])
def test_wrappers_reject_malformed_operands(bad, err):
    m, v, g, p = (_t(x) for x in _arenas(8))
    with pytest.raises(err):
        tfs.arena_fold(bad(m), v, g, beta1=B1, beta2=B2)
    with pytest.raises(err):
        tfs.arena_apply(p, m, bad(v), lr=1e-3, bc1=0.1, bc2=0.001)


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch(monkeypatch):
    """On CPU tensors the wrapper never touches the CUDA library."""
    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    folds, applies = tfs.arena_fold.launches, tfs.arena_apply.launches
    m, v, g, p = (_t(x) for x in _arenas(8))
    tfs.arena_fold(m, v, g, beta1=B1, beta2=B2, decay=(B1, B2))
    tfs.arena_apply(p, m, v, lr=1e-3, bc1=0.1, bc2=0.001)
    assert (tfs.arena_fold.launches, tfs.arena_apply.launches) == \
        (folds, applies)


@pytest.mark.parametrize("entry", ["arena_fold", "arena_fold_slice",
                                   "arena_apply"])
def test_launch_arguments_match_the_declared_c_signatures(entry):
    """ctypes converts every argument the fp32/fp32 wrappers pass (the
    kinds and g's wire as int, pointers as c_void_p, a one-column codec's
    second pointer as NULL, the row offset and rows as int64, scalars as
    float32); the whole-arena fold passes row offset 0. The apply's p is
    followed by the master form's work pointer, NULL for the plain form,
    so its moments' pointers and what follows them sit one position
    later."""
    x = torch.zeros(8, tfs.LANES)
    fp32 = tfs.kernel_codec("m", "fp32"), tfs.kernel_codec("v", "fp32")
    if entry == "arena_apply":
        name = "arena_apply_launch"
        args = tfs.apply_args(*fp32, x, (x,), (x,), 1e-3, 0.1, 0.001, 1e-8,
                              0.01)
        ints = (8,)
    else:
        name = "arena_fold_launch"
        off, g = (0, x) if entry == "arena_fold" else (2, x[:4])
        args = tfs.fold_args(*fp32, (x,), (x,), g, off, B1, B2, 0.125,
                             (B1, B2))
        # g's wire (0: fp32), the row offset and rows; rowcol's partition
        # (none here) and its scratch pointer (NULL)
        ints = (0, off, g.shape[0], 0, 0, None)
    got = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *tfs.SIGNATURES[name])
    assert proto(lambda *a: got.append(a) or 0)(*args, 0) == 0
    assert got[0][:2] == (0, 0)
    x0 = x.data_ptr()
    ptrs = (x0, None, x0, None, x0, None) if entry == "arena_apply" \
        else (x0, None, x0, None, x0)
    assert got[0][2:2 + len(ptrs)] == ptrs
    at = 2 + len(ptrs)
    assert got[0][at:at + len(ints)] == ints
    assert got[0][at + len(ints):len(args)] == tuple(
        float(np.float32(s)) for s in args[at + len(ints):])


def test_first_moment_coefficient_is_rounded_from_double():
    """1 - 0.9 is formed in double then rounded (JAX's weak-typed float),
    not as 1.0f - 0.9f."""
    _, c1, c2, _, _ = tfs._fold_scalars(B1, B2, 1.0, None)
    assert c1 == float(np.float32(0.1))
    assert c1 != float(np.float32(1.0) - np.float32(0.9))
    assert c2 == float(np.float32(1.0 - 0.999))


_INIT_CASES = ([("pair", m, v) for m, v in
                state_store.registered_combinations()]
               + [("queued", "fp32", "rowcol"),
                  ("unknown", "nope", "fp32"), ("unknown", "fp32", "nope"),
                  ("unknown", "factored", "fp32")])


@pytest.mark.parametrize("kind,m_codec,v_codec", _INIT_CASES)
def test_queued_codecs_raise_not_implemented(kind, m_codec, v_codec):
    """Every ported (m, v) pair initialises with the reference's column
    shapes and dtypes, rowcol's (1, 1024) column sums included (the
    "queued" case, named when rowcol was not ported yet, now initialises
    as every pair does); an unknown name raises the reference's KeyError
    (factored is a v codec only)."""
    import jax

    from repro.core import adama as jadama
    params = {"w": torch.zeros(3, 5)}
    if kind == "unknown":
        with pytest.raises(KeyError):
            jadama.init_arena({"w": jnp.zeros((3, 5))}, codec=v_codec,
                              m_codec=m_codec)
        with pytest.raises(KeyError):
            adama.init_arena(params, codec=v_codec, m_codec=m_codec)
        return
    state = adama.init_arena(params, codec=v_codec, m_codec=m_codec)
    want = jadama.init_arena({"w": jnp.zeros((3, 5))}, codec=v_codec,
                             m_codec=m_codec)
    for k in ("m", "v"):
        got = state_store.codec_of(state[k], k).parts_of(state[k])
        ref = jax.tree.leaves(want[k])
        assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for x in got] == [(tuple(x.shape), str(x.dtype)) for x in ref]
        assert all(not x.any() for x in got)
    assert state["m"].layout.rows == 64 and state["step"] == 0
