"""The port's per-leaf kernels (repro_torch.kernels.adama_accum /
adam_apply, reached through kernels.ops) against the reference's Pallas
kernels (repro.kernels.ops, interpret mode on the CPU), bit for bit; the
wrappers' checks and CPU dispatch; and the per-leaf form of the `adama`
engine against the reference's (use_pallas=True, arena=False). The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""
import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import adam_apply, adama_accum, build
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tmodel

torch.set_num_threads(1)

# tests/test_kernels.py's shapes: scalars, ragged, one row, 2D, 3D, large
SHAPES = [(1,), (7,), (1024,), (300, 150), (2, 3, 257), (2048, 1024)]
B1, B2 = 0.9, 0.99
ENGINE_TOL = 5e-6        # Fp32Codec's declared engine tolerance


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _moments(shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(shape).astype(np.float32) * 1e-3
    v = np.abs(rng.standard_normal(shape).astype(np.float32)) * 1e-6
    g = rng.standard_normal(shape).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32) * 0.02
    v.reshape(-1)[:3] = 0.0                          # sqrt(0) + eps path
    g.reshape(-1)[-2:] = 0.0
    return m, v, g, p


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 0.25, 0.1])
def test_accum_plain_version_bitwise_vs_reference(shape, scale):
    """scale 0.1 is not a power of two: the reference folds (1-b1)*scale
    into one float32 constant, which the port reproduces."""
    m, v, g, _ = _moments(shape, seed=len(shape))
    jm, jv = jops.adama_accumulate(jnp.asarray(m), jnp.asarray(v),
                                   jnp.asarray(g), beta1=B1, beta2=B2,
                                   scale=scale)
    tm, tv = _t(m), _t(v)
    out = tops.adama_accumulate(tm, tv, _t(g), beta1=B1, beta2=B2,
                                scale=scale)
    assert out[0] is tm and out[1] is tv               # in place
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_apply_plain_version_bitwise_vs_reference(shape, wd):
    m, v, _, p = _moments(shape, seed=7 + len(shape))
    t = np.float32(3)
    lr = np.float32(1e-3)
    bc1 = np.float32(1) - np.float32(0.9) ** t
    bc2 = np.float32(1) - np.float32(0.999) ** t
    jp = jops.adam_apply(jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
                         lr=lr, bc1=bc1, bc2=bc2, eps=1e-8, weight_decay=wd)
    tp = _t(p)
    assert tops.adam_apply(tp, _t(m), _t(v), lr=lr, bc1=bc1, bc2=bc2,
                           eps=1e-8, weight_decay=wd) is tp
    assert np.array_equal(np.asarray(jp), tp.numpy())


def test_tree_ops_fold_and_apply_every_leaf_in_place():
    rng = np.random.default_rng(3)
    shapes = {"a": (5,), "blocks": {"w": (2, 3, 4), "b": (2, 9)}}

    def tree(scale=1.0, positive=False):
        return {"a": _t(np.abs(rng.standard_normal(5)) * scale if positive
                        else rng.standard_normal(5) * scale),
                "blocks": {k: _t((np.abs(rng.standard_normal(s)) if positive
                                  else rng.standard_normal(s)) * scale)
                           for k, s in shapes["blocks"].items()}}
    m, v, g, p = tree(1e-3), tree(1e-6, True), tree(), tree(0.02)
    want = [(x.clone(), y.clone(), z.clone(), w.clone()) for x, y, z, w in
            zip(*(tarena.tree_flatten(t)[0] for t in (m, v, g, p)))]
    assert tops.adama_accumulate_tree(m, v, g, beta1=B1, beta2=B2) == (m, v)
    assert tops.adam_apply_tree(p, m, v, lr=1e-3, bc1=0.1, bc2=0.01) is p
    for (wm, wv, wg, wp), tm, tv, tp in zip(
            want, *(tarena.tree_flatten(t)[0] for t in (m, v, p))):
        adama_accum.adama_accum_2d_ref(wm, wv, wg, beta1=B1, beta2=B2)
        adam_apply.adam_apply_2d_ref(wp, wm, wv, lr=1e-3, bc1=0.1, bc2=0.01)
        assert torch.equal(wm, tm) and torch.equal(wv, tv)
        assert torch.equal(wp, tp)
    with pytest.raises(ValueError, match="structure"):
        tops.adama_accumulate_tree(m, v, {"a": g["a"]}, beta1=B1, beta2=B2)


def test_leaf_views_of_a_stacked_moment_fold_in_place():
    """The layer-wise per-leaf path folds row j of a stacked moment through
    a view; only that row changes."""
    rng = np.random.default_rng(4)
    m = _t(rng.standard_normal((3, 1024)) * 1e-3)
    v = _t(np.abs(rng.standard_normal((3, 1024))) * 1e-6)
    g = _t(rng.standard_normal(1024))
    m0, v0 = m.clone(), v.clone()
    tops.adama_accumulate(m[1], v[1], g, beta1=B1, beta2=B2)
    assert torch.equal(m[0], m0[0]) and torch.equal(m[2], m0[2])
    assert torch.equal(v[0], v0[0]) and torch.equal(v[2], v0[2])
    mr, vr = m0[1].clone(), v0[1].clone()
    adama_accum.adama_accum_2d_ref(mr, vr, g, beta1=B1, beta2=B2)
    assert torch.equal(m[1], mr) and torch.equal(v[1], vr)


@pytest.mark.parametrize("bad, err", [
    (lambda x: x.double(), TypeError),
    (lambda x: x.to(torch.bfloat16), TypeError),
    (lambda x: x[:, :3], ValueError),
    (lambda x: x.t(), ValueError),
    (lambda x: x.t().contiguous().t(), ValueError),
])
def test_leaf_wrappers_reject_malformed_operands(bad, err):
    m, v, g, p = (_t(x) for x in _moments((5, 7), seed=0))
    with pytest.raises(err):
        adama_accum.adama_accum_2d(m, v, bad(g), beta1=B1, beta2=B2)
    with pytest.raises(err):
        adam_apply.adam_apply_2d(p, bad(m), v, lr=1e-3, bc1=0.1, bc2=0.01)


def test_cpu_leaf_wrappers_run_the_plain_version_and_count_no_launch(
        monkeypatch):
    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    before = (adama_accum.adama_accum_2d.launches,
              adam_apply.adam_apply_2d.launches)
    m, v, g, p = (_t(x) for x in _moments((13,), seed=0))
    adama_accum.adama_accum_2d(m, v, g, beta1=B1, beta2=B2)
    adam_apply.adam_apply_2d(p, m, v, lr=1e-3, bc1=0.1, bc2=0.01)
    assert (adama_accum.adama_accum_2d.launches,
            adam_apply.adam_apply_2d.launches) == before


@pytest.mark.parametrize("module, name", [
    (adama_accum, "adama_accum_launch"), (adam_apply, "adam_apply_launch")])
def test_leaf_launch_arguments_match_the_declared_c_signatures(module, name):
    """ctypes converts every argument the wrappers pass (pointers as
    c_void_p, the count as int64, scalars as float32)."""
    x = torch.zeros(7, 3)
    args = (module.accum_args(x, x, x, B1, B2, 0.1)
            if module is adama_accum
            else module.apply_args(x, x, x, 1e-3, 0.1, 0.001, 1e-8, 0.01))
    got = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *module.SIGNATURES[name])
    assert proto(lambda *a: got.append(a) or 0)(*args, 0) == 0
    assert got[0][0] == x.data_ptr() and got[0][3] == x.numel() == 21
    assert got[0][4:len(args)] == tuple(float(np.float32(s)) for s in args[4:])


def test_accum_folds_the_first_moment_constant_in_float32():
    s, cs1, c2 = adama_accum._scalars(B1, B2, 0.1)
    assert cs1 == float(np.float32(np.float32(0.1) * np.float32(0.1)))
    assert c2 == float(np.float32(1.0 - 0.99)) and s == float(np.float32(0.1))


# ---------------------------------------------------------------------------
# The per-leaf `adama` engine against the reference's
# ---------------------------------------------------------------------------

N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 16, 3
ARCHS = ("bert_large", "stablelm_1_6b")


def _data(arch):
    data = make_data(get_config(arch).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    cfg = tiny(arch)
    opt = JaxOptimizerConfig(name="adama", accumulation="adama",
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=False)
    step, init = jax_make_train_step(cfg, opt)
    step = jax.jit(step)
    params = jmodel.init_params(cfg, jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    out = []
    for batch in _data(arch):
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]),
                    *(tarena.tree_flatten(jax.tree.map(np.asarray, t))[0]
                      for t in (params, state["m"], state["v"]))))
    return init_params, out


@pytest.mark.parametrize("arch", ARCHS)
def test_per_leaf_adama_matches_reference(arch, monkeypatch):
    init_params, want = _reference_run(arch)
    calls = {"accum": 0, "apply": 0}
    for key, mod, fn in (("accum", tops, "adama_accum_2d"),
                         ("apply", tops, "adam_apply_2d")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    model = tmodel.Model(cfg, tmodel.params_from_jax(init_params, "cpu"))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation="adama", micro_batches=N_MICRO, arena=False))
    tree = model.tree()
    state = init(tree)
    n_leaves = len(tarena.tree_flatten(tree)[0])
    for i, batch in enumerate(_data(arch)):
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss, params, m, v = want[i]
        assert calls == {"accum": (i + 1) * N_MICRO * n_leaves,
                         "apply": (i + 1) * n_leaves}
        assert state["step"] == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=0,
                                   atol=1e-5)
        for got, ref in ((tree, params), (state["m"], m), (state["v"], v)):
            for a, b in zip(tarena.tree_flatten(got)[0], ref):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                           atol=ENGINE_TOL)
    assert {id(x) for x in tarena.tree_flatten(tree)[0]} == \
        {id(x) for x in model.parameters()}


def test_ga_has_no_per_leaf_form():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OptimizerConfig(accumulation="ga", arena=False)
