"""Algorithm 2 in the port (repro_torch.core.layerwise, the
`adama_layerwise` engine) against the reference: the slice-fold plain
version against the Pallas `arena_fold_slice` (interpret mode) bit for bit,
the slice pack helpers against the reference's, and the engine step for
step against `make_adama_layerwise_step` in both state forms. Also the
engine's fold schedule (one slice fold per layer, in reverse, then the rest
region) and its agreement with the port's Algorithm-1 `adama`. With
`remat=True` on both sides the engine accepts the keyword and ignores it,
as the reference's does."""
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
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import fused_step as jfs
from repro.models import model as jmodel
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tmodel

torch.set_num_threads(1)

B1, B2 = 0.9, 0.999
N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 16, 3
ENGINE_TOL = 5e-6        # Fp32Codec's declared engine tolerance
# rwkv6 (see test_torch_engines.RWKV_TOL): its scan's float32 noise, grown
# by Adam over 3 steps; measured loss 9.5e-6, params 1.7e-5, m 4.6e-5 of a
# largest |m| of ~0.07, v 2.3e-7
RWKV_TOL = dict(loss=5e-5, params=5e-5, moments_of_max=2e-3)
ARCHS = ("bert_large", "stablelm_1_6b", "rwkv6_7b")
# depths other than the reduced config's, by arch: the MoE model at 3
# layers, so that Algorithm 2 walks 2 MoE layers of `blocks`, then the
# dense prefix layer of `dense_blocks`
NUM_LAYERS = {"deepseek_v2_lite_16b": dict(num_layers=3)}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# arena_fold_slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, rows_g, offset, block", [
    (64, 64, 0, 64),            # the whole arena
    (512, 128, 0, 64),          # first slice
    (512, 192, 256, 64),        # interior
    (768, 256, 512, 256),       # last slice, a whole-arena block
    (1280, 8, 1024, 8),         # a small block
])
def test_slice_fold_plain_version_bitwise_vs_reference(rows, rows_g, offset,
                                                       block):
    """A decayed fold then a scaled one, chained, against the Pallas
    kernel; rows outside the slice stay exactly as they were."""
    rng = np.random.default_rng(rows + offset)
    shape = (rows, tfs.LANES)
    m = rng.standard_normal(shape).astype(np.float32) * 1e-3
    v = np.abs(rng.standard_normal(shape).astype(np.float32)) * 1e-6
    gs = [rng.standard_normal((rows_g, tfs.LANES)).astype(np.float32)
          for _ in range(2)]
    jm, jv = jnp.asarray(m), jnp.asarray(v)
    tm, tv = _t(m), _t(v)
    for g, kw in ((gs[0], dict(scale=1.0, decay=(B1, B2))),
                  (gs[1], dict(scale=1.0 / 4, decay=None))):
        jm, jv = jfs.arena_fold_slice(jm, jv, jnp.asarray(g), offset,
                                      beta1=B1, beta2=B2, block=block, **kw)
        out = tfs.arena_fold_slice(tm, tv, _t(g), offset, beta1=B1,
                                   beta2=B2, block=block, **kw)
        assert out[0] is tm and out[1] is tv
        assert np.array_equal(np.asarray(jm), tm.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
    outside = np.ones(rows, bool)
    outside[offset:offset + rows_g] = False
    assert np.array_equal(tm.numpy()[outside], m[outside])
    assert np.array_equal(tv.numpy()[outside], v[outside])
    assert not np.array_equal(tm.numpy()[~outside], m[~outside])


@pytest.mark.parametrize("rows_g, offset, block, match", [
    (96, 0, 64, "multiples"),            # slab not whole blocks
    (64, 32, 64, "multiples"),           # offset not block-aligned
    (128, 448, 64, "outside"),           # runs past the arena
    (64, -64, 64, "outside"),
])
def test_slice_fold_rejects_what_the_reference_rejects(rows_g, offset, block,
                                                       match):
    m = torch.zeros(512, tfs.LANES)
    v = torch.zeros(512, tfs.LANES)
    g = torch.zeros(rows_g, tfs.LANES)
    with pytest.raises(ValueError, match=match):
        tfs.arena_fold_slice(m, v, g, offset, beta1=B1, beta2=B2, block=block)


# ---------------------------------------------------------------------------
# Slice pack helpers
# ---------------------------------------------------------------------------


def _model_trees(arch):
    params = jmodel.init_params(tiny(arch), jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, params)
    leaves, paths = tarena.tree_flatten(np_tree)
    return params, tarena.tree_unflatten(
        paths, [torch.from_numpy(x.copy()) for x in leaves])


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_layer_rest_and_slice_block_match_reference(arch):
    jtree, ttree = _model_trees(arch)
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    js, ts = jl.stack("blocks"), tl.stack("blocks")
    assert (ts.row, ts.layer_rows, ts.n_layers) == \
        (js.row, js.layer_rows, js.n_layers)
    assert tl.slice_block(ts) == jl.slice_block(js)
    assert tl.slice_block(tl.rest) == jl.slice_block(jl.rest)
    full = tarena.pack(ttree, tl)
    for j in range(ts.n_layers):
        jslab = np.asarray(jarena.pack_layer(
            jax.tree.map(lambda x, j=j: x[j], jtree["blocks"]), js))
        tslab = tarena.pack_layer({k: x[j] for k, x in
                                   ttree["blocks"].items()}, ts)
        assert tslab.shape == (ts.layer_rows, tarena.LANES)
        assert np.array_equal(jslab, tslab.numpy())
        lo = ts.row + j * ts.layer_rows
        assert torch.equal(tslab, full[lo:lo + ts.layer_rows])
    rest = {k: x for k, x in ttree.items() if k != "blocks"}
    jrest = np.asarray(jarena.pack_rest(
        {k: x for k, x in jtree.items() if k != "blocks"}, jl))
    trest = tarena.pack_rest(rest, tl)
    assert np.array_equal(jrest, trest.numpy())
    assert torch.equal(trest, full[tl.rest.row:tl.rest.row + tl.rest.rows])
    with pytest.raises(KeyError):
        tl.stack("enc_blocks")


def test_bert_large_slices_are_the_full_model_shapes():
    """At full width: 24 layer slices of 12,352 rows and a rest slice of
    61,248 rows, all in 64-row blocks (shapes only, no values)."""
    cfg = jax_get_config("bert_large")
    meta = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.key(0)))
    tree = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), meta)
    lay = tarena.build_layout(tree)
    spec = lay.stack("blocks")
    assert (spec.n_layers, spec.layer_rows, lay.rest.rows, lay.rows) == \
        (24, 12_352, 61_248, 357_888)
    assert lay.slice_block(spec) == lay.slice_block(lay.rest) == 64


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _data(arch):
    data = make_data(get_config(arch).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch, arena, remat=False):
    """The reference's adama_layerwise trajectory: per step (loss, params,
    m, v) as numpy leaves (m, v: the arenas, or per-leaf trees)."""
    cfg = tiny(arch, **NUM_LAYERS.get(arch, {}))
    opt = JaxOptimizerConfig(name="adama", accumulation="adama_layerwise",
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=arena)
    step, init = jax_make_train_step(cfg, opt, remat=remat)
    step = jax.jit(step)
    params = jmodel.init_params(cfg, jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    out = []
    for batch in _data(arch):
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        moments = ([np.asarray(state[k].data)] if arena else
                   tarena.tree_flatten(jax.tree.map(np.asarray, state[k]))[0]
                   for k in ("m", "v"))
        out.append((float(metrics["loss"]),
                    tarena.tree_flatten(jax.tree.map(np.asarray, params))[0],
                    *moments))
    return init_params, out


def _port(arch, engine, init_params, arena=True, remat=False):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32",
                              **NUM_LAYERS.get(arch, {}))
    model = tmodel.Model(cfg, tmodel.params_from_jax(init_params, "cpu"))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation=engine, micro_batches=N_MICRO, arena=arena),
        remat=remat)
    tree = model.tree()
    return model, step, tree, init(tree)


def _moment_leaves(state, k):
    if isinstance(state[k], tarena.Arena):
        return [state[k].data]
    return tarena.tree_flatten(state[k])[0]


# (arch, arena, remat); the remat cases' ids end in "-remat"
LAYERWISE_RUNS = [
    pytest.param(arch, arena, remat, id=f"{arch}-" + (
        "arena" if arena else "per_leaf") + ("-remat" if remat else ""))
    for remat in (False, True) for arch in ARCHS for arena in (True, False)
] + [pytest.param(arch, True, False, id=f"{arch}-arena")
     for arch in ("mistral_nemo_12b", "minicpm3_4b")] + [
    pytest.param(arch, arena, False, id=(
        f"{arch}-" + ("arena" if arena else "per_leaf")))
    for arch in ("deepseek_v2_lite_16b", "hymba_1_5b")
    for arena in (True, False)]


@pytest.mark.parametrize("arch, arena, remat", LAYERWISE_RUNS)
def test_layerwise_engine_matches_reference(arch, arena, remat):
    init_params, want = _reference_run(arch, arena, remat)
    model, step, tree, state = _port(arch, "adama_layerwise", init_params,
                                     arena, remat)
    for i, batch in enumerate(_data(arch)):
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss, params, m, v = want[i]
        assert state["step"] == i + 1
        rwkv = arch == "rwkv6_7b"
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=0,
                                   atol=RWKV_TOL["loss"] if rwkv else 1e-5)
        for j, (got, ref) in enumerate(((tarena.tree_flatten(tree)[0],
                                         params),
                                        (_moment_leaves(state, "m"), m),
                                        (_moment_leaves(state, "v"), v))):
            assert len(got) == len(ref)
            if rwkv:
                scale = max(float(np.abs(b).max()) for b in ref)
                atol = (RWKV_TOL["params"] if j == 0
                        else RWKV_TOL["moments_of_max"] * scale)
            else:
                atol = ENGINE_TOL
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                           atol=atol)
    assert {id(x) for x in tarena.tree_flatten(tree)[0]} == \
        {id(x) for x in model.parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_equals_adama_in_the_port(arch):
    """Algorithm 2 computes Algorithm 1's update, only the schedule differs
    (tests/test_adama.py::test_layerwise_equals_e2e's tolerances)."""
    init_params, _ = _reference_run(arch, True)
    batch = {k: torch.from_numpy(v) for k, v in _data(arch)[0].items()}
    out = {}
    for engine in ("adama", "adama_layerwise"):
        _, step, tree, state = _port(arch, engine, init_params)
        tree, state, metrics = step(tree, state, batch)
        out[engine] = ([x.detach() for x in tarena.tree_flatten(tree)[0]],
                       state["m"].data,
                       float(metrics["loss"]))
    (pe, me, le), (pl, ml, ll) = out["adama"], out["adama_layerwise"]
    assert max(float((a - b).abs().max()) for a, b in zip(pe, pl)) < 5e-6
    assert float((me - ml).abs().max()) < 5e-7
    assert abs(le - ll) < 1e-5


def test_layerwise_folds_each_layer_slice_in_reverse_then_the_rest(
        monkeypatch):
    """Per micro-batch: L slice folds of layer_rows rows at the layers'
    offsets, last layer first, then one fold of the rest region; the decay
    rides in micro-batch 0's folds only (later ones pass the identity
    decay); no whole-arena fold."""
    calls = []
    monkeypatch.setattr(tfs, "arena_fold", lambda *a, **kw: calls.append(
        ("arena_fold",)))
    orig = tfs.arena_fold_slice

    def record(m, v, g, row_offset, **kw):
        calls.append(("slice", row_offset, g.shape[0], kw["block"],
                      kw["decay"]))
        return orig(m, v, g, row_offset, **kw)
    monkeypatch.setattr(tfs, "arena_fold_slice", record)
    cfg = dataclasses.replace(get_config("bert_large").reduced(),
                              compute_dtype="float32", num_layers=3)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation="adama_layerwise", micro_batches=N_MICRO))
    tree = model.tree()
    state = init(tree)
    lay = state["m"].layout
    spec = lay.stack("blocks")
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 8, GLOBAL_BATCH).batch(0).items()}
    step(tree, state, batch)
    want = []
    for i in range(N_MICRO):
        decay = (B1, B2) if i == 0 else (1.0, 1.0)
        want += [("slice", spec.row + j * spec.layer_rows, spec.layer_rows,
                  lay.slice_block(spec), decay) for j in (2, 1, 0)]
        want.append(("slice", lay.rest.row, lay.rest.rows,
                     lay.slice_block(lay.rest), decay))
    assert calls == want


def test_per_leaf_layerwise_folds_one_leaf_view_at_a_time(monkeypatch):
    """Per micro-batch: one adama_accum_2d per leaf of each layer, then one
    per rest leaf; one adam_apply_2d per param leaf per step."""
    counts = {"accum": 0, "apply": 0}
    for key, fn in (("accum", "adama_accum_2d"), ("apply", "adam_apply_2d")):
        orig = getattr(tops, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            counts[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tops, fn, counted)
    cfg = dataclasses.replace(get_config("bert_large").reduced(),
                              compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation="adama_layerwise", micro_batches=N_MICRO, arena=False))
    tree = model.tree()
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 8, GLOBAL_BATCH).batch(0).items()}
    step(tree, init(tree), batch)
    n_block = len(tree["blocks"])
    n_rest = len(tarena.tree_flatten(tree)[0]) - n_block
    assert (n_block, n_rest) == (10, 4)
    assert counts == {"accum": N_MICRO * (n_block * cfg.num_layers + n_rest),
                      "apply": n_block + n_rest}


@pytest.mark.parametrize("flags", [[], ["--per-leaf"]],
                         ids=["arena", "per_leaf"])
def test_cli_trains_adama_layerwise_on_the_cpu(flags):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "bert-large", "--reduced", "--steps", "2", "--global-batch", "4",
         "--micro-batches", "2", "--seq-len", "16", "--log-every", "1",
         "--accumulation", "adama_layerwise", "--device", "cpu", *flags],
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] step") == 2
