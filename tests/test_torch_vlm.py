"""The port's vlm family (internvl2-26b: the stub patches before the text,
positions over both, the logits on the text tail; Algorithm 2 with the
patches as a constant before the embedding) against the reference's
(repro.data, repro.models.model.forward, repro.core.arena.build_layout,
repro.core.layerwise), on the CPU at the reduced internvl2-26b (16 patches,
d_model 256, 4 heads of 32 on 1 kv head)."""
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
from repro.configs.base import InputShape
from repro.core import arena as jarena
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.data import make_data as jax_make_data
from repro.models import model as jmodel
from repro.optim import schedule as jsched
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched

torch.set_num_threads(1)

ARCH = "internvl2_26b"
N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 16, 3
LR = 1e-3
# Fp32Codec's declared engine tolerance in the reference
ENGINE_TOL = 5e-6


def _tcfg(**over):
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32", **over)


def test_config_is_the_published_one_full_and_reduced():
    """internvl2-26b (arXiv:2404.16821): the InternLM2-20B backbone, 48
    layers, d_model 6144, 48 heads on 8 kv heads of 128, d_ff 16384 (gated
    silu), vocab 92553 (92672 padded), 256 stub patch tokens. Reduced as
    the reference reduces it: 16 patches; every field equal to the
    reference's, both ways."""
    cfg = get_config("internvl2-26b")
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.act,
            cfg.vocab_size, cfg.padded_vocab(), cfg.n_patch_tokens,
            cfg.encoder_layers, cfg.max_seq_len) == (
                "vlm", 48, 6144, 48, 8, 128, 16384, "silu", 92553, 92672,
                256, 0, 32768)
    red = cfg.reduced()
    assert (red.n_patch_tokens, red.num_layers, red.d_model, red.n_heads,
            red.n_kv_heads) == (16, 2, 256, 4, 1)
    for t, j in ((cfg, jax_get_config(ARCH)),
                 (red, jax_get_config(ARCH).reduced())):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("reduced", [True, False])
def test_patches_are_the_references_bit_for_bit(reduced):
    """The stub patches (batch, n_patch_tokens, d_model), float32 normals x
    0.02 drawn after the tokens, and the tokens and labels, equal the
    reference's batch for batch, at full width too."""
    t, j = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        t, j = t.reduced(), j.reduced()
    ours = make_data(t, 20, 2, seed=4)
    ref = jax_make_data(j, InputShape("t", 20, 2, "train"), seed=4)
    for i in (0, 3):
        a, b = ours.batch(i), ref.batch(i)
        assert sorted(a) == sorted(b) == ["labels", "patches", "tokens"]
        assert a["patches"].shape == (2, t.n_patch_tokens, t.d_model)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("which", ["reduced", "full-width-4-layers"])
def test_layout_matches_reference_row_for_row(which):
    """One stacked region and the rest (embed, final_norm_scale, lm_head);
    at full width and 4 layers: 4 x 380,992 layer rows, the rest's
    1,112,128 from 1,523,968: 2,636,288 rows (10,798,235,648 B)."""
    if which == "reduced":
        jtree = jmodel.init_params(tiny(ARCH), jax.random.key(0))
        gen = torch.Generator()
        gen.manual_seed(0)
        ttree = tmodel.init_params(_tcfg(), gen)
    else:
        jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=4)
        jtree = jax.eval_shape(lambda: jmodel.init_params(
            jcfg, jax.random.key(0)))
        ttree = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                             jtree)
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    js, ts = jl.stack("blocks"), tl.stack("blocks")
    assert (tl.rows, ts.row, ts.layer_rows, ts.n_layers, tl.rest.row,
            tl.rest.rows) == (jl.rows, js.row, js.layer_rows, js.n_layers,
                              jl.rest.row, jl.rest.rows)
    assert [(x.row, x.rows) for x in ts.leaves] == \
        [(x.row, x.rows) for x in js.leaves]
    assert [(x.row, x.rows) for x in tl.rest.leaves] == \
        [(x.row, x.rows) for x in jl.rest.leaves]
    assert sorted(ttree) == ["blocks", "embed", "final_norm_scale",
                             "lm_head"]
    if which != "reduced":
        assert (ts.layer_rows, tl.rest.row, tl.rest.rows, tl.rows) == (
            380_992, 1_523_968, 1_112_128, 2_636_288)


def test_logits_are_the_text_tails_and_the_patches_matter():
    """The forward runs [patches; text] at positions 0..P+S-1 and returns
    the text tail's logits (B, S, V_pad), those of the reference's jitted
    forward; other patches give other logits, and the text's own tokens
    sit at positions P.. (the reference's embed_tokens at positions[:,
    P:])."""
    jcfg, tcfg = tiny(ARCH), _tcfg()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tree = tmodel.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = make_data(tcfg, SEQ, 3, seed=2).batch(0)
    jlogits, _ = jax.jit(lambda p, b: jmodel.forward(jcfg, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, aux = tmodel.forward(tcfg, tree, tb)
    assert tlogits.shape == (3, SEQ, tcfg.padded_vocab())
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    other = dict(tb, patches=tb["patches"] * 2)
    assert not torch.equal(tmodel.forward(tcfg, tree, other)[0], tlogits)
    x, pos = tmodel.vlm_input(tcfg, tree, tb["tokens"], tb["patches"])
    assert x.shape == (3, 16 + SEQ, 256)
    assert torch.equal(pos[0], torch.arange(16 + SEQ, dtype=torch.int32))
    assert torch.equal(x[:, :16], tb["patches"])


def test_remat_equals_the_plain_forward_bit_for_bit():
    cfg = _tcfg()
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = tmodel.init_params(cfg, gen)
    leaves, _ = tarena.tree_flatten(tree)
    for x in leaves:
        x.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 16, 2, seed=2).batch(0).items()}
    out = []
    for remat in (False, True):
        loss = tmodel.loss_fn(cfg, tree, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _data():
    data = make_data(get_config(ARCH).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


def _sched(engine):
    """ga runs the reference's warmup schedule (its first step is
    ill-conditioned across frameworks, test_torch_engines.py)."""
    if engine != "ga":
        return None, None
    return (jsched.warmup_cosine(LR, 1, STEPS + 1),
            tsched.warmup_cosine(LR, 1, STEPS + 1))


@functools.lru_cache(maxsize=None)
def _reference_run(engine):
    """The reference's arena engine: per step (loss, packed params, m, v)."""
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True)
    step, init = jax_make_train_step(tiny(ARCH), opt,
                                     lr_schedule=_sched(engine)[0])
    step = jax.jit(step)
    params = jmodel.init_params(tiny(ARCH), jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _data():
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(mx["loss"]),
                    np.asarray(jarena.pack(params, layout)),
                    np.asarray(state["m"].data), np.asarray(state["v"].data)))
    return init_params, out


def _port_run(engine, init_params, steps=STEPS):
    model = tmodel.Model(_tcfg(), tmodel.params_from_jax(init_params, "cpu"))
    step, init = make_train_step(
        _tcfg(), OptimizerConfig(accumulation=engine, micro_batches=N_MICRO),
        lr_schedule=_sched(engine)[1])
    tree = model.tree()
    state = init(tree)
    out = []
    for batch in _data()[:steps]:
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            out.append((float(mx["loss"]),
                        tarena.pack(tree, state["m"].layout).numpy().copy(),
                        state["m"].data.numpy().copy(),
                        state["v"].data.numpy().copy()))
    return out


def _assert_params_close(got, want, m_got, m_want, t):
    """Params within ENGINE_TOL, but where Adam's update is decided by
    noise: an element whose gradient sums to float32 noise in both
    frameworks (|g| ~ eps) moves by lr x m / (sqrt(v) + eps) with m apart
    by tens of percent between them (one embedding element of the reduced
    model at seq 16: m 2.8e-9 against 3.8e-9 after 3 steps, params 1.2e-4
    apart, in the port's Algorithm 1 as in Algorithm 2). Such elements,
    whose first moments differ by more than 1e-3 of the reference's (each
    within ENGINE_TOL and 1e-8), at most 4 of them, are held within lr a
    step instead."""
    d = np.abs(got - want)
    noisy = np.abs(m_got - m_want) > 1e-3 * np.abs(m_want)
    assert (d[~noisy] <= ENGINE_TOL).all(), float(d[~noisy].max())
    assert (d <= LR * t).all(), float(d.max())
    assert int((d > ENGINE_TOL).sum()) <= 4


@pytest.mark.parametrize("engine", ["ga", "adama", "adama_layerwise"])
def test_engine_matches_reference(engine):
    """Each step: the loss within 1e-5, m and v within ENGINE_TOL (and
    relative to their own scale as test_torch_engines holds them), the
    params by `_assert_params_close`."""
    init_params, want = _reference_run(engine)
    got = _port_run(engine, init_params)
    for t, (a, b) in enumerate(zip(got, want), start=1):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
        for x, y in ((a[2], b[2]), (a[3], b[3])):
            np.testing.assert_allclose(x, y, rtol=0, atol=ENGINE_TOL)
        np.testing.assert_allclose(a[2], b[2], rtol=1e-3, atol=1e-8)
        np.testing.assert_allclose(a[3], b[3], rtol=1e-3, atol=1e-12)
        _assert_params_close(a[1], b[1], a[2], b[2], t)


def test_layerwise_equals_adama_in_the_port():
    """Algorithm 2 with the patches before the embedding computes Algorithm
    1's step (tests/test_adama.py::test_layerwise_equals_e2e's
    tolerances)."""
    init_params, _ = _reference_run("adama")
    (le, pe, me, _), = _port_run("adama", init_params, steps=1)
    (ll, pl, ml, _), = _port_run("adama_layerwise", init_params, steps=1)
    assert float(np.abs(pe - pl).max()) < 5e-6
    assert float(np.abs(me - ml).max()) < 5e-7
    assert abs(le - ll) < 1e-5


def test_layerwise_folds_each_layer_then_the_rest(monkeypatch):
    """Per micro-batch: the layers' slices, last first, then the rest."""
    calls = []
    orig = tfs.arena_fold_slice

    def record(m, v, g, row_offset, **kw):
        calls.append((row_offset, g.shape[0]))
        return orig(m, v, g, row_offset, **kw)
    monkeypatch.setattr(tfs, "arena_fold_slice", record)
    cfg = _tcfg(num_layers=3)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation="adama_layerwise", micro_batches=N_MICRO))
    tree = model.tree()
    state = init(tree)
    step(tree, state, {k: torch.from_numpy(v) for k, v in
                       make_data(cfg, 8, GLOBAL_BATCH).batch(0).items()})
    lay = state["m"].layout
    s = lay.stack("blocks")
    want = ([(s.row + j * s.layer_rows, s.layer_rows) for j in (2, 1, 0)]
            + [(lay.rest.row, lay.rest.rows)])
    assert calls == want * N_MICRO


def test_cli_trains_internvl2_with_a_depth_cut(capsys):
    """launch/train.py takes --arch internvl2-26b and cuts its depth with
    --num-layers (the card runs it at 4 of 48 layers)."""
    from repro_torch.launch.train import main
    main(["--arch", "internvl2-26b", "--reduced", "--num-layers", "1",
          "--steps", "2", "--global-batch", "2", "--micro-batches", "2",
          "--seq-len", "12", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done; final loss" in out, out
