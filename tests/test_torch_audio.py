"""The port's enc-dec family (whisper-base: the stub frames, the encoder
stack, the decoder's cross-attention, Algorithm 2's enc-dec form) against
the reference's (repro.data, repro.models.modules.cross_attention /
encode_cross_kv, repro.models.model, repro.core.arena.build_layout,
repro.core.layerwise._layerwise_audio), on the CPU at the reduced
whisper-base (one encoder and one decoder layer over 64 frames, d_model
256, 4 heads of 32), at depths of 2 and 3 where the order of the layers
matters, and at whisper-base's own widths where the layout is asked."""
import dataclasses
import functools
import json

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
from repro.models import modules as jmd
from repro.train import checkpoint as jckpt
from repro.train import faults as jfaults
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core import layerwise as tlw
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmd
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import faults as tfaults

torch.set_num_threads(1)

ARCH = "whisper_base"
N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 16, 3
# Fp32Codec's declared engine tolerance in the reference
ENGINE_TOL = 5e-6
# modules in fp32 against the reference's, jitted: einsum and softmax sums
# in another order (test_torch_models' tolerances)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _tcfg(**over):
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32", **over)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


def test_config_is_the_published_one_full_and_reduced():
    """whisper-base (arXiv:2212.04356): 6 encoder and 6 decoder layers,
    d_model 512, 8 heads of 64, d_ff 2048, vocab 51865 (51968 padded), 1500
    frames, a 448-token decoder context, layernorm, gelu, sinusoidal
    positions. Reduced as the reference reduces it: 1 + 1 layers over 64
    frames; every field equal to the reference's, both ways."""
    cfg = get_config("whisper-base")
    assert (cfg.arch_type, cfg.encoder_layers, cfg.num_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab(), cfg.encoder_seq_len,
            cfg.max_seq_len, cfg.norm, cfg.act, cfg.pos_emb,
            cfg.n_patch_tokens) == (
                "audio", 6, 6, 512, 8, 8, 64, 2048, 51865, 51968, 1500, 448,
                "layernorm", "gelu", "sinusoidal", 0)
    red = cfg.reduced()
    assert (red.encoder_layers, red.num_layers, red.encoder_seq_len,
            red.d_model, red.n_heads, red.resolved_head_dim) == (
                1, 1, 64, 256, 4, 32)
    for t, j in ((cfg, jax_get_config(ARCH)),
                 (red, jax_get_config(ARCH).reduced())):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("reduced", [True, False])
def test_frames_are_the_references_bit_for_bit(reduced):
    """The stub frames (batch, encoder_seq_len, d_model), float32 normals x
    0.02 from the batch's generator after the tokens, and the tokens and
    labels, equal the reference's batch for batch, at full size too."""
    t, j = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        t, j = t.reduced(), j.reduced()
    ours = make_data(t, 24, 2, seed=3)
    ref = jax_make_data(j, InputShape("t", 24, 2, "train"), seed=3)
    for i in (0, 4):
        a, b = ours.batch(i), ref.batch(i)
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        assert a["frames"].shape == (2, t.encoder_seq_len, t.d_model)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_param_tree_has_the_references_keys_and_shapes():
    """enc_blocks (dense blocks, E layers), the decoder blocks' cross
    attention (wq_x, wk_x, wv_x, wo_x) and cross_norm, enc_norm; the Model
    holds enc_blocks as a ParameterDict."""
    jp = jmodel.init_params(tiny(ARCH, num_layers=2), jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tmodel.init_params(_tcfg(num_layers=2), gen)
    jl, jpaths = tarena.tree_flatten(jax.tree.map(np.asarray, jp))
    tl, tpaths = tarena.tree_flatten(tp)
    assert jpaths == tpaths
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    assert {"wq_x", "wk_x", "wv_x", "wo_x", "cross_norm_scale",
            "cross_norm_bias"} <= set(tp["blocks"])
    assert not {"wq_x", "cross_norm_scale"} & set(tp["enc_blocks"])
    assert tp["enc_blocks"]["wq"].shape[0] == 1
    assert tp["blocks"]["wq"].shape[0] == 2
    model = tmodel.Model(_tcfg(num_layers=2), tp)
    assert isinstance(model.enc_blocks, torch.nn.ParameterDict)
    assert {"enc_norm_scale", "enc_norm_bias"} <= set(model.tree())


def _meta_tree(cfg):
    meta = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.key(0)))
    return meta, jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), meta)


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_layout_matches_reference_row_for_row(which):
    """Three regions: `blocks` (the decoder) from row 0, `enc_blocks`
    after it, the rest (embed, enc_norm_*, final_norm_*, lm_head). At full
    size: 6 x 4,160 decoder rows, 6 x 3,136 encoder rows from 24,960, the
    rest's 52,032 from 43,776: 96,000 rows."""
    if which == "reduced":
        jtree = jmodel.init_params(tiny(ARCH), jax.random.key(0))
        gen = torch.Generator()
        gen.manual_seed(0)
        ttree = tmodel.init_params(_tcfg(), gen)
    else:
        jtree, ttree = _meta_tree(jax_get_config(ARCH))
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    assert tl.rows == jl.rows
    for name in ("blocks", "enc_blocks"):
        js, ts = jl.stack(name), tl.stack(name)
        assert (ts.row, ts.layer_rows, ts.n_layers) == \
            (js.row, js.layer_rows, js.n_layers), name
        assert [(x.row, x.rows) for x in ts.leaves] == \
            [(x.row, x.rows) for x in js.leaves], name
        assert tl.slice_block(ts) == jl.slice_block(js)
    assert (tl.rest.row, tl.rest.rows) == (jl.rest.row, jl.rest.rows)
    assert [(x.row, x.rows) for x in tl.rest.leaves] == \
        [(x.row, x.rows) for x in jl.rest.leaves]
    assert ("enc_norm_scale",) in tl.rest.paths
    if which == "full":
        d, e = tl.stack("blocks"), tl.stack("enc_blocks")
        assert (d.row, d.layer_rows, d.n_layers, e.row, e.layer_rows,
                e.n_layers, tl.rest.row, tl.rest.rows, tl.rows) == (
            0, 4160, 6, 24_960, 3136, 6, 43_776, 52_032, 96_000)


@pytest.mark.parametrize("se", [64, 1500])
def test_cross_attention_and_its_gradients_match_reference(se):
    """encode_cross_kv then cross_attention (no rope, keys at 0..Se-1,
    non-causal) and the gradients of x, enc_out and the four cross leaves,
    against jax.vjp of the reference's; at Se = 1500 the 1024-key blocks
    pad 548 keys, which add nothing."""
    jcfg, tcfg = tiny(ARCH), _tcfg()
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(1))["blocks"])
    keys = ("wk_x", "wo_x", "wq_x", "wv_x")
    p = {k: block[k] for k in keys}
    x = _rand(2, 2, 9, 256)
    enc = _rand(3, 2, se, 256)
    dy = _rand(4, 2, 9, 256, scale=0.1)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))

    def jfn(p, x, e):
        return jmd.cross_attention(jcfg, p, x, jmd.encode_cross_kv(p, e),
                                   pos)
    jy, vjp = jax.vjp(jax.jit(jfn), p, x, enc)
    jdp, jdx, jde = vjp(jnp.asarray(dy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(enc, requires_grad=True)
    ty = tmd.cross_attention(tcfg, tp, tx, tmd.encode_cross_kv(tp, te),
                             torch.tensor(pos))
    _close(jy, ty)
    grads = torch.autograd.grad(ty, [tp[k] for k in keys] + [tx, te],
                                torch.tensor(dy))
    for k, g in zip(keys, grads):
        _close(jdp[k], g, **GRAD_TOL)
    _close(jdx, grads[-2], **GRAD_TOL)
    _close(jde, grads[-1], **GRAD_TOL)


def test_decoder_block_and_its_gradients_match_reference():
    """A decoder block (self-attention with rope on the sinusoidal
    embeddings, as every gqa block; cross-attention to the encoder's keys
    and values formed inside the layer; the MLP) and the gradients of
    every leaf, of x and of the encoder's output, against jax.vjp of the
    reference's `_scan_dec` body."""
    jcfg, tcfg = tiny(ARCH), _tcfg()
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(2))["blocks"])
    block["cross_norm_scale"] = 1.0 + _rand(5, 256, scale=0.1)
    block["cross_norm_bias"] = _rand(6, 256, scale=0.1)
    x = _rand(7, 2, 12, 256)
    enc = _rand(8, 2, 64, 256)
    dy = _rand(9, 2, 12, 256, scale=0.1)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))

    def jfn(p, x, e):
        return jmodel.apply_block(jcfg, p, x, pos, kind="dec",
                                  enc_kv=jmd.encode_cross_kv(p, e))[0]
    jy, vjp = jax.vjp(jax.jit(jfn), block, x, enc)
    jdp, jdx, jde = vjp(jnp.asarray(dy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in block.items()}
    tx = torch.tensor(x, requires_grad=True)
    te = torch.tensor(enc, requires_grad=True)
    ty, aux = tmodel.dec_block(tcfg, tp, tx, te, torch.tensor(pos))
    assert float(aux) == 0.0
    _close(jy, ty)
    keys = sorted(block)
    grads = torch.autograd.grad(ty, [tp[k] for k in keys] + [tx, te],
                                torch.tensor(dy))
    for k, g in zip(keys, grads):
        _close(jdp[k], g, err_msg=k, **GRAD_TOL)
    _close(jdx, grads[-2], **GRAD_TOL)
    _close(jde, grads[-1], **GRAD_TOL)


@pytest.mark.parametrize("layers", [(1, 1), (2, 3)])
def test_forward_loss_and_gradient_arena_match_reference(layers):
    """The whole model (frames + sinusoids, the encoder stack, enc_norm,
    the decoder stack reading it, the head): logits, loss and the packed
    gradient arena against the reference's jitted forward and
    value_and_grad, at 1 + 1 and at 2 encoder + 3 decoder layers."""
    over = dict(encoder_layers=layers[0], num_layers=layers[1])
    jcfg, tcfg = tiny(ARCH, **over), _tcfg(**over)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = tmodel.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = make_data(tcfg, SEQ, 3, seed=3).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(lambda p, b: jmodel.forward(jcfg, p, b))(jp, jb)
    model = tmodel.Model(tcfg, tp)
    tlogits, _ = model(tb)
    assert tlogits.shape == (3, SEQ, tcfg.padded_vocab())
    _close(jlogits, tlogits, rtol=1e-5, atol=1e-5)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jcfg, p, b)))(jp, jb)
    tree = model.tree()
    leaves, paths = tarena.tree_flatten(tree)
    tloss = tmodel.loss_fn(tcfg, tree, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tg = tarena.tree_unflatten(paths, list(torch.autograd.grad(tloss,
                                                               leaves)))
    jl, tl = jarena.build_layout(jp), tarena.build_layout(tree)
    np.testing.assert_allclose(tarena.pack(tg, tl).numpy(),
                               np.asarray(jarena.pack(jg, jl)), rtol=1e-4,
                               atol=1e-7)


def test_remat_equals_the_plain_forward_bit_for_bit():
    """loss_fn with every encoder and decoder layer checkpointed (a
    decoder layer's cross keys and values recomputed with it) equals the
    plain one: the loss and every gradient, bit for bit."""
    cfg = _tcfg(encoder_layers=2, num_layers=2)
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


def _data(over=None):
    cfg = _tcfg(**(over or {}))
    data = make_data(cfg, SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_run(engine, arena=True, fault=None, layers=(1, 1),
                   grad_dtype="fp32"):
    """The reference's trajectory (use_pallas=True): per step (loss,
    params, m, v leaves, metrics), and its initial params."""
    over = dict(encoder_layers=layers[0], num_layers=layers[1])
    cfg = tiny(ARCH, **over)
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=arena, grad_dtype=grad_dtype,
                             finite_guard=(fault is not None
                                           or grad_dtype == "fp8_e4m3"))
    sched = _sched(engine)[0]
    step, init = jax_make_train_step(cfg, opt, lr_schedule=sched,
                                     fault=jfaults.parse_fault(fault))
    step = jax.jit(step)
    params = jmodel.init_params(cfg, jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    out = []
    for batch in _data(over):
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        moments = [tarena.tree_flatten(jax.tree.map(
            np.asarray, state[k].data if arena else state[k]))[0]
            for k in ("m", "v")]
        out.append((float(mx["loss"]),
                    tarena.tree_flatten(jax.tree.map(np.asarray, params))[0],
                    *moments, {k: float(v) for k, v in mx.items()}))
    return init_params, out


def _sched(engine):
    """ga runs the reference's warmup schedule (its first step is
    ill-conditioned across frameworks, test_torch_engines.py)."""
    if engine != "ga":
        return None, None
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule as tsched
    return (jsched.warmup_cosine(1e-3, 1, STEPS + 1),
            tsched.warmup_cosine(1e-3, 1, STEPS + 1))


def _port_run(engine, init_params, arena=True, fault=None, layers=(1, 1),
              steps=STEPS, grad_dtype="fp32"):
    over = dict(encoder_layers=layers[0], num_layers=layers[1])
    cfg = _tcfg(**over)
    model = tmodel.Model(cfg, tmodel.params_from_jax(init_params, "cpu"))
    step, init = make_train_step(
        cfg, OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                             arena=arena, grad_dtype=grad_dtype,
                             finite_guard=(fault is not None
                                           or grad_dtype == "fp8_e4m3")),
        lr_schedule=_sched(engine)[1], fault=tfaults.parse_fault(fault))
    tree = model.tree()
    state = init(tree)
    out = []
    for batch in _data(over)[:steps]:
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        moments = [tarena.tree_flatten(state[k].data if arena
                                       else state[k])[0] for k in ("m", "v")]
        out.append((float(mx["loss"]),
                    [x.detach().clone() for x in
                     tarena.tree_flatten(tree)[0]],
                    *[[x.clone() for x in mo] for mo in moments],
                    {k: float(v) for k, v in mx.items()}))
    return model, tree, state, out


# (engine, arena state, (encoder layers, decoder layers))
ENGINE_CASES = {
    "ga": ("ga", True, (1, 1)),
    "adama": ("adama", True, (1, 1)),
    "adama_layerwise": ("adama_layerwise", True, (1, 1)),
    "adama_layerwise-2+3": ("adama_layerwise", True, (2, 3)),
    "adama_layerwise-per_leaf": ("adama_layerwise", False, (1, 1)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(case):
    """Each step: the loss within 1e-5, params and the m and v arenas (or
    per-leaf moments) within ENGINE_TOL of the reference's engine."""
    engine, arena, layers = ENGINE_CASES[case]
    init_params, want = _reference_run(engine, arena, layers=layers)
    _, _, state, got = _port_run(engine, init_params, arena, layers=layers)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
        for j in (1, 2, 3):
            assert len(a[j]) == len(b[j])
            for x, y in zip(a[j], b[j]):
                np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                           atol=ENGINE_TOL,
                                           err_msg=f"{case} step {i + 1}")
    assert state["step"] == STEPS


@pytest.mark.parametrize("wire", ["bf16", "fp8_e4m3"])
def test_layerwise_on_a_narrow_wire_matches_reference(wire):
    """Algorithm 2's enc-dec form on the bf16 wire and on the fp8 e4m3 wire
    (guarded, with its error-feedback residual), at 2 encoder and 3
    decoder layers: the losses within 1e-5 of the reference's, the params
    within ENGINE_TOL but for the wire's rounding flips (at most
    WIRE_FLIP_FRAC / FP8_FLIP_FRAC of them, all within ENGINE_TOL + the
    pair's declared wire drift x lr), as tests/test_torch_wire.py and
    test_torch_fp8_wire.py hold the other models."""
    from test_torch_codecs import LR
    from test_torch_fp8_wire import FP8_FLIP_FRAC
    from test_torch_wire import WIRE_FLIP_FRAC
    from repro_torch.core import state_store as tss
    layers = (2, 3)
    init_params, want = _reference_run("adama_layerwise", layers=layers,
                                       grad_dtype=wire)
    _, _, state, got = _port_run("adama_layerwise", init_params,
                                 layers=layers, grad_dtype=wire)
    field, frac = (("bf16_wire_lr", WIRE_FLIP_FRAC) if wire == "bf16"
                   else ("fp8_wire_lr", FP8_FLIP_FRAC))
    bound = ENGINE_TOL + sum(getattr(tss.get_codec("fp32", mo).conformance,
                                     field) for mo in ("m", "v")) * LR
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
        p = np.concatenate([x.numpy().ravel() for x in a[1]])
        wp = np.concatenate([x.ravel() for x in b[1]])
        d = np.abs(p - wp)
        assert float((d > ENGINE_TOL).mean()) <= frac, (wire, i)
        assert d.max() <= bound, (wire, i, d.max(), bound)
    assert ("ef" in state) == (wire == "fp8_e4m3")


def test_guarded_layerwise_nan_is_one_skip_and_a_bitwise_no_op():
    """Guarded adama_layerwise with a NaN at micro-batch 1 of step 1: one
    skipped micro-batch; params, m and v bit for bit those of a forced
    skip there, different from a clean run's, and within ENGINE_TOL of the
    reference's guarded engine with the same NaN."""
    fault = "nan@micro=1,step=1"
    init_params, want = _reference_run("adama_layerwise", fault=fault)
    runs = {f: _port_run("adama_layerwise", init_params, fault=f)[3]
            for f in (fault, "skip@micro=1,step=1", None)}
    nan, skip, clean = (runs[f] for f in (fault, "skip@micro=1,step=1",
                                          None))
    assert nan[-1][4]["skipped_micro_batches"] == 1
    assert want[-1][4]["skipped_micro_batches"] == 1
    for j in (1, 2, 3):
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(nan[-1][j], skip[-1][j]))
    assert not all(torch.equal(x, y) for x, y in zip(nan[-1][1],
                                                     clean[-1][1]))
    for a, b in zip(nan, want):
        for j in (1, 2, 3):
            for x, y in zip(a[j], b[j]):
                np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                           atol=ENGINE_TOL)


def test_layerwise_equals_adama_in_the_port():
    """Algorithm 2's enc-dec form computes Algorithm 1's step (the
    reference's tests/test_adama.py::test_layerwise_equals_e2e
    tolerances), at 2 encoder and 3 decoder layers."""
    layers = (2, 3)
    init_params, _ = _reference_run("adama", layers=layers)
    out = {}
    for engine in ("adama", "adama_layerwise"):
        _, _, state, got = _port_run(engine, init_params, layers=layers,
                                     steps=1)
        out[engine] = got[0][1], state["m"].data, got[0][0]
    (pe, me, le), (pl, ml, ll) = out["adama"], out["adama_layerwise"]
    assert max(float((a - b).abs().max()) for a, b in zip(pe, pl)) < 5e-6
    assert float((me - ml).abs().max()) < 5e-7
    assert abs(le - ll) < 1e-5


def test_layerwise_folds_decoder_then_encoder_then_rest(monkeypatch):
    """Per micro-batch at 2 encoder and 3 decoder layers: the decoder's
    layer slices, last first, then the encoder's, last first, then the
    rest region, each at its arena offset (the reference's dec + enc +
    rest slice-fold sites, tests/test_arena.py); one apply a step."""
    calls = []
    orig = tfs.arena_fold_slice

    def record(m, v, g, row_offset, **kw):
        calls.append((row_offset, g.shape[0]))
        return orig(m, v, g, row_offset, **kw)
    monkeypatch.setattr(tfs, "arena_fold_slice", record)
    init_params, _ = _reference_run("adama", layers=(2, 3))
    _, _, state, _ = _port_run("adama_layerwise", init_params,
                               layers=(2, 3), steps=1)
    lay = state["m"].layout
    d, e = lay.stack("blocks"), lay.stack("enc_blocks")
    want = ([(d.row + j * d.layer_rows, d.layer_rows) for j in (2, 1, 0)]
            + [(e.row + j * e.layer_rows, e.layer_rows) for j in (1, 0)]
            + [(lay.rest.row, lay.rest.rows)])
    assert calls == want * N_MICRO


def test_layerwise_sums_the_encoder_gradient_in_its_own_dtype(monkeypatch):
    """Under bf16 compute the decoder layers' gradients of the encoder's
    output are summed in bf16 from the last layer down, as the reference's
    bf16 zeros_like(enc_out) carry is: the sum handed to the encoder
    norm's backward equals ((0 + d_2) + d_1) + d_0 in bf16 bit for bit."""
    per_layer, totals = [], []
    orig_layer, orig_stack = tlw._layer_backward, tlw._backward_stack

    def layer(fn, lp, inputs, dx, seed):
        dl, dins = orig_layer(fn, lp, inputs, dx, seed)
        if len(dins) > 1:
            per_layer.append(dins[1].clone())
        return dl, dins

    def stack(*a, **kw):
        dx, dextra = orig_stack(*a, **kw)
        totals.extend(x.clone() for x in dextra)
        return dx, dextra
    monkeypatch.setattr(tlw, "_layer_backward", layer)
    monkeypatch.setattr(tlw, "_backward_stack", stack)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=3)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation="adama_layerwise", micro_batches=1))
    tree = model.tree()
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 8, 2, seed=1).batch(0).items()}
    step(tree, init(tree), batch)
    assert len(per_layer) == 3 and len(totals) == 1
    want = torch.zeros_like(per_layer[0])
    for d in per_layer:                  # recorded last layer first
        want = want + d
    assert want.dtype == totals[0].dtype == torch.bfloat16
    assert torch.equal(want.view(torch.int16), totals[0].view(torch.int16))
    f32 = sum(d.float() for d in per_layer).to(torch.bfloat16)
    assert not torch.equal(f32, totals[0])


def test_checkpoint_round_trips_in_the_references_format(tmp_path):
    """A whisper tree (enc_blocks, enc_norm_*) and its adama state after a
    step: the port's checkpoint restores into the reference bit for bit,
    the reference's save of that restores into the port bit for bit."""
    init_params, _ = _reference_run("adama")
    _, tree, state, _ = _port_run("adama", init_params, steps=1)
    full = {"params": tree, "opt": state}
    tckpt.save(tmp_path / "port", 1, full)
    jp = jax.tree.map(jnp.asarray, init_params)
    _, init = jax_make_train_step(tiny(ARCH), JaxOptimizerConfig(
        name="adama", accumulation="adama", micro_batches=N_MICRO,
        use_pallas=True, arena=True))
    got = jckpt.restore(str(tmp_path / "port"), 1, jax.eval_shape(
        lambda: {"params": jp, "opt": init(jp)}))
    theirs = jax.tree.leaves(got)
    ours = tckpt.tree_leaves(full)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a = np.int32(a) if isinstance(a, int) else a.detach().numpy()
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(str(tmp_path / "ref"), 1, got)
    _, tree2, state2, _ = _port_run("adama", init_params, steps=0)
    back = tckpt.restore(tmp_path / "ref", 1,
                         {"params": tree2, "opt": state2})
    for a, b in zip(tckpt.tree_leaves(back), ours):
        if isinstance(a, int):
            assert a == b
        else:
            assert torch.equal(a.detach(), b.detach())
    meta = json.loads((tmp_path / "port" / "step_00000001" /
                       "structure.json").read_text())
    assert "enc_blocks" in json.dumps(meta["paths"])


def test_cli_trains_whisper_on_the_cpu(capsys):
    """launch/train.py takes --arch whisper-base; --num-layers sets the
    decoder's depth."""
    from repro_torch.launch.train import main
    main(["--arch", "whisper-base", "--reduced", "--num-layers", "2",
          "--steps", "2", "--global-batch", "2", "--micro-batches", "2",
          "--seq-len", "12", "--accumulation", "adama_layerwise",
          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done; final loss" in out, out


def test_profile_classes_cross_attention_as_attention():
    """launch/profile_step.py's split of a whisper-base step (seq 448, 1500
    frames, micro-batches of 8): the encoder's (.., heads, 1500, x) and the
    cross-attention's (.., heads, 448, x) operators are "attention", the
    einsums' batched products over micro-batch x heads too."""
    from repro_torch.launch.profile_step import shape_class
    cfg = get_config("whisper-base")
    cases = {
        ("aten::bmm", ((64, 1500, 64), (64, 64, 1024))): "attention",
        ("aten::bmm", ((64, 448, 1024), (64, 1024, 64))): "attention",
        ("aten::mul", ((8, 8, 1500, 1024), ())): "attention",
        ("aten::bmm", ((8, 8, 448, 64), (8, 8, 64, 1024))): "attention",
        ("aten::where", ((8, 1, 448, 1024), (8, 8, 448, 1024), ())):
            "attention",
        ("aten::mm", ((3584, 512), (512, 2048))): "gemm",
        ("aten::add", ((8, 1500, 512), (8, 1500, 512))): "other",
    }
    for (name, shapes), want in cases.items():
        assert shape_class(name, [list(x) for x in shapes], cfg, 448,
                           micro_batch=8) == want, (name, shapes)
