"""The port's hybrid family (repro_torch.models.modules._causal_conv,
associative_scan, mamba_mix and the hybrid block of models.model.apply_block)
against the reference's (repro.models.modules, jax.lax.associative_scan,
repro.models.model.apply_block), on the CPU at the reduced hymba-1.5b
(d_model 256, d_inner 512, d_state 16, window 64)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import model as jmodel
from repro.models import modules as jmd
from repro_torch.configs.base import get_config
from repro_torch.data import make_data
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmd

torch.set_num_threads(1)

ARCH = "hymba_1_5b"
MAMBA = ("A_log", "D_skip", "conv_b", "conv_w", "dt_bias", "w_B", "w_C",
         "w_dt_a", "w_dt_b", "w_in", "w_out")
# mamba_mix and the hybrid block in fp32 against the reference's, jitted:
# XLA's exp, its einsum and matmul sums and its reductions in the backward
# differ from torch's in the last bits. Each output and gradient is held
# within this share of the reference's largest |value| in it; measured at
# most 1.07e-6 (w_dt_b's gradient, in mamba_mix and in the block), y 9.5e-7
# (mamba_mix) and 3.9e-7 (the block)
MAMBA_REL = 5e-6


def _tcfg(**over):
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32", **over)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _block(seed=1):
    """Layer 0 of the reference's reduced hymba params (numpy)."""
    return jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        tiny(ARCH), jax.random.key(seed))["blocks"])


def _close_rel(want, got, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MAMBA_REL * float(np.abs(want).max()),
                               err_msg=what)


def test_reduced_config_is_the_references_shape():
    cfg = _tcfg()
    assert (cfg.d_model, cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state,
            cfg.ssm.d_conv, cfg.window, cfg.attention) == (256, 512, 16, 4,
                                                           64, "swa")
    full = get_config("hymba-1.5b")
    assert (full.d_model, full.ssm.expand * full.d_model,
            max(1, full.d_model // 16)) == (1600, 3200, 100)


@pytest.mark.parametrize("s", [1, 5, 80])
def test_causal_conv_matches_reference_bit_for_bit(s):
    """The left-padded depthwise conv, its terms contracted as XLA CPU
    contracts the reference's jitted sum; the carried conv inputs too."""
    x = _rand(s, 2, s, 512)
    w = _rand(100 + s, 4, 512, scale=0.2)
    want, wstate = jax.jit(lambda x, w: jmd._causal_conv(x, w))(x, w)
    got, state = tmd._causal_conv(torch.tensor(x), torch.tensor(w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(state.numpy(), np.asarray(wstate))


def _linear_combine_jax(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 80])
def test_associative_scan_matches_lax_bit_for_bit(n):
    """The odd/even recursion of lax.associative_scan (jitted: XLA CPU
    contracts a2 * b1 + b2 into one fused multiply-add), both outputs, on
    the selective scan's combine, along axis 1 of (B, n, C, N); and a sum
    scan, whose tree of additions the recursion fixes."""
    rng = np.random.default_rng(n)
    a = np.exp(-rng.random((2, n, 8, 4))).astype(np.float32)
    b = rng.standard_normal((2, n, 8, 4)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        _linear_combine_jax, (a, b), axis=1))(a, b)
    got = tmd.associative_scan(tmd.ssm_combine,
                               (torch.tensor(a), torch.tensor(b)), 1)
    for w, g in zip(want, got):
        assert g.shape == (2, n, 8, 4)
        assert np.array_equal(g.numpy(), np.asarray(w))
    want = jax.jit(lambda b: jax.lax.associative_scan(jnp.add, b,
                                                      axis=1))(b)
    got, = tmd.associative_scan(lambda x, y: [x[0] + y[0]],
                                [torch.tensor(b)], 1)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [16, 80])
def test_mamba_mix_and_its_gradients_match_reference(s):
    """y, the final state and the vjp gradients of every Mamba leaf and of
    x, against jax.vjp of the jitted reference, within MAMBA_REL."""
    block = _block()
    pm = {k: block[k] for k in MAMBA}
    x = _rand(5, 2, s, 256)
    dy = _rand(6, 2, s, 256, scale=0.1)
    jcfg, tcfg = tiny(ARCH), _tcfg()
    (jy, _, jstate), vjp = jax.vjp(
        jax.jit(lambda p, x: jmd.mamba_mix(jcfg, p, x)), pm, x)
    jg, jdx = vjp((dy, jnp.zeros((2, 3, 512)), jnp.zeros((2, 512, 16))))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in pm.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, conv_state, state = tmd.mamba_mix(tcfg, tp, tx)
    assert ty.shape == (2, s, 256) and state.dtype == torch.float32
    assert conv_state.shape == (2, 3, 512) and state.shape == (2, 512, 16)
    _close_rel(jy, ty, "y")
    _close_rel(jstate, state, "ssm state")
    grads = torch.autograd.grad(ty, [tp[k] for k in MAMBA] + [tx],
                                torch.tensor(dy))
    for k, g in zip(MAMBA, grads):
        assert g.shape == pm[k].shape
        _close_rel(jg[k], g, k)
    _close_rel(jdx, grads[-1], "dx")


def test_hybrid_block_matches_reference_past_the_window():
    """apply_block of kind "hybrid" at s = window + 16: sliding-window
    attention and the Mamba heads on the same normed input, each rms-normed
    by its fuse norm, their mean added; forward and the gradients of every
    leaf of the block and of x."""
    jcfg, tcfg = tiny(ARCH), _tcfg()
    block = _block(2)
    # fuse norms other than ones, so their gradients and scales matter
    block["fuse_norm_a"] = 1.0 + _rand(3, 256, scale=0.1)
    block["fuse_norm_m"] = 1.0 + _rand(4, 256, scale=0.1)
    s = tcfg.window + 16
    x = _rand(7, 2, s, 256)
    dy = _rand(8, 2, s, 256, scale=0.1)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    (jy, _), vjp = jax.vjp(jax.jit(lambda p, x: jmodel.apply_block(
        jcfg, p, x, pos, kind="hybrid")), block, x)
    jg, jdx = vjp((dy, jnp.zeros((), jnp.float32)))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in block.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, aux = tmodel.apply_block(tcfg, tp, tx, torch.tensor(pos),
                                 kind="hybrid")
    assert float(aux) == 0.0
    _close_rel(jy, ty, "y")
    keys = sorted(block)
    grads = torch.autograd.grad(ty, [tp[k] for k in keys] + [tx],
                                torch.tensor(dy))
    for k, g in zip(keys, grads):
        _close_rel(jg[k], g, k)
    _close_rel(jdx, grads[-1], "dx")
    # the window matters at this length
    dense = dataclasses.replace(tcfg, attention="gqa", window=None)
    with torch.no_grad():
        full, _ = tmodel.apply_block(dense, tp, tx, torch.tensor(pos),
                                     kind="hybrid")
    assert not torch.equal(full, ty.detach())


@pytest.mark.parametrize("which", ["conv_state", "ssm_state", "one_step"])
def test_decode_form_raises_not_implemented(which):
    cfg = _tcfg()
    p = {k: torch.tensor(v) for k, v in _block().items()}
    s = 1 if which == "one_step" else 4
    x = torch.zeros((1, s, 256))
    kw = {"conv_state": torch.zeros((1, 3, 512)),
          "ssm_state": torch.zeros((1, 512, 16))}.get(which)
    kw = {which: kw} if kw is not None else {}
    with pytest.raises(NotImplementedError, match="item 11"):
        tmd.mamba_mix(cfg, p, x, **kw)


def test_remat_equals_the_plain_forward_bit_for_bit():
    """loss_fn with every layer checkpointed equals the plain one: the loss
    and every leaf's gradient, bit for bit (the recompute runs the same
    ops, the scan's _fma32 included)."""
    cfg = _tcfg()
    params = tmodel.params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(
        tiny(ARCH), jax.random.key(0))), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 80, 2, seed=3).batch(0).items()}
    out = []
    for remat in (False, True):
        model = tmodel.Model(cfg, {k: (dict(v) if isinstance(v, dict) else v)
                                   for k, v in params.items()})
        leaves = list(model.parameters())
        loss = tmodel.loss_fn(cfg, model.tree(), batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_cli_trains_hymba_with_a_depth_cut(capsys):
    """launch/train.py takes --arch hymba-1.5b and cuts its depth with
    --num-layers (the card runs it at 8 of 32 layers), past its window."""
    from repro_torch.launch.train import main
    main(["--arch", "hymba-1.5b", "--reduced", "--num-layers", "2",
          "--steps", "2", "--global-batch", "2", "--micro-batches", "2",
          "--seq-len", "72", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done; final loss" in out, out


def test_profile_classes_the_hybrid_blocks_operators_by_shape():
    """launch/profile_step.py's split of a hymba-1.5b step (8 layers, seq
    2048): the scan's fp32 (.., d_inner, d_state) operators and their
    broadcast operands are "ssm", the blockwise attention's (.., heads, S,
    kv) ones "attention", the other matrix products "gemm"."""
    from repro_torch.launch.profile_step import shape_class
    cfg = dataclasses.replace(get_config("hymba-1.5b"), num_layers=8)
    cases = {
        ("aten::mul", ((1, 2049, 3200, 16), (1, 2049, 3200, 16))): "ssm",
        ("aten::mul", ((1, 2048, 3200, 1), (3200, 16))): "ssm",
        ("aten::mul", ((1, 2048, 3200, 1), (1, 2048, 1, 16))): "ssm",
        ("aten::bmm", ((2048, 3200, 16), (2048, 16, 1))): "ssm",
        ("aten::bmm", ((25, 2048, 64), (25, 64, 1024))): "attention",
        ("aten::where", ((1, 1, 2048, 1024), (1, 25, 2048, 1024), ())):
            "attention",
        ("aten::mm", ((2048, 1600), (1600, 6400))): "gemm",
        ("aten::add", ((1, 2048, 1600), (1, 2048, 1600))): "other",
    }
    for (name, shapes), want in cases.items():
        assert shape_class(name, [list(x) for x in shapes], cfg,
                           2048) == want, (name, shapes)
