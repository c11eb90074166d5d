"""The port's model (repro_torch.models) against the reference's
(repro.models): each module, then logits, loss and packed gradient arenas of
the reduced bert_large, stablelm_1_6b and rwkv6_7b from the reference's own
params."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.core import arena as jarena
from repro.models import model as jmodel
from repro.models import modules as jmd
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import arena as tarena
from repro_torch.data import make_data
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmd

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ("bert_large", "stablelm_1_6b")
# whole-model tests also cover the rwkv6 family (its own module tests are in
# test_torch_rwkv6.py)
ALL_ARCHS = ARCHS + ("rwkv6_7b",)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(jx, tx, **tol):
    np.testing.assert_allclose(np.asarray(tx.detach().float()),
                               np.asarray(jx, np.float32), **(tol or TOL))


def _tcfg(arch):
    """The port's twin of conftest.tiny(arch): reduced, fp32 compute."""
    return dataclasses.replace(t_get_config(arch).reduced(),
                               compute_dtype="float32")


def test_norms_match_reference():
    x, w, b = _rand(0, 2, 5, 64), _rand(1, 64), _rand(2, 64)
    _close(jmd.layernorm(x, w, b),
           tmd.layernorm(torch.tensor(x), torch.tensor(w), torch.tensor(b)))
    _close(jmd.rmsnorm(x, w), tmd.rmsnorm(torch.tensor(x), torch.tensor(w)))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_activations_match_reference(act):
    x = _rand(3, 4, 33, scale=3.0)
    _close(jmd.act_fn(act)(x), tmd.act_fn(act)(torch.tensor(x)))


def test_rope_and_sinusoidal_positions_match_reference():
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    x = _rand(4, 2, 9, 3, 16)
    _close(jmd.apply_rope(x, pos, 10000.0),
           tmd.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0))
    _close(jmd.sinusoidal_positions(pos, 32),
           tmd.sinusoidal_positions(torch.tensor(pos), 32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("kv_block", [4, 1024])
def test_blockwise_attention_matches_reference(causal, hq, hkv, kv_block):
    s = 19
    q, k, v = (_rand(5, 2, hq, s, 8), _rand(6, 2, hkv, s, 8),
               _rand(7, 2, hkv, s, 8))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jmd.blockwise_attention(q, k, v, causal=causal, q_positions=pos,
                                   kv_positions=pos, kv_block=kv_block)
    got = tmd.blockwise_attention(*map(torch.tensor, (q, k, v)),
                                  causal=causal,
                                  q_positions=torch.tensor(pos),
                                  kv_positions=torch.tensor(pos),
                                  kv_block=kv_block)
    _close(want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_and_mlp_sublayers_match_reference(arch):
    jcfg, tcfg = tiny(arch), _tcfg(arch)
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(1))["blocks"])
    tblock = {k: torch.tensor(v) for k, v in block.items()}
    x = _rand(8, 2, 11, jcfg.d_model)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    causal = arch != "bert_large"
    _close(jmd.gqa_attention(jcfg, block, x, pos, causal=causal),
           tmd.gqa_attention(tcfg, tblock, torch.tensor(x), torch.tensor(pos),
                             causal=causal))
    _close(jmd.mlp(jcfg, block, x), tmd.mlp(tcfg, tblock, torch.tensor(x)))


def _setup(arch, b=4, s=16):
    jcfg, tcfg = tiny(arch), _tcfg(arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_data(tcfg, s, b, seed=3).batch(0)
    return jcfg, tcfg, jparams, tparams, batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_loss_and_gradient_arena_match_reference(arch):
    jcfg, tcfg, jparams, tparams, batch = _setup(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if arch == "bert_large":                       # MLM masking is present
        assert (batch["labels"] == -1).any()
        assert (batch["tokens"] == tcfg.vocab_size - 1).any()
    jlogits, _ = jax.jit(lambda p, b: jmodel.forward(jcfg, p, b))(jparams,
                                                                  jbatch)
    model = tmodel.Model(tcfg, tparams)
    tlogits, _ = model(tbatch)
    assert tlogits.dtype == torch.float32
    assert tlogits.shape == (4, 16, tcfg.padded_vocab())
    _close(jlogits, tlogits, rtol=1e-5, atol=1e-5)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jcfg, p, b)))(jparams, jbatch)
    tree = model.tree()
    leaves, paths = tarena.tree_flatten(tree)
    tloss = tmodel.loss_fn(tcfg, tree, tbatch)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tgrads = tarena.tree_unflatten(paths, list(
        torch.autograd.grad(tloss, leaves)))
    jlayout, tlayout = jarena.build_layout(jparams), tarena.build_layout(tree)
    assert jlayout.rows == tlayout.rows
    # rwkv6's gradients reach 0.57 (the embedding) and its time-mix sums the
    # chunked scan in another order than XLA: largest |difference| measured
    # 3.3e-6, 6e-6 of its leaf's largest value
    atol = 1e-5 if arch == "rwkv6_7b" else 1e-7
    np.testing.assert_allclose(tarena.pack(tgrads, tlayout).numpy(),
                               np.asarray(jarena.pack(jgrads, jlayout)),
                               rtol=1e-4, atol=atol)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_have_the_reference_tree(arch):
    """Same keys, shapes, dtypes and scales as repro.models.model.init_params
    (the numbers differ: torch.Generator is not jax.random)."""
    jparams = jmodel.init_params(tiny(arch), jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    tparams = tmodel.init_params(_tcfg(arch), gen)
    jleaves, jpaths = tarena.tree_flatten(jax.tree.map(np.asarray, jparams))
    tleaves, tpaths = tarena.tree_flatten(tparams)
    assert jpaths == tpaths
    for path, j, t in zip(tpaths, jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape), path
        assert t.dtype == torch.float32
        # the per-leaf std (0 for ones/zeros, ~0.02 or the out scale)
        np.testing.assert_allclose(float(t.std()) if t.numel() > 1 else 0.0,
                                   float(np.std(j, ddof=1))
                                   if j.size > 1 else 0.0,
                                   rtol=0.2, atol=1e-7, err_msg=str(path))
    model = tmodel.Model(_tcfg(arch), tparams)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        ".".join(p) for p in tpaths)


def test_other_families_raise_not_implemented():
    cfg = dataclasses.replace(_tcfg("stablelm_1_6b"), arch_type="moe")
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        tmodel.init_params(cfg, torch.Generator())
