"""The port's model (repro_torch.models) against the reference's
(repro.models): each module, then logits, loss and packed gradient arenas of
the reduced bert_large, stablelm_1_6b, rwkv6_7b, mistral_nemo_12b (swa,
past its window) and minicpm3_4b (mla, with and without its q low-rank
projection), deepseek_v2_lite_16b (MoE with mla, a dense prefix layer),
hymba_1_5b (hybrid: swa attention and Mamba heads, past its window),
whisper_base (enc-dec), internvl2_26b (vlm), yi_9b and deepseek_v2_236b
from the reference's own params."""
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
# gqa attention sublayers (mistral-nemo's with its window of 64, at a
# sequence past it)
ARCHS = ("bert_large", "stablelm_1_6b", "mistral_nemo_12b")
# the reference's reduced minicpm3 drops q_lora_rank, so a reduced run never
# reaches wq_a, q_norm and wq_b: "+qlora" keeps a q low-rank projection
VARIANTS = {"qlora": dict(q_lora_rank=96)}
# whole-model tests also cover the rwkv6 family (its own module tests are in
# test_torch_rwkv6.py) and mla
ALL_ARCHS = ARCHS + ("rwkv6_7b", "minicpm3_4b", "minicpm3_4b+qlora",
                     "deepseek_v2_lite_16b", "hymba_1_5b", "whisper_base",
                     "internvl2_26b", "yi_9b", "deepseek_v2_236b")
# the swa models run past their reduced window of 64
SEQ = {"mistral_nemo_12b": 96, "hymba_1_5b": 96}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(jx, tx, **tol):
    np.testing.assert_allclose(np.asarray(tx.detach().float()),
                               np.asarray(jx, np.float32), **(tol or TOL))


def _variant(arch):
    arch, _, variant = arch.partition("+")
    return arch, VARIANTS.get(variant, {})


def _jcfg(arch):
    arch, over = _variant(arch)
    return tiny(arch, **over)


def _tcfg(arch):
    """The port's twin of conftest.tiny(arch): reduced, fp32 compute."""
    arch, over = _variant(arch)
    return dataclasses.replace(t_get_config(arch).reduced(),
                               compute_dtype="float32", **over)


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


@pytest.mark.parametrize("window", [None, 5, 64])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("kv_block", [4, 1024])
def test_sliding_window_attention_matches_reference(window, hq, hkv,
                                                    kv_block):
    """Causal attention at a sequence past the window: with kv_block 4 a
    query's early blocks are wholly outside its window (masked rows that
    must add nothing), with 1024 one block holds the whole band."""
    s = 80
    q, k, v = (_rand(15, 2, hq, s, 8), _rand(16, 2, hkv, s, 8),
               _rand(17, 2, hkv, s, 8))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jmd.blockwise_attention(q, k, v, causal=True, q_positions=pos,
                                   kv_positions=pos, window=window,
                                   kv_block=kv_block)
    got = tmd.blockwise_attention(*map(torch.tensor, (q, k, v)), causal=True,
                                  q_positions=torch.tensor(pos),
                                  kv_positions=torch.tensor(pos),
                                  window=window, kv_block=kv_block)
    _close(want, got)


@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_freqs_match_reference_bit_for_bit(head_dim, theta):
    """Bit for bit at every head size of the repo's models (32: the reduced
    configs; 64: bert-large, stablelm-1.6b, hymba-1.5b; 128: mistral-nemo
    at theta 1e6) and at 256: the power is formed in float64 and rounded
    once, as XLA's float32 pow is (torch's float32 pow differed by 1 ulp on
    1 of 64 frequencies at 128 and theta 1e6)."""
    want = np.asarray(jmd.rope_freqs(head_dim, theta))
    got = tmd.rope_freqs(head_dim, theta)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_and_mlp_sublayers_match_reference(arch):
    jcfg, tcfg = tiny(arch), _tcfg(arch)
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(1))["blocks"])
    tblock = {k: torch.tensor(v) for k, v in block.items()}
    s = 11 if tcfg.window is None else tcfg.window + 16
    x = _rand(8, 2, s, jcfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    causal = arch != "bert_large"
    _close(jmd.gqa_attention(jcfg, block, x, pos, causal=causal),
           tmd.gqa_attention(tcfg, tblock, torch.tensor(x), torch.tensor(pos),
                             causal=causal))
    _close(jmd.mlp(jcfg, block, x), tmd.mlp(tcfg, tblock, torch.tensor(x)))


@pytest.mark.parametrize("arch", ["minicpm3_4b", "minicpm3_4b+qlora"])
def test_mla_attention_matches_reference(arch):
    """q and k of head size 32 + 16 (softmax scale 1/sqrt(48)), v of 32,
    the rotary key shared by the 4 heads; with q_lora_rank also the q
    down-projection, its rmsnorm and its up-projection."""
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(1))["blocks"])
    assert ("wq_a" in block) == (tcfg.q_lora_rank is not None)
    tblock = {k: torch.tensor(v) for k, v in block.items()}
    x = _rand(18, 2, 23, jcfg.d_model)
    pos = np.broadcast_to(np.arange(23, dtype=np.int32), (2, 23))
    tx, tpos = torch.tensor(x), torch.tensor(pos)
    for name in ("mla_project_q", "mla_latent"):
        for j, t in zip(getattr(jmd, name)(jcfg, block, x),
                        getattr(tmd, name)(tcfg, tblock, tx)):
            _close(j, t)
    _close(jmd.mla_attention(jcfg, block, x, pos),
           tmd.mla_attention(tcfg, tblock, tx, tpos))


def _setup(arch, b=4, s=16):
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = tmodel.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_data(tcfg, s, b, seed=3).batch(0)
    return jcfg, tcfg, jparams, tparams, batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_loss_and_gradient_arena_match_reference(arch):
    s = SEQ.get(arch, 16)
    jcfg, tcfg, jparams, tparams, batch = _setup(arch, s=s)
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
    assert tlogits.shape == (4, s, tcfg.padded_vocab())
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
    (the random numbers differ: torch.Generator is not jax.random); a leaf
    the reference fills with one value (norms' ones and zeros, rwkv6's
    0.5 mixes, hybrid's dt_bias -4.6 and D_skip) holds exactly that value."""
    jparams = jmodel.init_params(_jcfg(arch), jax.random.key(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    tparams = tmodel.init_params(_tcfg(arch), gen)
    jleaves, jpaths = tarena.tree_flatten(jax.tree.map(np.asarray, jparams))
    tleaves, tpaths = tarena.tree_flatten(tparams)
    assert jpaths == tpaths
    for path, j, t in zip(tpaths, jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape), path
        assert t.dtype == torch.float32
        if j.size > 1 and (j == j.flat[0]).all():
            assert (t == float(j.flat[0])).all(), path
            continue
        # the per-leaf std (~0.02 or the out scale)
        np.testing.assert_allclose(float(t.std()) if t.numel() > 1 else 0.0,
                                   float(np.std(j, ddof=1))
                                   if j.size > 1 else 0.0,
                                   rtol=0.2, atol=1e-7, err_msg=str(path))
    model = tmodel.Model(_tcfg(arch), tparams)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        ".".join(p) for p in tpaths)


def test_other_families_raise_not_implemented():
    """Every (arch_type, attention) pair of the reference's configs is
    ported; a pair none of them has (an enc-dec model with mla attention)
    is refused."""
    cfg = dataclasses.replace(_tcfg("stablelm_1_6b"), arch_type="audio",
                              attention="mla")
    with pytest.raises(NotImplementedError,
                       match="no family of the reference's configs"):
        tmodel.init_params(cfg, torch.Generator())
    from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs import get_config as jax_get_config
    for arch in JAX_ARCH_IDS:
        cfg = jax_get_config(arch)
        assert (cfg.arch_type, cfg.attention) in tmodel.FAMILIES, arch


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "minicpm3-4b"])
def test_cli_trains_the_swa_and_mla_families_with_a_depth_cut(arch, capsys):
    """launch/train.py takes the new archs and cuts their depth with
    --num-layers (the card runs them at 4 and 24 layers)."""
    from repro_torch.launch.train import main
    main(["--arch", arch, "--reduced", "--num-layers", "1", "--steps", "2",
          "--global-batch", "2", "--micro-batches", "2", "--seq-len", "72",
          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done; final loss" in out, out
