"""The port's own copies of the configs, the synthetic data pipeline and
the learning-rate schedules against the reference's: field for field,
batch for batch, bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape
from repro.data import make_data as jax_make_data
from repro.optim import schedule as jsched
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, OptimizerConfig,
                                      get_config)
from repro_torch.data import make_data
from repro_torch.optim import schedule as tsched


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_model_config_fields_match_reference(arch, reduced):
    t, j = get_config(arch), jax_get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for name, value in _fields(t).items():
        ref = getattr(j, name)
        if dataclasses.is_dataclass(value):       # ssm: the port's own class
            assert _fields(ref) == _fields(value), name
        else:
            assert ref == value, name
    assert t.padded_vocab() == j.padded_vocab()
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.resolved_v_head_dim == j.resolved_v_head_dim


def test_swa_and_mla_configs_are_the_published_ones():
    nemo, cpm = get_config("mistral-nemo-12b"), get_config("minicpm3-4b")
    assert (nemo.num_layers, nemo.d_model, nemo.n_heads, nemo.n_kv_heads,
            nemo.resolved_head_dim, nemo.d_ff, nemo.vocab_size,
            nemo.rope_theta, nemo.attention, nemo.window,
            nemo.max_seq_len) == (40, 5120, 32, 8, 128, 14336, 131072, 1e6,
                                  "swa", 4096, 131072)
    assert (cpm.num_layers, cpm.d_model, cpm.n_heads, cpm.d_ff,
            cpm.vocab_size, cpm.attention, cpm.q_lora_rank,
            cpm.kv_lora_rank, cpm.qk_nope_head_dim, cpm.qk_rope_head_dim,
            cpm.resolved_v_head_dim, cpm.head_dim) == (
                62, 2560, 40, 6400, 73448, "mla", 768, 256, 64, 32, 64, 64)
    assert nemo.reduced().window == 64 and cpm.reduced().q_lora_rank is None


def test_moe_config_is_the_published_one():
    """deepseek-v2-lite-16b (arXiv:2405.04434): 27 layers, the first dense
    (d_ff 10944), 64 routed experts of 1408 + 2 shared, top-6; mla without
    a q low-rank projection. Reduced: 4 experts of 128, top-2, one shared,
    one dense layer."""
    cfg = get_config("deepseek-v2-lite-16b")
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.n_heads,
            cfg.d_ff, cfg.vocab_size, cfg.attention, cfg.q_lora_rank,
            cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.resolved_v_head_dim, cfg.max_seq_len) == (
                "moe", 27, 2048, 16, 10944, 102400, "mla", None, 512, 128,
                64, 128, 32768)
    mc = cfg.moe
    assert (mc.n_experts, mc.n_shared, mc.top_k, mc.d_expert,
            mc.capacity_factor, mc.dense_prefix, mc.router_aux_weight) == (
                64, 2, 6, 1408, 1.25, 1, 0.001)
    rm = cfg.reduced().moe
    assert (rm.n_experts, rm.n_shared, rm.top_k, rm.d_expert,
            rm.dense_prefix) == (4, 1, 2, 128, 1)


def test_bert_large_is_the_papers_workload():
    cfg = get_config("bert-large")
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab()) == (24, 1024, 16, 4096, 30522,
                                                    30592)
    assert (cfg.arch_type, cfg.norm, cfg.act, cfg.pos_emb) == \
        ("encoder", "layernorm", "gelu", "sinusoidal")
    with pytest.raises(KeyError):
        get_config("no_such_arch")               # not a config of the repo


def test_hybrid_config_is_the_published_one():
    """hymba-1.5b (arXiv:2411.13676): 32 layers, d_model 1600, 25 heads
    on 5 kv heads of 64, d_ff 5504, vocab 32001 (32128 padded), swa with
    window 1024, Mamba heads of state 16, conv 4, expansion 2 (d_inner
    3200, dt rank 100). Reduced: window 64, d_inner 512."""
    cfg = get_config("hymba-1.5b")
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.padded_vocab(), cfg.attention, cfg.window,
            cfg.max_seq_len) == ("hybrid", 32, 1600, 25, 5, 64, 5504, 32001,
                                 32128, "swa", 1024, 8192)
    sc = cfg.ssm
    assert (sc.d_state, sc.d_conv, sc.expand, sc.expand * cfg.d_model,
            max(1, cfg.d_model // 16)) == (16, 4, 2, 3200, 100)
    red = cfg.reduced()
    assert (red.window, red.ssm.expand * red.d_model) == (64, 512)


def test_last_two_configs_are_the_published_ones():
    """yi-9b (arXiv:2403.04652): 48 layers, d_model 4096, 32 heads on 4 kv
    heads of 128, d_ff 11008, vocab 64000; deepseek-v2-236b
    (arXiv:2405.04434): 60 layers, d_model 5120, 128 heads, mla (q low
    rank 1536, kv latent 512, q/k 128 + 64, v 128), 160 routed experts of
    1536 + 2 shared, top-6, the first block dense (d_ff 12288)."""
    yi, ds = get_config("yi-9b"), get_config("deepseek-v2-236b")
    assert (yi.arch_type, yi.num_layers, yi.d_model, yi.n_heads,
            yi.n_kv_heads, yi.resolved_head_dim, yi.d_ff, yi.vocab_size,
            yi.attention, yi.max_seq_len) == ("dense", 48, 4096, 32, 4, 128,
                                              11008, 64000, "gqa", 4096)
    assert (ds.arch_type, ds.num_layers, ds.d_model, ds.n_heads, ds.d_ff,
            ds.vocab_size, ds.attention, ds.q_lora_rank, ds.kv_lora_rank,
            ds.qk_nope_head_dim, ds.qk_rope_head_dim,
            ds.resolved_v_head_dim) == ("moe", 60, 5120, 128, 12288, 102400,
                                        "mla", 1536, 512, 128, 64, 128)
    mc = ds.moe
    assert (mc.n_experts, mc.n_shared, mc.top_k, mc.d_expert,
            mc.dense_prefix) == (160, 2, 6, 1536, 1)
    assert len(ARCH_IDS) == 11
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


def test_optimizer_config_defaults_match_reference():
    """Every port field defaults as the reference's does, with one
    documented exception: `arena` defaults to True, since the port has only
    kernel paths and its main path is the arena (the reference defaults to
    use_pallas=False, arena=False)."""
    t, j = OptimizerConfig(), JaxOptimizerConfig()
    exceptions = {"arena": True}
    for name, value in _fields(t).items():
        if name in exceptions:
            assert value == exceptions[name] != getattr(j, name), name
        else:
            assert getattr(j, name) == value, name
    assert OptimizerConfig(accumulation="adama_layerwise").arena
    assert not OptimizerConfig(accumulation="adama_layerwise",
                               arena=False).arena
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        OptimizerConfig(accumulation="ga", arena=False)
    with pytest.raises(ValueError):
        OptimizerConfig(accumulation="adam")
    assert isinstance(get_config("stablelm-1.6b"), ModelConfig)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("seq_len", [16, 100])
def test_synthetic_batches_are_bit_identical(arch, seq_len):
    cfg = get_config(arch).reduced()
    ours = make_data(cfg, seq_len, 6, seed=7)
    ref = jax_make_data(jax_get_config(arch).reduced(),
                        InputShape("t", seq_len, 6, "train"), seed=7)
    for i in (0, 1, 5):
        a, b = ours.batch(i), ref.batch(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if cfg.arch_type == "encoder":
        assert (a["tokens"] == cfg.vocab_size - 1).any()
        assert ((a["labels"] == -1) | (a["tokens"] == cfg.vocab_size - 1)).all()


def test_schedules_match_reference():
    for step in range(0, 30):
        for t, j in ((tsched.warmup_cosine(1e-3, 5, 20),
                      jsched.warmup_cosine(1e-3, 5, 20)),
                     (tsched.warmup_cosine(3e-4, 0, 7, min_lr=1e-5),
                      jsched.warmup_cosine(3e-4, 0, 7, min_lr=1e-5))):
            got = t(step)
            want = np.float32(j(jnp.asarray(step, jnp.int32)))
            assert got.dtype == np.float32
            # same float32 operation order; numpy's and XLA's float32 cos
            # differ by a few ulp
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert tsched.constant(1e-3)(step) == np.float32(
            jsched.constant(1e-3)(step))
