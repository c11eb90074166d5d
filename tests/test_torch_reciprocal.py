"""Division by the micro-batch count N in the port's engines against the
reference's jitted expressions, at N = 3 where f32(1/N) is inexact: XLA
CPU rewrites `x / n` by a constant as x * f32(1/N), and contracts ga's
`acc + pack(g) / n` into one fused multiply-add except on the zero-padded
leaves whose pad it fuses into the sum's loop (core/accumulation.py
`uncontracted_rows`). ga's accumulator, on every reduced model, a narrow
deepseek whose only padded stacked leaf is kv_norm, a whisper-base at its
own widths, and synthetic trees around XLA's fusion limit, and per-leaf adama's scaled gradient are held
bit for bit; the ga and per-leaf adama engines at N = 3 within the
Fp32Codec's engine tolerance. (Every other parity test runs N = 2, where
1/N is exact.)"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.core import arena as jarena
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.models import model as jmodel
from repro.optim import schedule as jsched
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core import accumulation as tacc
from repro_torch.data import make_data
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched

torch.set_num_threads(1)

ENGINE_TOL = 5e-6        # Fp32Codec's declared engine tolerance
# "+qlora": minicpm3 with its q low-rank projection, which the reduced
# config drops; "+narrow": deepseek at d_model 1024 and kv_lora_rank 512,
# where kv_norm is the only padded leaf of each stacked region, as at full
# width
# "+width": whisper-base at its own widths (d_model 512, 8 heads of 64,
# d_ff 2048), one layer a stack, vocab cut to 1024: two stacked regions
# and six rest leaves, four of them half-row norms, so the arena's
# concatenate (with its zero rows) is past XLA's fusion limit
VARIANTS = {"qlora": dict(q_lora_rank=96),
            "narrow": dict(d_model=1024, kv_lora_rank=512),
            "width": dict(d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                          d_ff=2048, vocab_size=1024)}
ARCHS = ("bert_large", "stablelm_1_6b", "rwkv6_7b", "mistral_nemo_12b",
         "minicpm3_4b", "minicpm3_4b+qlora", "deepseek_v2_lite_16b",
         "deepseek_v2_lite_16b+narrow", "hymba_1_5b", "whisper_base",
         "whisper_base+width", "internvl2_26b", "yi_9b",
         "deepseek_v2_236b")


def _f32(*shape):
    return np.zeros(shape, np.float32)


# synthetic trees around XLA CPU's fusion limit (a concatenate of at most 8
# operands is fused into the sum's loop), with the number of leaf ranges
# `uncontracted_rows` names in each
TREES = {
    # one padded stacked leaf: its region's pack is fused, so its rows
    # are not contracted, as the rest region's padded leaf's are not
    "stack-one-padded": ({"blocks": {"n": _f32(2, 512), "w": _f32(2, 2048)},
                          "embed": _f32(8, 1024),
                          "final_norm_scale": _f32(600)}, 3),
    # deepseek's shape: one padded leaf in each of two stacked regions
    "two-stacks-one-padded-each": (
        {"blocks": {"n": _f32(3, 512), "w": _f32(3, 2048)},
         "dense_blocks": {"n": _f32(1, 512), "w": _f32(1, 1024)},
         "embed": _f32(8, 1024), "final_norm_scale": _f32(1024)}, 4),
    # padded leaves of several rows, stacked and in the rest region
    "multi-row-padded": ({"blocks": {"a": _f32(2, 3 * 1024 + 512),
                                     "b": _f32(2, 1024)},
                          "embed": _f32(8, 1024),
                          "final_norm_scale": _f32(2048 + 100)}, 3),
    # 8 stacked leaves and the region's zero rows: 9 operands, not fused
    "stack-nine-operands": ({"blocks": dict(
        {f"w{i}": _f32(2, 1024) for i in range(7)}, n=_f32(2, 512)),
        "embed": _f32(8, 1024), "final_norm_scale": _f32(600)}, 1),
    # the arena's own concatenate at 9 operands: nothing is fused
    "arena-nine-operands": ({"blocks": {"n": _f32(2, 512)},
                             **{f"r{i}": _f32(1024) for i in range(6)},
                             "final_norm_scale": _f32(600)}, 0),
    # ... and at 8, with the tail's zero rows among them: fused
    "arena-eight-with-tail": (
        {"blocks": {"a": _f32(2, 100 * 1024), "n": _f32(2, 512)},
         **{f"r{i}": _f32(1024) for i in range(4)},
         "final_norm_scale": _f32(600)}, 3),
}


def _jcfg(arch):
    arch, _, variant = arch.partition("+")
    return tiny(arch, **VARIANTS.get(variant, {}))


def _tree(arch):
    if arch in TREES:
        return TREES[arch][0]
    return jax.tree.map(np.asarray,
                        jmodel.init_params(_jcfg(arch), jax.random.key(0)))


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                        .astype(np.float32), tree)


def _torch_tree(tree):
    leaves, paths = tarena.tree_flatten(tree)
    return tarena.tree_unflatten(paths,
                                 [torch.from_numpy(x.copy()) for x in leaves])


@pytest.mark.parametrize("arch, n", [(a, 3) for a in ARCHS + tuple(TREES)]
                         + [("stablelm_1_6b", 2), ("stablelm_1_6b", 7)])
def test_ga_accumulate_is_the_reference_expression_bit_for_bit(arch, n):
    """One micro-batch's `acc + pack(g) / n` (src/repro/core/accumulation.py
    :177), jitted, on the reduced model's tree (or a synthetic one), against
    the port's _ga_accumulate on the same acc and g: every element equal."""
    params = _tree(arch)
    layout = jarena.build_layout(params)
    g = _grads_like(params, n)
    acc = np.random.default_rng(1).standard_normal(
        (layout.rows, jarena.LANES)).astype(np.float32) * 1e-2

    want = np.asarray(jax.jit(
        lambda a, g: a + jarena.pack(g, layout) / n)(acc, g))
    tlayout = tarena.build_layout(_torch_tree(params))
    got = torch.from_numpy(acc.copy())
    tacc._ga_accumulate(got, tarena.pack(_torch_tree(g), tlayout),
                        tacc.inv_n(n, "cpu"), tacc.uncontracted_rows(tlayout))
    assert np.array_equal(got.numpy(), want)
    rows = tacc.uncontracted_rows(tlayout)
    if arch in TREES:
        assert len(rows) == TREES[arch][1]
    elif arch.endswith("+narrow"):
        # kv_norm's pads run in fusions of their own; no rest leaf is padded
        assert rows == []
    elif arch.startswith("whisper_base"):
        # 2 stacked regions + 6 rest leaves + the rest's zero rows + the
        # tail: more than 8 operands, nothing fused
        assert rows == []
    else:
        # the padded final norm's rows: the rest region's pack is fused
        assert rows and all(hi - lo == 1 for lo, hi in rows)
    if not n & (n - 1):
        return                                 # f32(1/N) exact: one form
    # on each of those rows the single rounding differs from the two
    # somewhere, so the rule is needed, not merely harmless
    r = tacc.inv_n(n, "cpu")
    slab = tarena.pack(_torch_tree(g), tlayout)
    fma = tacc._fma32(slab, r, torch.from_numpy(acc))
    for lo, hi in rows:
        assert not torch.equal(fma[lo:hi], torch.from_numpy(want[lo:hi].copy()))


def test_per_leaf_scaled_gradient_is_the_reference_expression_bit_for_bit():
    """Per-leaf adama's g / N (src/repro/core/accumulation.py:386), jitted,
    against scale_leaves at N = 3, on every leaf of a reduced model's
    tree."""
    params = jax.tree.map(np.asarray, jmodel.init_params(
        tiny("stablelm_1_6b"), jax.random.key(0)))
    g = _grads_like(params, 4)
    want = jax.jit(lambda g: jax.tree.map(lambda x: x / 3, g))(g)
    got = tacc.scale_leaves(_torch_tree(g), tacc.inv_n(3, "cpu"))
    for a, b in zip(tarena.tree_flatten(got)[0],
                    tarena.tree_flatten(jax.tree.map(np.asarray, want))[0]):
        assert np.array_equal(a.numpy(), b)
    # true division, what the port did before, is not the reference's
    x = tarena.tree_flatten(_torch_tree(g))[0][0]
    assert not torch.equal(x / 3, x * tacc.inv_n(3, "cpu"))


N3, GB3, SEQ3, STEPS3 = 3, 6, 16, 2
# (arch, engine, arena): ga on the arena with the reference's warmup
# schedule (test_torch_engines: ga's first step is ill-conditioned across
# frameworks), per-leaf adama at a constant lr
N3_CASES = {"ga-stablelm": ("stablelm_1_6b", "ga", True),
            "adama-per-leaf-bert": ("bert_large", "adama", False),
            "ga-whisper": ("whisper_base", "ga", True)}


def _schedules(engine):
    if engine != "ga":
        return None, None
    return (jsched.warmup_cosine(1e-3, 1, STEPS3 + 1),
            tsched.warmup_cosine(1e-3, 1, STEPS3 + 1))


def _data(arch):
    data = make_data(get_config(arch).reduced(), SEQ3, GB3, seed=5)
    return [data.batch(i) for i in range(STEPS3)]


@functools.lru_cache(maxsize=None)
def _reference_run(case):
    arch, engine, arena = N3_CASES[case]
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N3, use_pallas=True, arena=arena)
    step, init = jax_make_train_step(tiny(arch), opt,
                                     lr_schedule=_schedules(engine)[0])
    step = jax.jit(step)
    params = jmodel.init_params(tiny(arch), jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    out = []
    for batch in _data(arch):
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]),
                    tarena.tree_flatten(jax.tree.map(np.asarray, params))[0],
                    *(tarena.tree_flatten(jax.tree.map(
                        np.asarray, state[k].data if arena else state[k]))[0]
                      for k in ("m", "v"))))
    return init_params, out


@pytest.mark.parametrize("case", sorted(N3_CASES))
def test_engines_at_three_micro_batches_match_reference(case):
    arch, engine, arena = N3_CASES[case]
    init_params, want = _reference_run(case)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    model = tmodel.Model(cfg, tmodel.params_from_jax(init_params, "cpu"))
    step, init = tacc.make_train_step(
        cfg, OptimizerConfig(accumulation=engine, micro_batches=N3,
                             arena=arena),
        lr_schedule=_schedules(engine)[1])
    tree = model.tree()
    state = init(tree)
    for i, batch in enumerate(_data(arch)):
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss, params, m, v = want[i]
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=0,
                                   atol=1e-5)
        moments = [tarena.tree_flatten(state[k].data if arena else state[k])[0]
                   for k in ("m", "v")]
        for got, ref in zip((tarena.tree_flatten(tree)[0], *moments),
                            (params, m, v)):
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                           atol=ENGINE_TOL)
