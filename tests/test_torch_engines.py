"""The port's engines (repro_torch.core.accumulation) against the
reference's arena engines (make_adama_step / make_ga_step with
OptimizerConfig(use_pallas=True, arena=True)), step for step on the reduced
models: losses, params and the m/v arenas, and one fold per micro-batch
(one per step for ga) and one apply per step; with activation
checkpointing too (the reference's `remat=True` against the port's). The
swa (mistral-nemo) and mla (minicpm3) families run adama here, the MoE
(deepseek-v2-lite) and hybrid (hymba) families adama and ga, and all
three adama_layerwise in test_torch_layerwise.py."""
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
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched

torch.set_num_threads(1)

N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 16, 3
# Fp32Codec's declared engine tolerance in the reference
ENGINE_TOL = 5e-6
# rwkv6: its chunked scan sums in another order than XLA's (log-decay sums
# reach -170 within a chunk, where a float32 ulp is 1.5e-5), so its
# gradients differ from the reference's by up to 6e-6 of a leaf's largest
# value (test_torch_models), and Adam moves an element whose gradient is as
# small as that noise by a noise-decided fraction of lr. Measured over 3
# steps: loss 9.1e-6, params 1.7e-5, m and v 6.3e-4 and 5.0e-4 of their
# largest values.
RWKV_TOL = dict(loss=5e-5, params=5e-5, moments_of_max=2e-3)

# ga folds the ACCUMULATED gradient once, so at its first step v = g^2
# exactly and the update is lr*g/(|g| + eps): an element whose micro-batch
# gradients cancel to |g| ~ eps (they exist at float32 noise level in both
# frameworks) moves by a noise-decided fraction of lr. The ga cases
# therefore run the reference's warmup schedule, which ga reads at the
# pre-increment step: step 1 applies lr 0, later steps see a v that holds
# more than one gradient.
CASES = {
    # (arch, engine, lr schedule, grad_clip)
    "adama-bert": ("bert_large", "adama", None, None),
    "adama-stablelm-cosine": ("stablelm_1_6b", "adama", "cosine", None),
    "ga-bert-cosine": ("bert_large", "ga", "cosine", None),
    "ga-stablelm-cosine-clip": ("stablelm_1_6b", "ga", "cosine", 1.0),
    "adama-rwkv6": ("rwkv6_7b", "adama", None, None),
    "ga-rwkv6-cosine": ("rwkv6_7b", "ga", "cosine", None),
    "adama-mistral-nemo": ("mistral_nemo_12b", "adama", None, None),
    "adama-minicpm3": ("minicpm3_4b", "adama", None, None),
    "adama-deepseek": ("deepseek_v2_lite_16b", "adama", None, None),
    "ga-deepseek-cosine": ("deepseek_v2_lite_16b", "ga", "cosine", None),
    "adama-hymba": ("hymba_1_5b", "adama", None, None),
    "ga-hymba-cosine": ("hymba_1_5b", "ga", "cosine", None),
}
# the swa, mla, MoE and hybrid families run all steps once, without remat
# (the remat cases hold the layer loop, which they share with the gqa
# models)
FAMILY_CASES = ("adama-mistral-nemo", "adama-minicpm3", "adama-deepseek",
                "ga-deepseek-cosine", "adama-hymba", "ga-hymba-cosine")


def _schedules(kind):
    if kind is None:
        return None, None
    return (jsched.warmup_cosine(1e-3, 1, STEPS + 1),
            tsched.warmup_cosine(1e-3, 1, STEPS + 1))


def _data(arch):
    cfg = get_config(arch).reduced()
    data = make_data(cfg, SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference_run(case, remat=False):
    """The reference's trajectory: per step (loss, packed params, m, v)."""
    arch, engine, sched, clip = CASES[case]
    cfg = tiny(arch)
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, grad_clip=clip)
    step, init = jax_make_train_step(cfg, opt, remat=remat,
                                     lr_schedule=_schedules(sched)[0])
    step = jax.jit(step)
    params = jmodel.init_params(cfg, jax.random.key(0))
    init_params = jax.tree.map(np.asarray, params)
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _data(arch):
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(metrics["loss"]),
                    np.asarray(jarena.pack(params, layout)),
                    np.asarray(state["m"].data), np.asarray(state["v"].data),
                    int(state["step"])))
    return init_params, out


# (case, n_steps, remat); the remat cases' ids end in "-remat"
RUNS = [pytest.param(case, n, remat,
                     id=f"{case}-{n}" + ("-remat" if remat else ""))
        for remat in (False, True) for case in sorted(CASES)
        if case not in FAMILY_CASES
        for n in (1, STEPS)] + [pytest.param(case, STEPS, False,
                                             id=f"{case}-{STEPS}")
                                for case in FAMILY_CASES]


@pytest.mark.parametrize("case, n_steps, remat", RUNS)
def test_engine_matches_reference(case, n_steps, remat, monkeypatch):
    arch, engine, sched, clip = CASES[case]
    init_params, want = _reference_run(case, remat)
    calls = {"fold": 0, "apply": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(fused_step, "arena_fold",
                        counted("fold", fused_step.arena_fold))
    monkeypatch.setattr(fused_step, "arena_apply",
                        counted("apply", fused_step.arena_apply))

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          grad_clip=clip)
    model = tmodel.Model(cfg, tmodel.params_from_jax(init_params, "cpu"))
    step, init = make_train_step(cfg, opt, remat=remat,
                                 lr_schedule=_schedules(sched)[1])
    tree = model.tree()
    state = init(tree)
    for i, batch in enumerate(_data(arch)[:n_steps]):
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss, params, m, v, t = want[i]
        folds = (i + 1) * (N_MICRO if engine == "adama" else 1)
        assert calls == {"fold": folds, "apply": i + 1}
        assert state["step"] == t == i + 1
        rwkv = arch == "rwkv6_7b"
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=0,
                                   atol=RWKV_TOL["loss"] if rwkv else 1e-5)
        with torch.no_grad():
            tparams = tarena.pack(tree, state["m"].layout).numpy()
        if rwkv:
            np.testing.assert_allclose(tparams, params, rtol=0,
                                       atol=RWKV_TOL["params"])
            for got, ref in ((state["m"].data.numpy(), m),
                             (state["v"].data.numpy(), v)):
                np.testing.assert_allclose(
                    got, ref, rtol=0,
                    atol=RWKV_TOL["moments_of_max"] * np.abs(ref).max())
            continue
        np.testing.assert_allclose(tparams, params, rtol=0, atol=ENGINE_TOL)
        np.testing.assert_allclose(state["m"].data.numpy(), m, rtol=0,
                                   atol=ENGINE_TOL)
        np.testing.assert_allclose(state["v"].data.numpy(), v, rtol=0,
                                   atol=ENGINE_TOL)
        # the moments also agree relative to their own (tiny) scale
        np.testing.assert_allclose(state["m"].data.numpy(), m, rtol=1e-3,
                                   atol=1e-8)
        np.testing.assert_allclose(state["v"].data.numpy(), v, rtol=1e-3,
                                   atol=1e-12)
    # the engine updated the model's own parameters in place
    assert {id(x) for x in tarena.tree_flatten(tree)[0]} == \
        {id(x) for x in model.parameters()}


def test_engines_reject_an_indivisible_global_batch():
    cfg = dataclasses.replace(get_config("bert_large").reduced(),
                              compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(micro_batches=3))
    tree = model.tree()
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 8, 4).batch(0).items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(tree, init(tree), batch)
