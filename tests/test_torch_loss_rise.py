"""Why stablelm-1.6b's loss rises after step 1 at a constant lr of 1e-3 on
the card (11.94 -> 15.41 -> 17.80 at full width, chip_smoke.py): the
reference's own engine rises the same way at d_model 2048, so the rise
belongs to the configuration, not to the port.

Adam's first update moves every element by about lr (m/sqrt(v) = g/|g|),
and a projection that reads the residual stream sums d_model such moves
coherently, so the rise grows with d_model (as rwkv6's spike does,
tests/test_torch_rwkv6.py). The model here keeps stablelm's d_model
(2048), its norm, rope and gated MLP, and cuts what does not read the
residual stream's width, for the CPU's time: 2 layers, 2 heads of 64
(from 32), d_ff 256 (from 5632), vocab 512. Full width at 2 layers (105 M
params) takes minutes on one CPU; there the reference goes 6.5665 ->
12.6589 -> 9.5037 at lr 1e-3 and 6.5665 -> 6.8333 -> 6.2398 at 1e-4, and
the port agrees to 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import get_config as jax_get_config
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.models import model as jmodel
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.models import model as tmodel

torch.set_num_threads(1)

SHAPE = dict(num_layers=2, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
             vocab_size=512, compute_dtype="float32")
STEPS = 3
# the port's losses against the reference's (float32 model roundings;
# measured 3.2e-6 relative at lr 1e-3's step 3)
LOSS_REL_TOL = 1e-5
# "rises": some later step's loss above step 1's by this factor (measured
# at lr 1e-3: 7.8995 at step 3 against 6.6096; at 1e-4 the largest later
# loss is 6.6638, and step 3 falls to 6.0697)
RISE = 1.1


@pytest.mark.parametrize("lr, rises", [(1e-3, True), (1e-4, False)])
def test_stablelm_loss_rise_at_width_2048_is_the_references(lr, rises):
    """Three adama steps (2 micro-batches) from the same params and data:
    the reference rises at lr 1e-3 and not at 1e-4, and the port's losses
    equal the reference's to LOSS_REL_TOL."""
    jcfg = dataclasses.replace(jax_get_config("stablelm_1_6b"), **SHAPE)
    tcfg = dataclasses.replace(get_config("stablelm_1_6b"), **SHAPE)
    assert tcfg.d_model == jcfg.d_model == 2048
    data = make_data(tcfg, 32, 4, seed=5)
    batches = [data.batch(i) for i in range(STEPS)]
    step, init = jax_make_train_step(jcfg, JaxOptimizerConfig(
        name="adama", accumulation="adama", micro_batches=2,
        use_pallas=True, arena=True, lr=lr))
    step = jax.jit(step)
    params = jmodel.init_params(jcfg, jax.random.key(0))
    tree = tmodel.Model(tcfg, tmodel.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu")).tree()
    state, want = init(params), []
    for b in batches:
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(metrics["loss"]))
    del params, state
    step, init = make_train_step(tcfg, OptimizerConfig(
        accumulation="adama", micro_batches=2, lr=lr))
    state, got = init(tree), []
    for b in batches:
        tree, state, metrics = step(
            tree, state, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL_TOL, atol=0)
    for losses in (want, got):
        assert (max(losses[1:]) > RISE * losses[0]) == rises, losses
