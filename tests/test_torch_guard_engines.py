"""The port's guarded engines (finite_guard=True: ga, adama and
adama_layerwise with fp32 state, adama_layerwise also with int8/rowcol)
against the reference's guarded engines, from the same params and data,
with nan, inf, zero and skip faults: per step the skip and step counters
exactly, the losses, params and fp32 moments within the engine tolerances
of tests/test_torch_engines.py and tests/test_torch_codecs.py. The
guard's own contracts inside the port are tests/test_torch_guard.py's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.core import arena as jarena
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.optim import schedule as jsched
from repro.train import faults as jfaults
from test_torch_codecs import LOSS_FLIP_TOL, LOSS_TOL, _assert_params_close
from test_torch_engines import ENGINE_TOL
from test_torch_guard import (ARCH, N_MICRO, STEPS, _data, _init_params,
                              _port_run)

torch.set_num_threads(1)

FAULT_KINDS = ("nan", "inf", "zero", "skip")
# (engine, m codec, v codec)
ENGINE_CASES = (("adama", "fp32", "fp32"), ("adama_layerwise", "fp32", "fp32"),
                ("ga", "fp32", "fp32"), ("adama_layerwise", "int8", "rowcol"))


def _fault(engine, kind):
    """Micro-batch 1 of step 1; for ga step 0, which its frozen step counter
    repeats, and its forced skip selects the step alone (ga applies the
    skip at micro-batch 0: one verdict per step)."""
    if engine != "ga":
        return f"{kind}@micro=1,step=1"
    return "skip@step=0" if kind == "skip" else f"{kind}@micro=1,step=0"


def _reference_run(engine, m_codec, v_codec, fault):
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, finite_guard=True,
                             state_codec=v_codec, m_codec=m_codec)
    sched = (jsched.warmup_cosine(1e-3, 1, STEPS + 1) if engine == "ga"
             else None)
    step, init = jax_make_train_step(tiny(ARCH), opt, lr_schedule=sched,
                                     fault=jfaults.parse_fault(fault))
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _init_params())
    state = init(params)
    layout = state["m"].layout
    fp32 = m_codec == v_codec == "fp32"
    out = []
    for batch in _data():
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(dict(
            metrics={k: float(v) for k, v in mx.items()},
            step=int(state["step"]),
            params=np.asarray(jarena.pack(params, layout)),
            state=([np.asarray(state["m"].data), np.asarray(state["v"].data)]
                   if fp32 else None)))
    return out


@pytest.mark.parametrize("kind", FAULT_KINDS)
@pytest.mark.parametrize("engine,m_codec,v_codec", ENGINE_CASES)
def test_guarded_engine_matches_reference(engine, m_codec, v_codec, kind):
    """Each step: equal skip counters, consecutive skips, loss scale and
    step counter; losses, params (and fp32 m and v) within the engine
    tolerances (int8/rowcol: the code flips of _assert_params_close, whose
    int8 m also folds in another contraction at the reference's traced
    scale, ROADMAP queue 3 (k))."""
    fault = _fault(engine, kind)
    want = _reference_run(engine, m_codec, v_codec, fault)
    got = _port_run(engine, m_codec, v_codec, fault)
    fp32 = m_codec == v_codec == "fp32"
    for k, (a, b) in enumerate(zip(got, want)):
        label = f"{fault} step {k + 1}"
        for name in ("skipped_micro_batches", "consec_skips", "loss_scale"):
            assert a["metrics"][name] == b["metrics"][name], (label, name)
        assert a["step"] == b["step"], label
        np.testing.assert_allclose(
            a["metrics"]["loss"], b["metrics"]["loss"], rtol=0,
            atol=LOSS_FLIP_TOL if not fp32 and k else LOSS_TOL)
        if fp32:
            np.testing.assert_allclose(a["params"], b["params"], rtol=0,
                                       atol=ENGINE_TOL, err_msg=label)
            for x, y in zip(a["state"], b["state"]):
                np.testing.assert_allclose(x, y, rtol=0, atol=ENGINE_TOL,
                                           err_msg=label)
        else:
            _assert_params_close(a["params"], b["params"], m_codec, v_codec,
                                 label)
    skipped = 0 if kind == "zero" else (STEPS if engine == "ga" else 1)
    assert got[-1]["metrics"]["skipped_micro_batches"] == skipped
