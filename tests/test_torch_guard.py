"""The port's fused finite guard and traced fold scale against the
reference's, on the CPU:

  - kernel level: the guarded plain versions of arena_fold,
    arena_fold_slice and arena_apply against the Pallas kernels with
    guard= and a traced scale (interpret mode), every (m, v) pair, ok true
    and false, bit for bit (rowcol's sums to RC_REL_TOL, the apply after
    them to RC_APPLY_TOL, as tests/test_torch_codecs.py holds them); the
    finite flag's plain version on fp32 and bf16 edge cases;
  - (the engines against the reference's guarded engines are
    tests/test_torch_guard_engines.py's);
  - inside the port, bit for bit, the contracts of tests/test_resilience.py:
    a caught NaN equals a forced skip, a clean guarded run equals the
    unguarded one, ga's whole-step guard, an all-skipped mini-batch is the
    identity, a finite corruption does not trip the guard, Inf is caught;
  - the scaler's transitions, the fault grammar, the config checks and the
    loop's abort against the reference's.

The CUDA forms are held against these plain versions on the card by
chip_smoke.py.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs.base import parse_loss_scale as jax_parse_loss_scale
from repro.core import state_store as jss
from repro.kernels import fused_step as jfs
from repro.models import model as jmodel
from repro.train import faults as jfaults
from repro.train import scaler as jscaler
from repro_torch.configs.base import (OptimizerConfig, RunConfig, get_config,
                                      parse_loss_scale)
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import build
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched
from repro_torch.train import faults as tfaults
from repro_torch.train import scaler as tscaler
from repro_torch.train.loop import train
from test_torch_codecs import (B1, B2, LR, PAIRS, _assert_apply_matches,
                               _assert_bitwise, _assert_state_matches,
                               _pair_arenas, _t)

torch.set_num_threads(1)

# a traced scale that is not a power of two: f32(1/8) / f32(3)
TRACED_SCALE = np.float32(np.float32(0.125) / np.float32(3.0))
# int8 m at a traced scale (ROADMAP queue 3 (k)): the reference's XLA CPU
# contracts the fold as fma(d, q*s, c*x) once the scale is a runtime value,
# where its static-scale fold (and the port's every form, so that guarded
# equals unguarded bit for bit) is fma(c, x, d*(q*s)). Each rounds m within
# one row-scale step of the exact value (int8 m's declared per-fold bound),
# so the two decodes lie within two steps of each other. Measured on the
# 64-row edge arenas, seeds 0-5, two folds: codes off by at most 1, decoded
# m within 1.62 steps (edge rows whose scale sits near the subnormal floor),
# 1.0 elsewhere.
INT8_M_TRACED_STEPS = 2.0


# ---------------------------------------------------------------------------
# Kernel level: the guarded plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _guard_vec(decay, ok, scale=TRACED_SCALE):
    return tfs.guard_scalars(decay, ok, scale, device="cpu")


def _jax_guard(decay, ok, scale=TRACED_SCALE):
    dm, dv = (1.0, 1.0) if decay is None else decay
    return dict(scale=jnp.asarray(scale, jnp.float32),
                decay=(jnp.float32(dm), jnp.float32(dv)),
                guard=jnp.asarray(ok))


def _snapshot(*states):
    return [x.clone() for st in states for x in tfs._as_parts(st)[0]]


def _assert_guarded_matches(m_codec, v_codec, tm, jm, tv, jv, label):
    """As _assert_state_matches, int8 m within INT8_M_TRACED_STEPS of the
    reference's row scale."""
    if m_codec == "int8":
        (q, s), (jq, js) = ((np.asarray(x, np.float64) for x in pair)
                            for pair in (tm, jm))
        gap = np.abs(q * s - jq * js) / np.maximum(np.maximum(s, js), 1e-45)
        assert gap.max() <= INT8_M_TRACED_STEPS, (label, gap.max())
        tm = tuple(np.asarray(x) for x in jm)
    _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv, label)


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_guarded_fold_plain_version_vs_reference(m_codec, v_codec, ok):
    """A first fold (decay fused) and a later fold, both at the traced
    scale, through the guard vector: with ok every column as the
    reference's (int8 m to INT8_M_TRACED_STEPS); without, every byte
    (rowcol's column sums included) as before, in both."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=8)
    g[7, 3] = np.nan if not ok else g[7, 3]   # the flag rides in the vector
    before = _snapshot(tm, tv)
    for grad, decay in ((g, (B1, B2)), (np.flip(g, 0).copy(), None)):
        jm, jv, flag = jfs.arena_fold(jm, jv, jnp.asarray(grad), beta1=B1,
                                      beta2=B2, m_codec=m_codec,
                                      v_codec=v_codec, **_jax_guard(decay, ok))
        assert bool(flag) == ok
        out = tfs.arena_fold(tm, tv, _t(grad), beta1=B1, beta2=B2,
                             m_codec=m_codec, v_codec=v_codec,
                             guard=_guard_vec(decay, ok))
        assert out[0] is tm and out[1] is tv
        _assert_guarded_matches(m_codec, v_codec, tm, jm, tv, jv,
                                f"ok={ok} decay={decay}")
    if not ok:
        _assert_bitwise(tuple(_snapshot(tm, tv)), before, "ok=False")


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_guarded_slice_fold_plain_version_vs_reference(m_codec, v_codec, ok):
    """Rows [16, 48) (block 16) with the decay at the traced scale; rows
    outside keep their bits, and with ok false every row does."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=9)
    before = _snapshot(tm, tv)
    slab = g[8:40]
    jm, jv, _ = jfs.arena_fold_slice(jm, jv, jnp.asarray(slab), 16,
                                     beta1=B1, beta2=B2, block=16,
                                     m_codec=m_codec, v_codec=v_codec,
                                     **_jax_guard((B1, B2), ok))
    tfs.arena_fold_slice(tm, tv, _t(slab), 16, beta1=B1, beta2=B2, block=16,
                         m_codec=m_codec, v_codec=v_codec,
                         guard=_guard_vec((B1, B2), ok))
    _assert_guarded_matches(m_codec, v_codec, tm, jm, tv, jv, f"ok={ok}")
    if not ok:
        _assert_bitwise(tuple(_snapshot(tm, tv)), before, "ok=False")


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_guarded_apply_plain_version_vs_reference(m_codec, v_codec, ok):
    """The guarded apply after a fold: with ok the reference's update; with
    ok false p keeps every byte, at bc1 = 0 too (the NaNs of a step
    counter that never advanced are discarded)."""
    jm, tm, jv, tv, g, p = _pair_arenas(m_codec, v_codec, seed=4)
    jm, jv = jfs.arena_fold(jm, jv, jnp.asarray(g), beta1=B1, beta2=B2,
                            decay=(B1, B2), m_codec=m_codec, v_codec=v_codec)
    tfs.arena_fold(tm, tv, _t(g), beta1=B1, beta2=B2, decay=(B1, B2),
                   m_codec=m_codec, v_codec=v_codec)
    for bc1 in ((np.float32(1) - np.float32(B1), np.float32(0))
                if not ok else (np.float32(1) - np.float32(B1),)):
        kw = dict(lr=np.float32(LR), bc1=bc1,
                  bc2=np.float32(1) - np.float32(B2), eps=1e-8,
                  weight_decay=0.01, m_codec=m_codec, v_codec=v_codec)
        jp = jfs.arena_apply(jnp.asarray(p), jm, jv, guard=jnp.asarray(ok),
                             **kw)
        tp = _t(p)
        assert tfs.arena_apply(tp, tm, tv, guard=torch.tensor(
            [1.0 if ok else 0.0]), **kw) is tp
        if ok:
            _assert_apply_matches(v_codec, tp, jp, p, "p")
        else:
            _assert_bitwise(tp, np.asarray(jp), f"p bc1={bc1}")
            _assert_bitwise(tp, p, f"p bc1={bc1}")


@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_guarded_form_at_a_static_scale_is_the_unguarded_form(m_codec,
                                                              v_codec):
    """ok = 1 at scale f32(1/8) with the decay: the guarded plain versions
    equal the unguarded ones bit for bit (fold, slice fold, apply)."""
    _, tm, _, tv, g, p = _pair_arenas(m_codec, v_codec, seed=2)
    um, uv = tfs._as_parts(tm)[0], tfs._as_parts(tv)[0]
    um = tuple(x.clone() for x in um)
    uv = tuple(x.clone() for x in uv)
    codecs = dict(m_codec=m_codec, v_codec=v_codec)
    gt = _t(g)
    tfs.arena_fold(tm, tv, gt, beta1=B1, beta2=B2, **codecs,
                   guard=_guard_vec((B1, B2), True, 0.125))
    tfs.arena_fold(um, uv, gt, beta1=B1, beta2=B2, scale=0.125,
                   decay=(B1, B2), **codecs)
    tfs.arena_fold_slice(tm, tv, gt[:32], 32, beta1=B1, beta2=B2, block=16,
                         **codecs, guard=_guard_vec(None, True, 0.125))
    tfs.arena_fold_slice(um, uv, gt[:32], 32, beta1=B1, beta2=B2, block=16,
                         scale=0.125, **codecs)
    _assert_bitwise(tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0], um + uv,
                    "state")
    kw = dict(lr=LR, bc1=0.1, bc2=0.001, eps=1e-8, **codecs)
    pg, pu = _t(p), _t(p)
    tfs.arena_apply(pg, tm, tv, guard=torch.ones(1), **kw)
    tfs.arena_apply(pu, um, uv, **kw)
    _assert_bitwise(pg, pu, "p")


def test_guard_arguments_are_checked():
    _, tm, _, tv, g, p = _pair_arenas("fp32", "fp32")
    kw = dict(beta1=B1, beta2=B2)
    with pytest.raises(ValueError, match="ride in the guard vector"):
        tfs.arena_fold(tm, tv, _t(g), scale=0.5, guard=_guard_vec(None, 1),
                       **kw)
    with pytest.raises(ValueError, match=r"\(4,\) float32"):
        tfs.arena_fold(tm, tv, _t(g), guard=torch.ones(3), **kw)
    with pytest.raises(ValueError, match=r"\(1,\) float32"):
        tfs.arena_apply(_t(p), tm, tv, lr=LR, bc1=0.1, bc2=0.001,
                        guard=torch.ones(4))
    with pytest.raises(TypeError, match="float32 tensor"):
        tfs.arena_apply(_t(p), tm, tv, lr=LR, bc1=0.1, bc2=0.001,
                        guard=True)


def test_guard_scalars_match_the_reference():
    for decay, ok, scale in (((B1, B2), True, 1.0), (None, False, 0.25),
                             ((0.5, 0.999), True, 1.0 / 3)):
        want = np.asarray(jfs._guard_scalars(decay, ok, scale))
        got = tfs.guard_scalars(decay, ok, scale, device="cpu").numpy()
        _assert_bitwise(got, want, str((decay, ok, scale)))


def _edge_values(dtype):
    """The finite flag's edge cases: one NaN, +Inf and -Inf at the first
    and at the last element, and a finite row of subnormals (and of the
    largest finite values)."""
    n = 1031                      # not a multiple of 16 bytes' elements
    base = torch.linspace(-3, 3, n, dtype=torch.float32).to(dtype)
    cases = {}
    for bad in (float("nan"), float("inf"), float("-inf")):
        for at in (0, n - 1):
            x = base.clone()
            x[at] = bad
            cases[f"{bad} at {at}"] = (x, False)
    tiny = torch.finfo(dtype).tiny
    cases["subnormals"] = (torch.full((n,), tiny / 4, dtype=dtype), True)
    cases["largest finite"] = (torch.full((n,), torch.finfo(dtype).max,
                                          dtype=dtype), True)
    cases["finite"] = (base, True)
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finite_and_plain_version_on_edge_cases(dtype):
    """ok <- ok AND all finite, in place; a cleared ok stays cleared; the
    views at every 16-byte offset split into (head, body, tail) that cover
    the tensor."""
    for label, (x, want) in _edge_values(dtype).items():
        ok = torch.ones(1)
        assert tfs.finite_and(x, ok) is ok
        assert ok.item() == float(want), label
        for start in (1, 3):
            view = x[start:]
            ok = torch.ones(1)
            tfs.finite_and(view, ok)
            assert ok.item() == float(bool(torch.isfinite(view).all())), (
                label, start)
            head, n16, tail = tfs._finite_split(view)
            assert head + n16 * 16 // view.element_size() + tail == \
                view.numel()
            assert head * view.element_size() < 16
        zero = torch.zeros(1)
        tfs.finite_and(x, zero)
        assert zero.item() == 0.0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfs.finite_and(torch.ones(4, dtype=torch.float16), torch.ones(1))
    with pytest.raises(ValueError, match="contiguous"):
        tfs.finite_and(torch.ones(4, 4).t(), torch.ones(1))
    with pytest.raises(ValueError, match="one float32 element"):
        tfs.finite_and(torch.ones(4), torch.ones(2))


def test_guarded_launch_arguments_match_the_declared_c_signatures():
    """The guarded launchers take the unguarded ones' arguments and then
    the guard's pointer; finite_and's takes x, its element bytes, the
    split and ok."""
    import ctypes
    mk, vk = tfs.kernel_codec("m", "int8"), tfs.kernel_codec("v", "rowcol")
    x = torch.zeros(8, tfs.LANES)
    m = (torch.zeros(8, tfs.LANES, dtype=torch.int8), torch.zeros(8, 1))
    v = (torch.zeros(8, 1), torch.zeros(1, tfs.LANES))
    vec = _guard_vec(None, True)
    scratch = tfs.fold_scratch(vk, 8, x.device)
    cases = {"arena_fold_guarded_launch": tfs.fold_args(
                 mk, vk, m, v, x, 0, B1, B2, 1.0, None, scratch),
             "arena_apply_guarded_launch": tfs.apply_args(
                 mk, vk, x, m, v, 1e-3, 0.1, 0.001, 1e-8, 0.0)}
    for name, args in cases.items():
        got = []
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *tfs.SIGNATURES[name])
        assert proto(lambda *a: got.append(a) or 0)(*args, vec.data_ptr(),
                                                    0) == 0
        assert got[0][-2] == vec.data_ptr()
        assert got[0][:2] == (1, 3)
    y = torch.zeros(37, dtype=torch.bfloat16)[1:]
    got = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int,
                             *tfs.SIGNATURES["finite_and_launch"])
    ok = torch.ones(1)
    proto(lambda *a: got.append(a) or 0)(
        y.data_ptr(), 2, *tfs._finite_split(y), ok.data_ptr(), 0)
    assert got[0][:2] == (y.data_ptr(), 2)
    assert got[0][5] == ok.data_ptr()


def test_cpu_guarded_forms_count_no_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("the CUDA library was loaded for CPU tensors")
    monkeypatch.setattr(build, "load", no_build)
    before = (tfs.arena_fold.launches, tfs.arena_apply.launches,
              tfs.finite_and.launches)
    _, tm, _, tv, g, p = _pair_arenas("int8", "rowcol")
    vec = _guard_vec((B1, B2), True)
    tfs.finite_and(_t(g), vec[2:3])
    tfs.arena_fold(tm, tv, _t(g), beta1=B1, beta2=B2, m_codec="int8",
                   v_codec="rowcol", guard=vec)
    tfs.arena_apply(_t(p), tm, tv, lr=LR, bc1=0.1, bc2=0.001,
                    m_codec="int8", v_codec="rowcol", guard=vec[2:3])
    assert (tfs.arena_fold.launches, tfs.arena_apply.launches,
            tfs.finite_and.launches) == before


# ---------------------------------------------------------------------------
# The state store: the guard's host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ok", [True, False])
def test_rowcol_guarded_begin_micro_is_where_selected(ok):
    """The shared column sums' decay, where-selected on the flag: with ok
    false every byte stays (a subnormal and a NaN payload included), with
    ok true it is the reference's decay."""
    rng = np.random.default_rng(3)
    vr = np.abs(rng.standard_normal((64, 1))).astype(np.float32)
    vc = np.abs(rng.standard_normal((1, tfs.LANES))).astype(np.float32)
    vc[0, 3] = np.float32(2e-39)          # subnormal: the flush would zero it
    parts = (_t(vr), _t(vc))
    before = [x.clone() for x in parts]
    codec = tss.get_codec("rowcol")
    tss._guarded_begin_micro(codec, parts, torch.tensor(1.0),
                             torch.tensor(ok))
    want = jss._guarded_begin_micro(jss.get_codec("rowcol"),
                                    (jnp.asarray(vr), jnp.asarray(vc)),
                                    jnp.float32(1.0), jnp.asarray(ok))
    _assert_bitwise(parts, want, f"ok={ok}")
    if not ok:
        _assert_bitwise(parts, before, "unchanged")
    else:
        assert parts[1][0, 3] == 0.0             # x * 1.0 flushed, as XLA


def test_state_store_guard_true_self_checks_the_slab():
    """guard=True: the slab's own finite flag (`_resolve_guard`); a NaN
    slab folds nothing, the rowcol column sums' decay included."""
    _, tm, _, tv, g, _ = _pair_arenas("int8", "rowcol")
    before = _snapshot(tm, tv)
    g[3, 5] = np.inf
    m, v, vec = tss.fold("int8", "rowcol", tm, tv, _t(g), beta1=B1,
                         beta2=B2, decay=(B1, B2), guard=True)
    assert vec[2].item() == 0.0
    _assert_bitwise(tuple(_snapshot(tm, tv)), before, "inf slab")
    g[3, 5] = 0.0
    _, _, vec = tss.fold("int8", "rowcol", tm, tv, _t(g), beta1=B1, beta2=B2,
                         decay=(B1, B2), guard=True)
    assert vec[2].item() == 1.0
    assert not np.array_equal(tv[1].numpy(), before[-1].numpy())
    with pytest.raises(ValueError, match="carries the scale"):
        tss.fold("int8", "rowcol", tm, tv, _t(g), beta1=B1, beta2=B2,
                 decay=(B1, B2), guard=vec)


# ---------------------------------------------------------------------------
# Engine runs (the reference's engine parity: tests/test_torch_guard_engines.py)
# ---------------------------------------------------------------------------

ARCH, N_MICRO, GLOBAL_BATCH, SEQ, STEPS = "stablelm_1_6b", 2, 4, 16, 2


def _data():
    cfg = get_config(ARCH).reduced()
    data = make_data(cfg, SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _init_params():
    return jax.tree.map(np.asarray,
                        jmodel.init_params(tiny(ARCH), jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _port_run(engine, m_codec, v_codec, fault, guarded=True, steps=STEPS):
    """The port's run from the reference's params: per step its metrics,
    step counter, packed params and state columns. ga runs the reference's
    warmup schedule (tests/test_torch_engines.py: its first step is
    ill-conditioned across frameworks)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          state_codec=v_codec, m_codec=m_codec,
                          finite_guard=guarded)
    sched = (tsched.warmup_cosine(1e-3, 1, STEPS + 1) if engine == "ga"
             else None)
    tree = tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                    "cpu")).tree()
    step, init = make_train_step(cfg, opt, lr_schedule=sched,
                                 fault=tfaults.parse_fault(fault))
    state = init(tree)
    out = []
    for batch in _data()[:steps]:
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            out.append(dict(
                metrics={k: float(v) for k, v in mx.items()},
                step=state["step"],
                params=tarena.pack(tree, state["m"].layout).numpy().copy(),
                state=[x.numpy().copy() for mo in ("m", "v")
                       for x in tss.codec_of(state[mo], mo).parts_of(
                           state[mo])]))
    return out


# ---------------------------------------------------------------------------
# Inside the port, bit for bit (tests/test_resilience.py's contracts)
# ---------------------------------------------------------------------------


def _same(a, b):
    return np.array_equal(a["params"].view(np.uint8),
                          b["params"].view(np.uint8)) and all(
        np.array_equal(x.view(np.uint8), y.view(np.uint8))
        for x, y in zip(a["state"], b["state"]))


@pytest.mark.parametrize("engine,m_codec,v_codec", [
    ("adama", "fp32", "fp32"), ("adama_layerwise", "fp32", "fp32"),
    ("adama_layerwise", "int8", "rowcol")])
def test_caught_nan_equals_forced_skip_bitwise(engine, m_codec, v_codec):
    """A NaN at micro-batch 1 of step 0 leaves params, m and v bit for bit
    as a forced skip there; the step counts both steps; and the skip took a
    micro-batch's contribution away."""
    n = _port_run(engine, m_codec, v_codec, "nan@micro=1,step=0")[-1]
    s = _port_run(engine, m_codec, v_codec, "skip@micro=1,step=0")[-1]
    c = _port_run(engine, m_codec, v_codec, None)[-1]
    assert _same(n, s)
    assert n["step"] == STEPS == s["step"]
    assert n["metrics"]["skipped_micro_batches"] == 1 == \
        s["metrics"]["skipped_micro_batches"]
    assert not _same(n, c)


@pytest.mark.parametrize("engine,m_codec,v_codec", [
    ("adama", "fp32", "fp32"), ("adama_layerwise", "fp32", "fp32"),
    ("ga", "fp32", "fp32"), ("adama", "int8", "rowcol"),
    ("adama_layerwise", "int8", "rowcol")])
def test_guarded_clean_run_is_bitwise_unguarded(engine, m_codec, v_codec):
    """finite_guard with no fault equals the port's unguarded engine bit
    for bit, every step (ga too: against the port's own unguarded ga; the
    reference's guarded ga is not bitwise its unguarded one, ROADMAP queue
    3 (c))."""
    g = _port_run(engine, m_codec, v_codec, None)
    u = _port_run(engine, m_codec, v_codec, None, guarded=False)
    for a, b in zip(g, u):
        assert _same(a, b)
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["metrics"]["loss"],
                                   b["metrics"]["loss"], rtol=1e-7)
    assert g[-1]["metrics"]["skipped_micro_batches"] == 0


def test_ga_whole_step_guard():
    """ga's guard is one verdict over the accumulated gradient: a NaN in
    micro-batch 1 of step 0 equals a forced skip of step 0, the step
    counter does not advance (so the fault fires again), and the params
    stay the initial ones."""
    n = _port_run("ga", "fp32", "fp32", "nan@micro=1,step=0")
    s = _port_run("ga", "fp32", "fp32", "skip@step=0")
    assert _same(n[-1], s[-1])
    assert n[-1]["step"] == 0
    assert n[-1]["metrics"]["skipped_micro_batches"] == 2
    tree = tmodel.params_from_jax(_init_params(), "cpu")
    p0 = tarena.pack(tree, tarena.build_layout(tree)).numpy()
    assert np.array_equal(n[-1]["params"].view(np.uint8), p0.view(np.uint8))


@pytest.mark.parametrize("engine", ["adama", "adama_layerwise"])
def test_all_micro_batches_skipped_is_identity(engine):
    """Every micro-batch non-finite: params, m and v keep every byte (m
    and v still zero), the step does not advance, and the counters count
    every micro-batch."""
    out = _port_run(engine, "fp32", "fp32", "nan", steps=1)[-1]
    tree = tmodel.params_from_jax(_init_params(), "cpu")
    p0 = tarena.pack(tree, tarena.build_layout(tree)).numpy()
    assert np.array_equal(out["params"].view(np.uint8), p0.view(np.uint8))
    assert all(not x.any() for x in out["state"])
    assert out["step"] == 0
    assert out["metrics"]["skipped_micro_batches"] == N_MICRO
    assert out["metrics"]["consec_skips"] == N_MICRO
    assert out["metrics"]["loss"] == 0.0


def test_finite_corruption_does_not_trip_guard():
    """A zeroed gradient leaf is finite: no skip, another trajectory."""
    z = _port_run("adama", "fp32", "fp32", "zero@micro=0,step=0")[-1]
    c = _port_run("adama", "fp32", "fp32", None)[-1]
    assert z["metrics"]["skipped_micro_batches"] == 0
    assert not _same(z, c)


def test_nonfinite_inf_also_caught():
    i = _port_run("adama", "fp32", "fp32", "inf@micro=0,step=0")[-1]
    s = _port_run("adama", "fp32", "fp32", "skip@micro=0,step=0")[-1]
    assert _same(i, s)
    assert i["metrics"]["skipped_micro_batches"] == 1


def test_guarded_engine_reads_no_device_value_inside_the_micro_batch_loop(
        monkeypatch):
    """The guarded engines read the device back once per mini-batch (the
    metrics' one `tolist`), never a flag inside the micro-batch loop: no
    `item`, `bool` or `tolist` on a tensor before the apply."""
    calls = []
    real_apply = tfs.arena_apply

    def apply(*a, **kw):
        calls.append("apply")
        return real_apply(*a, **kw)
    for name in ("item", "tolist", "__bool__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    monkeypatch.setattr(tfs, "arena_apply", apply)
    for engine in ("adama", "adama_layerwise", "ga"):
        calls.clear()
        cfg = dataclasses.replace(get_config(ARCH).reduced(),
                                  compute_dtype="float32")
        opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                              finite_guard=True)
        tree = tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                        "cpu")).tree()
        step, init = make_train_step(cfg, opt, fault=tfaults.parse_fault(
            "nan@micro=1"))
        state = init(tree)
        batch = {k: torch.from_numpy(v) for k, v in _data()[0].items()}
        step(tree, state, batch)
        assert calls == ["apply", "tolist"], (engine, calls)


# ---------------------------------------------------------------------------
# Scaler, faults, config, loop
# ---------------------------------------------------------------------------


def _sc(scale, growth=0, skipped=0, consec=0):
    return ({"scale": torch.tensor(scale, dtype=torch.float32),
             "growth": torch.tensor(growth, dtype=torch.int32),
             "skipped": torch.tensor(skipped, dtype=torch.int32),
             "consec": torch.tensor(consec, dtype=torch.int32)},
            {"scale": jnp.float32(scale), "growth": jnp.int32(growth),
             "skipped": jnp.int32(skipped), "consec": jnp.int32(consec)})


@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("start,interval", [(4.0, 2), (2.0 ** 15, 3),
                                            (tscaler.SCALE_MAX, 1)])
def test_scaler_transitions_match_the_reference(dynamic, start, interval):
    """The same verdicts through both scalers: every field equal after
    every transition (growth, cap, backoff, floor, counters)."""
    t, j = _sc(start)
    pattern = [True, True, False, False, False, True, True, True, False,
               True] * 3
    for ok in pattern:
        t = tscaler.scaler_update(t, torch.tensor(ok), dynamic=dynamic,
                                  growth_interval=interval)
        j = jscaler.scaler_update(j, jnp.asarray(ok), dynamic=dynamic,
                                  growth_interval=interval)
        for k in t:
            assert t[k].dtype == {"scale": torch.float32}.get(k, torch.int32)
            assert t[k].item() == float(j[k]), (k, ok)


def test_scaler_init_and_metrics_match_the_reference():
    for guard, ls in ((True, "off"), (True, "dynamic"), (True, "512"),
                      (False, "off")):
        opt = types.SimpleNamespace(finite_guard=guard, loss_scale=ls)
        t, j = tscaler.init_scaler(opt), jscaler.init_scaler(opt)
        assert (t is None) == (j is None)
        if t is None:
            continue
        assert {k: x.item() for k, x in t.items()} == \
            {k: float(x) for k, x in j.items()}
        assert tscaler.is_dynamic(opt) == jscaler.is_dynamic(opt)
        tm = tscaler.scaler_metrics({"scaler": t}, "x_")
        jm = jscaler.scaler_metrics({"scaler": j}, "x_")
        assert {k: x.item() for k, x in tm.items()} == \
            {k: float(x) for k, x in jm.items()}
    assert tscaler.scaler_metrics({"m": None}) == {}
    sc = _sc(4.0)[0]
    assert tscaler.scale_into_fold(0.5, sc).item() == np.float32(0.125)
    assert tscaler.scale_into_fold(0.5, None) == 0.5
    assert tscaler.scale_loss(torch.tensor(3.0), sc).item() == 12.0


@pytest.mark.parametrize("spec", [
    None, "", "nan", "nan@micro=1", "inf@micro=2,step=0", "zero@micro=1",
    "skip@micro=1,step=3", "crash@step=3", "nan@micro=0,device=3",
    " skip @ micro=1 , step=-1"])
def test_parse_fault_matches_the_reference(spec):
    t, j = tfaults.parse_fault(spec), jfaults.parse_fault(spec)
    if j is None:
        assert t is None
    else:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("spec", ["boom@micro=1", "nan@micro=x",
                                  "nan@batch=1", "nan@micro=1,"])
def test_parse_fault_errors_match_the_reference(spec):
    with pytest.raises(ValueError) as j:
        jfaults.parse_fault(spec)
    with pytest.raises(ValueError) as t:
        tfaults.parse_fault(spec)
    assert str(t.value) == str(j.value)


def test_fault_helpers_match_the_reference():
    """corrupt_tree poisons element [0, ..., 0] of the first leaf in the
    reference's flatten order; corrupt_loss, apply_skip and crash_due
    select as the reference's; a device selector raises."""
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.standard_normal((2, 3)).astype(np.float32)},
            "a": rng.standard_normal((4,)).astype(np.float32)}
    for spec in ("nan@micro=1,step=2", "inf@micro=1", "zero@step=2"):
        f_t, f_j = tfaults.parse_fault(spec), jfaults.parse_fault(spec)
        for micro, step in ((1, 2), (0, 2), (1, 0)):
            got = {"b": {"w": _t(tree["b"]["w"])}, "a": _t(tree["a"])}
            tfaults.corrupt_tree(f_t, got, micro=micro, step=step)
            want = jfaults.corrupt_tree(f_j, jax.tree.map(jnp.asarray, tree),
                                        micro=micro, step=step)
            for x, y in zip(tarena.tree_flatten(got)[0],
                            jax.tree.leaves(want)):
                _assert_bitwise(x, np.asarray(y), f"{spec} {micro} {step}")
            seed = torch.tensor(0.5)
            lt = tfaults.corrupt_loss(f_t, seed, micro=micro, step=step)
            lj = jfaults.corrupt_loss(f_j, jnp.float32(0.5), micro=micro,
                                      step=step)
            _assert_bitwise(lt, np.asarray(lj), f"loss {spec}")
    for spec in ("skip@micro=1,step=2", "skip", "nan@micro=1"):
        f_t, f_j = tfaults.parse_fault(spec), jfaults.parse_fault(spec)
        for micro, step in ((1, 2), (0, 2), (1, 0)):
            assert tfaults.apply_skip(f_t, True, micro=micro, step=step) == \
                bool(jfaults.apply_skip(f_j, jnp.asarray(True), micro=micro,
                                        step=step))
    for spec, step in (("crash@step=3", 3), ("crash@step=3", 2),
                       ("crash", 0), ("nan", 0), (None, 0)):
        assert tfaults.crash_due(tfaults.parse_fault(spec), step) == \
            jfaults.crash_due(jfaults.parse_fault(spec), step)
    with pytest.raises(ValueError, match="selects a device"):
        tfaults.corrupt_tree(tfaults.parse_fault("nan@device=1"),
                             {"a": torch.ones(2)}, micro=0, step=0)
    with pytest.raises(ValueError, match="device-selective"):
        tfaults.apply_skip(tfaults.parse_fault("skip@device=1"), True,
                           micro=0, step=0)


def _jax_config_error(**kw):
    with pytest.raises(ValueError) as e:
        JaxOptimizerConfig(name="adama", use_pallas=True, **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(finite_guard=True, arena=False, accumulation="adama"),
    dict(finite_guard=True, arena=True, loss_scale="dynamic"),
    dict(finite_guard=True, arena=True, loss_scale="1024",
         accumulation="ga"),
    dict(arena=True, loss_scale="banana"),
    dict(arena=True, loss_scale="-2"),
    dict(arena=True, finite_guard=True, scaler_growth_interval=0),
    dict(arena=True, finite_guard=True, scaler_abort_after=-1),
    # the bf16 wire: loss scaling without the guard, the wire without the
    # arena or with ga, an unknown wire
    dict(arena=True, grad_dtype="bf16", loss_scale="dynamic"),
    dict(arena=True, grad_dtype="bf16", loss_scale="1024",
         accumulation="adama_layerwise"),
    dict(arena=False, grad_dtype="bf16", finite_guard=True,
         loss_scale="dynamic"),
    dict(arena=True, grad_dtype="bf16", finite_guard=True,
         loss_scale="dynamic", accumulation="ga"),
    dict(arena=True, grad_dtype="fp16", finite_guard=True),
    # master params without the arena (checked before the guard's
    # refusal), the working-param cache without master params
    dict(arena=False, master_params=True, finite_guard=True),
    dict(arena=True, work_param_cache=True, finite_guard=True)])
def test_guard_config_checks_match_the_reference(kw):
    """Each refusal raises the reference's message: a loss scale on the
    fp32 wire or without the guard, the guard without the arena, the bf16
    wire without the arena or with ga, master params without the arena,
    the cache without master params (tests/test_torch_wire.py and
    tests/test_torch_master.py walk the whole grids)."""
    with pytest.raises(ValueError) as t:
        OptimizerConfig(**kw)
    assert str(t.value) == _jax_config_error(**kw)


@pytest.mark.parametrize("value", ["off", "dynamic", "1024", "0.5", "0",
                                   "x", None])
def test_parse_loss_scale_matches_the_reference(value):
    try:
        want = jax_parse_loss_scale(value)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0][:20]):
            parse_loss_scale(value)
        return
    assert parse_loss_scale(value) == want


def _loop_run(fault, **opt_kw):
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(
        micro_batches=N_MICRO, finite_guard=True, **opt_kw), seq_len=SEQ,
        global_batch=GLOBAL_BATCH, steps=3, log_every=1, inject_fault=fault)
    logs = []
    try:
        out = train(run, params=tmodel.init_params(cfg, gen), device="cpu",
                    log_fn=logs.append)
    except Exception as e:                      # noqa: BLE001
        return logs, e
    return logs, out


def test_loop_surfaces_the_scaler_and_aborts_on_consecutive_skips():
    """The loop logs scale= and skipped=, returns the last metrics, raises
    the reference's message after scaler_abort_after consecutive skips,
    and raises InjectedCrash after a crash step's update."""
    logs, out = _loop_run("nan@micro=1,step=1")
    assert "scale=1 skipped=0" in logs[0] and "skipped=1" in logs[1]
    assert out["metrics"]["skipped_micro_batches"] == 1.0
    assert out["opt_state"]["step"] == 3
    logs, err = _loop_run("nan@step=1", scaler_abort_after=2)
    assert isinstance(err, RuntimeError) and len(logs) == 1
    assert str(err).startswith("aborting at step 2: 2 consecutive "
                               "micro-batches skipped non-finite")
    logs, err = _loop_run("nan@micro=1", scaler_abort_after=2)
    assert len(logs) == 3 and not isinstance(err, Exception)
    logs, err = _loop_run("crash@step=1")
    assert isinstance(err, tfaults.InjectedCrash) and len(logs) == 2
