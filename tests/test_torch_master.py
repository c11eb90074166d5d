"""The port's fp32 master params and bf16 working-param cache against the
reference's (tests/test_mixed_precision.py and tests/test_fp8_wire.py's
cache tests, without the fp8 wire), on the CPU:

  - the master form of the apply's plain version, every (m, v) pair,
    unguarded and guarded (ok = 1; ok = 0 at bc1 = 0), on edge arenas whose
    p holds bf16 ties of both parities, carries into the exponent, values
    that round past bf16's largest finite value, subnormals and signed
    zeros: its master and its work against the reference's
    arena_apply(work_dtype=bfloat16) (interpret mode), and against the
    port's own plain-form apply and p.to(bfloat16), bit for bit;
  - init_arena(master_params=True, work_param_cache=True)'s "p" and "wp"
    bit for bit the reference's;
  - ga, adama and adama_layerwise with master params, fp32/fp32 and
    int8/rowcol, guarded and not: the master after step 1 the port's fp32
    run's params bit for bit, the leaves exactly bf16(master), both within
    the engine tolerances of the reference's master runs, and the fp32
    run's launches;
  - the cache's contract: a cached run is an uncached master run whose
    step-1 leaves went through the bf16 pack, bit for bit, on every engine;
  - an all-skipped guarded ga step keeps the master and leaves
    bf16(initial params), as the reference does;
  - the config's checks and messages, and the CLI.

The CUDA master form is held against these plain versions on the card by
chip_smoke.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.core import adama as jadama
from repro.core import arena as jarena
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import fused_step as jfs
from repro.optim import schedule as jsched
from repro.train import faults as jfaults
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import adama as tadama
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched
from repro_torch.train import faults as tfaults
from test_torch_codecs import (B1, B2, CODE_FLIP_FRAC, LOSS_FLIP_TOL,
                               LOSS_TOL, LR, PAIRS,
                               _assert_apply_matches, _assert_bitwise,
                               _pair_arenas, _t)
from test_torch_engines import ENGINE_TOL
from test_torch_guard import (ARCH, GLOBAL_BATCH, N_MICRO, SEQ, STEPS,
                              _init_params)
from test_torch_wire import WIRE_FLIP_FRAC

torch.set_num_threads(1)

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# Kernel level: the master form's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _edge_p(flush: bool):
    """float32 values at bf16's rounding edges for the master: exact ties
    (low half 0x8000) on even and odd bf16 mantissas, one ulp either side
    of a tie, carries into the exponent, values that round past bf16's
    largest finite value (to infinity), the largest finite bf16, both
    zeros, each with both signs; with `flush`, fp32 subnormals too (the
    fp32/fp32 pair keeps IEEE subnormals where the reference flushes them:
    ROADMAP queue 3)."""
    bits = []
    for hi in (0x3F80, 0x3F81, 0x3C23, 0x3C24, 0x3FFF, 0x3C7F, 0x7F7F):
        bits += [(hi << 16) | lo for lo in (0x8000, 0x7FFF, 0x8001, 0x0000,
                                            0xFFFF)]
    bits += [0x7F7FFFFF, 0x7F7F0000, 0x00000000]
    if flush:
        bits += [0x00008000, 0x00408000, 0x00018000, 0x00000001,
                 0x007FFFFF]
    bits = np.array(bits, dtype=np.uint32)
    return np.concatenate([bits, bits | np.uint32(0x80000000)]).view(
        np.float32)


def _master_arenas(m_codec, v_codec, seed):
    """`_pair_arenas`, with row 0 of p (where m = v = 0, so the update is
    0 and p_new is p, flushed or not) holding `_edge_p`'s values."""
    jm, tm, jv, tv, g, p = _pair_arenas(m_codec, v_codec, seed=seed)
    edge = _edge_p(flush=(m_codec, v_codec) != ("fp32", "fp32"))
    p[0, :edge.size] = edge
    return jm, tm, jv, tv, p


def _bf16_bits(x):
    """The bits of a bf16 tensor or JAX array, as int16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


FORMS = [("unguarded", None), ("ok=1", True), ("ok=0, bc1=0", False)]


@pytest.mark.parametrize("form,ok", FORMS, ids=[f for f, _ in FORMS])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_master_apply_plain_version_vs_reference(m_codec, v_codec, form, ok):
    """The master form on the edge arena (weight decay 0, so the edge row
    passes through the update unchanged, and 0.01): the master as the
    reference's (rowcol's updates to RC_APPLY_TOL), the work as the
    reference's bit for bit (rowcol: bf16 of its own master), and both as
    the port's plain-form p and p.to(bfloat16), bit for bit. XLA's convert
    to bf16 is torch's on every element (the reference's work against
    torch's cast of the reference's master). With ok = 0 at bc1 = 0 the
    master keeps every byte and the work is bf16 of it."""
    for wd in (0.0, 0.01):
        jm, tm, jv, tv, p = _master_arenas(m_codec, v_codec, seed=3)
        bc1 = np.float32(0) if ok is False else np.float32(1) - np.float32(B1)
        kw = dict(lr=np.float32(LR), bc1=bc1,
                  bc2=np.float32(1) - np.float32(B2), eps=1e-8,
                  weight_decay=wd, m_codec=m_codec, v_codec=v_codec)
        jguard = {} if ok is None else dict(guard=jnp.asarray(ok))
        tguard = {} if ok is None else dict(
            guard=torch.tensor([1.0 if ok else 0.0]))
        jp, jw = jfs.arena_apply(jnp.asarray(p), jm, jv,
                                 work_dtype=jnp.bfloat16, **jguard, **kw)
        tp = _t(p)
        got = tfs.arena_apply(tp, tm, tv, work_dtype=BF16, **tguard, **kw)
        assert got[0] is tp and got[1].dtype == BF16
        tw = got[1]
        label = f"{m_codec}/{v_codec} {form} wd={wd}"
        # XLA's convert is torch's round to nearest even
        assert np.array_equal(
            _bf16_bits(torch.from_numpy(np.asarray(jp).copy()).to(BF16)),
            _bf16_bits(jw)), label
        # the master form's p is the plain form's; its work is bf16(p)
        plain = tfs.arena_apply(_t(p), tm, tv, **tguard, **kw)
        _assert_bitwise(tp, plain, f"master vs plain form {label}")
        assert np.array_equal(_bf16_bits(tw), _bf16_bits(tp.to(BF16))), label
        if ok is False:
            _assert_bitwise(tp, p, f"master kept {label}")
        _assert_apply_matches(v_codec, tp, jp, p, f"master {label}")
        if v_codec != "rowcol":
            assert np.array_equal(_bf16_bits(tw), _bf16_bits(jw)), label
        # the edge row reaches the work as bf16 of itself
        edge = _edge_p((m_codec, v_codec) != ("fp32", "fp32"))
        if wd == 0.0 and ok is not False:
            want = torch.from_numpy(edge.copy())
            if (m_codec, v_codec) != ("fp32", "fp32"):
                want = torch.where(want.abs() < np.finfo(np.float32).tiny,
                                   torch.zeros_like(want).copysign(want),
                                   want)
            assert np.array_equal(_bf16_bits(tw[0, :edge.size]),
                                  _bf16_bits(want.to(BF16))), label


def test_master_apply_fills_the_callers_work_buffer():
    """`work=` is written in place (the cache's buffer), and the wrapper
    refuses what the kernel does not take: a non-fp32 master (the
    reference's words), a work of the wrong shape or dtype, a work without
    work_dtype, a work dtype other than bf16."""
    _, tm, _, tv, p = _master_arenas("int8", "rowcol", seed=1)
    kw = dict(lr=LR, bc1=0.1, bc2=0.001, m_codec="int8", v_codec="rowcol")
    buf = torch.full(p.shape, 7.0, dtype=BF16)
    tp = _t(p)
    got_p, got_w = tfs.arena_apply(tp, tm, tv, work_dtype=BF16, work=buf,
                                   **kw)
    assert got_w is buf and torch.equal(buf, tp.to(BF16))
    with pytest.raises(TypeError, match="master-param apply requires an "
                                        "fp32 master region, got"):
        tfs.arena_apply(_t(p).double(), tm, tv, work_dtype=BF16, **kw)
    for bad in (torch.empty(p.shape, dtype=torch.float32),
                torch.empty((p.shape[0] - 8, p.shape[1]), dtype=BF16)):
        with pytest.raises(ValueError, match="work must be"):
            tfs.arena_apply(_t(p), tm, tv, work_dtype=BF16, work=bad, **kw)
    with pytest.raises(ValueError, match="work_dtype"):
        tfs.arena_apply(_t(p), tm, tv, work=buf, **kw)
    with pytest.raises(TypeError, match="work_dtype must be torch.bf"):
        tfs.arena_apply(_t(p), tm, tv, work_dtype=torch.float16, **kw)


# ---------------------------------------------------------------------------
# State and engines on reduced stablelm-1.6b
# ---------------------------------------------------------------------------


def _port_tree():
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    return cfg, tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                         "cpu")).tree()


def test_init_arena_master_and_cache_match_the_reference():
    """The master "p" (fp32 pack of the params) and the cache "wp" (bf16
    pack) are the reference's bit for bit; working_params unpacks the
    cache to the leaves' dtype."""
    _, tree = _port_tree()
    st = tadama.init_arena(tree, codec="rowcol", m_codec="int8",
                           master_params=True, work_param_cache=True)
    ref = jadama.init_arena(jax.tree.map(jnp.asarray, _init_params()),
                            codec="rowcol", m_codec="int8",
                            master_params=True, work_param_cache=True)
    assert st["p"].data.dtype == torch.float32 and st["wp"].data.dtype == BF16
    _assert_bitwise(st["p"].data, np.asarray(ref["p"].data), "p")
    assert np.array_equal(_bf16_bits(st["wp"].data),
                          _bf16_bits(ref["wp"].data))
    assert tss.has_master(st) and not tss.has_master(
        tadama.init_arena(tree))
    assert tss.param_region_bytes(st) == {
        "p": st["p"].data.numel() * 4, "wp": st["wp"].data.numel() * 2}
    wp = tadama.working_params(st)
    for x, y in zip(tarena.tree_flatten(wp)[0], tarena.tree_flatten(tree)[0]):
        assert x.dtype == torch.float32
        assert torch.equal(x, y.detach().to(BF16).float())


def _sched(engine, framework):
    """ga reads the schedule at the pre-increment step and runs the
    reference's warmup (tests/test_torch_engines.py: its first step is
    ill-conditioned across frameworks); the AdamA engines a constant lr."""
    if engine != "ga":
        return None
    mod = jsched if framework == "jax" else tsched
    return mod.warmup_cosine(1e-3, 1, STEPS + 1)


def _fault(spec, framework):
    return (jfaults if framework == "jax" else tfaults).parse_fault(spec)


@functools.lru_cache(maxsize=None)
def _reference_run(engine, m_codec, v_codec, guarded, fault=None,
                   steps=STEPS, **over):
    """The reference's master run: per step (loss, packed leaves, master)."""
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, state_codec=v_codec,
                             m_codec=m_codec, finite_guard=guarded,
                             master_params=True, **over)
    step, init = jax_make_train_step(tiny(ARCH), opt,
                                     lr_schedule=_sched(engine, "jax"),
                                     fault=_fault(fault, "jax"))
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _init_params())
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _batches(steps):
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(mx["loss"]),
                    np.asarray(jarena.pack(params, layout)),
                    np.asarray(state["p"].data)))
    return out, int(state["step"])


def _batches(steps):
    """tests/test_torch_guard.py's batches (the same seed), `steps` of
    them."""
    data = make_data(get_config(ARCH).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(steps)]


def _counting(monkeypatch):
    """Count the wrapper calls of the three arena kernels (their launch
    counters move only on the card)."""
    calls = {}
    for name in ("arena_fold", "arena_fold_slice", "arena_apply"):
        def wrapper(*a, _fn=getattr(tfs, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tfs, name, wrapper)
    return calls


def _port_run(engine, m_codec, v_codec, guarded, steps=STEPS, fault=None,
              tree=None, calls=None, **over):
    """The port's run from the reference's params (or `tree`): per step
    (loss, packed leaves, master or None, wrapper calls so far), and the
    final state."""
    cfg, tree0 = _port_tree()
    tree = tree0 if tree is None else tree
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          state_codec=v_codec, m_codec=m_codec,
                          finite_guard=guarded, **over)
    step, init = make_train_step(cfg, opt, lr_schedule=_sched(engine, "port"),
                                 fault=_fault(fault, "port"))
    state = init(tree)
    out = []
    for batch in _batches(steps):
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            out.append((float(mx["loss"]),
                        tarena.pack(tree, state["m"].layout).numpy().copy(),
                        (state["p"].data.numpy().copy() if "p" in state
                         else None),
                        dict(calls or {})))
    return out, state


def _bf16_ulp(x):
    """One bf16 ulp at |x| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.exp2(e - 7)


# The leaves are bf16(master) on both sides, so where the two masters lie
# on either side of a bf16 rounding boundary (they differ by the models'
# float32 roundings) a leaf differs by one bf16 ulp (1.2e-4 at |p| = 0.02,
# far beyond ENGINE_TOL); and the forward reads the bf16 leaves, so such a
# flip moves the next gradients as a flipped bf16 slab element does on the
# bf16 wire. Both are held by queue 3 (m)'s rule (test_torch_wire's
# `_assert_wire_params_close`): at most WIRE_FLIP_FRAC of the elements
# (CODE_FLIP_FRAC more with int8 m, whose code flips the engines' tests
# measure) beyond ENGINE_TOL, none beyond ENGINE_TOL + (drift_lr +
# bf16_wire_lr) x lr, and a leaf one bf16 ulp beyond that. Measured (the
# runs below, 2-3 steps): fp32/fp32 masters 6.4e-7 of the elements beyond
# ENGINE_TOL (largest 4.1e-5, after 3 cached steps), none after 2; leaves
# up to 0.049% (largest 2.4e-4, two ulps at 0.03); int8/rowcol masters up
# to 3.3% (int8 m's flips, largest 2.4e-4), leaves up to 0.018% beyond.
def _master_bound(m_codec, v_codec):
    """(the largest difference allowed, the share allowed beyond
    ENGINE_TOL) of a pair's master against the reference's."""
    confs = [tss.get_codec(n, mo).conformance
             for mo, n in (("m", m_codec), ("v", v_codec))]
    bound = ENGINE_TOL + sum((c.drift_lr or 0.0) + c.bf16_wire_lr
                             for c in confs) * LR
    frac = WIRE_FLIP_FRAC + (CODE_FLIP_FRAC if any(c.drift_lr for c in confs)
                             else 0.0)
    return bound, frac


def _assert_close(got, want, m_codec, v_codec, label, ulps=0):
    """`got` (a master, or with ulps=1 the leaves) against the reference's
    by `_master_bound`, `ulps` bf16 ulps more for each element."""
    bound, frac = _master_bound(m_codec, v_codec)
    d = np.abs(got - want)
    off = d > ENGINE_TOL
    assert float(off.mean()) <= frac, (label, float(off.mean()))
    slack = bound + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (d <= slack).all(), (label, float(d.max()))


def _as_bf16(x):
    return torch.from_numpy(np.array(x)).to(BF16).float().numpy()


ENGINES = [(e, m, v, g) for e in ("ga", "adama", "adama_layerwise")
           for m, v in (("fp32", "fp32"), ("int8", "rowcol"))
           for g in (False, True)]


@pytest.mark.parametrize("engine,m_codec,v_codec,guarded", ENGINES)
def test_master_engine_matches_reference(engine, m_codec, v_codec, guarded,
                                         monkeypatch):
    """Two steps with master params: the master after step 1 is the port's
    fp32 run's params bit for bit (same gradients, same apply), the leaves
    are exactly bf16(master) after every step, both lie within the engine
    tolerances of the reference's master run, the losses as its (step 1
    bit for bit the fp32 run's), and every step launches what the fp32
    run's does: one apply (the work rides the same kernel)."""
    calls = _counting(monkeypatch)
    got, state = _port_run(engine, m_codec, v_codec, guarded,
                           master_params=True, calls=calls)
    monkeypatch.undo()
    plain_calls = _counting(monkeypatch)
    fp32, _ = _port_run(engine, m_codec, v_codec, guarded,
                        calls=plain_calls)
    want, ref_step = _reference_run(engine, m_codec, v_codec, guarded)
    assert state["step"] == ref_step == STEPS
    assert set(state) >= {"p", "m", "v", "step"} and "wp" not in state
    _assert_bitwise(got[0][2], fp32[0][1], "master after step 1")
    assert got[0][0] == fp32[0][0]
    flips = m_codec == "int8" and v_codec == "rowcol"
    for k, ((loss, leaves, master, c), (_, _, _, fc),
            (wloss, wleaves, wmaster)) in enumerate(zip(got, fp32, want)):
        label = f"step {k + 1}"
        assert c == fc and c["arena_apply"] == k + 1, (label, c, fc)
        _assert_bitwise(leaves, _as_bf16(master), f"leaves {label}")
        _assert_bitwise(wleaves, _as_bf16(wmaster), f"ref leaves {label}")
        np.testing.assert_allclose(
            loss, wloss, rtol=0,
            atol=LOSS_FLIP_TOL if flips and k else LOSS_TOL)
        _assert_close(master, wmaster, m_codec, v_codec, label)
        _assert_close(leaves, wleaves, m_codec, v_codec, label, ulps=1)


@pytest.mark.parametrize("engine", ["ga", "adama", "adama_layerwise"])
def test_work_param_cache_is_a_bf16_round_trip_of_step_one(engine):
    """The reference's contract for the cache: a cached run is bit for bit
    an uncached master run whose step-1 leaves went through the bf16 pack
    once (both states initialised from the same params), over 3 steps:
    losses, leaves, master and m. The cache holds bf16(master) after every
    step (the kernel wrote into it), and the cached run lies within the
    engine tolerances of the reference's cached run."""
    steps = 3
    cached, stc = _port_run(engine, "fp32", "fp32", False, steps=steps,
                            master_params=True, work_param_cache=True)
    cfg, tree = _port_tree()
    lay = tarena.build_layout(tree)
    with torch.no_grad():
        rt = tarena.unpack(tarena.pack(tree, lay, dtype=BF16).float(), lay)
        for leaf, x in zip(tarena.tree_flatten(tree)[0],
                           tarena.tree_flatten(rt)[0]):
            leaf.copy_(x)
    # the uncached run's state is initialised from the round-tripped leaves,
    # so its master must be reset to the fp32 params' pack
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          master_params=True)
    step, init = make_train_step(cfg, opt,
                                 lr_schedule=_sched(engine, "port"))
    stu = init(tree)
    _, tree0 = _port_tree()
    with torch.no_grad():
        stu["p"].data.copy_(tarena.pack(tree0, lay))
    assert "wp" in stc and "wp" not in stu
    for k, batch in enumerate(_batches(steps)):
        tree, stu, mx = step(
            tree, stu, {n: torch.from_numpy(v) for n, v in batch.items()})
        loss, leaves, master, _ = cached[k]
        assert float(mx["loss"]) == loss, k
        with torch.no_grad():
            _assert_bitwise(tarena.pack(tree, lay).numpy(), leaves,
                            f"leaves {k}")
        _assert_bitwise(stu["p"].data, master, f"master {k}")
    _assert_bitwise(stc["m"].data, stu["m"].data.numpy(), "m")
    assert torch.equal(stc["wp"].data, stc["p"].data.to(BF16))
    want, _ = _reference_run(engine, "fp32", "fp32", False, steps=steps,
                             work_param_cache=True)
    for k, ((loss, leaves, master, _), (wloss, wleaves, wmaster)) in \
            enumerate(zip(cached, want)):
        label = f"cached step {k + 1}"
        np.testing.assert_allclose(loss, wloss, rtol=0, atol=LOSS_TOL)
        _assert_close(master, wmaster, "fp32", "fp32", label)
        _assert_close(leaves, wleaves, "fp32", "fp32", label, ulps=1)


def test_all_skipped_ga_step_keeps_the_master_and_emits_its_cast():
    """Guarded ga with a NaN at step 0 (it fires again, the step counter
    staying at 0): the master keeps every byte of pack(initial params),
    the leaves are bf16(initial params) (the skipped apply still writes
    the work, as the reference's where-then-cast does), bit for bit the
    reference's leaves, and both steps are counted as skipped."""
    fault = "nan@micro=0,step=0"
    got, state = _port_run("ga", "fp32", "fp32", True, fault=fault,
                           master_params=True)
    want, ref_step = _reference_run("ga", "fp32", "fp32", True, fault=fault)
    _, tree = _port_tree()
    with torch.no_grad():
        p0 = tarena.pack(tree, state["m"].layout).numpy()
    assert state["step"] == ref_step == 0
    assert int(state["scaler"]["skipped"]) == STEPS
    for k, ((_, leaves, master, _), (_, wleaves, wmaster)) in enumerate(
            zip(got, want)):
        _assert_bitwise(master, p0, f"master {k}")
        _assert_bitwise(master, wmaster, f"ref master {k}")
        _assert_bitwise(leaves, _as_bf16(p0), f"leaves {k}")
        _assert_bitwise(leaves, wleaves, f"ref leaves {k}")


# ---------------------------------------------------------------------------
# Config and CLI
# ---------------------------------------------------------------------------

MASTER_GRID = [dict(master_params=mp, work_param_cache=wc, arena=a,
                    accumulation=e, grad_dtype=w, finite_guard=f)
               for mp in (False, True) for wc in (False, True)
               for a in (True, False)
               for e in ("ga", "adama", "adama_layerwise")
               for w in ("fp32", "bf16") for f in (False, True)]


def _outcome(make, kw):
    try:
        make(**kw)
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("kw", MASTER_GRID, ids=lambda kw: "-".join(
    str(x) for x in kw.values()))
def test_master_config_checks_match_the_reference(kw):
    """Every master x cache x state form x engine x wire x guard: where the
    reference refuses, the port raises its ValueError with the same
    message, in the same order among its checks; where it accepts, so does
    the port, but for per-leaf ga (its own NotImplementedError)."""
    want = _outcome(lambda **k: JaxOptimizerConfig(
        name="adama", use_pallas=True, **k), kw)
    got = _outcome(OptimizerConfig, kw)
    if want is not None:
        assert got == want
    elif kw["accumulation"] == "ga" and not kw["arena"]:
        assert got is not None and got[0] is NotImplementedError
    else:
        assert got is None


def test_cli_runs_master_params_and_the_cache_on_the_cpu(capsys):
    """`--master-params --work-param-cache --device cpu` trains and prints
    its losses; the cache without the master is refused with the
    reference's message."""
    args = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "2",
            "--global-batch", "4", "--micro-batches", "2", "--seq-len", "16",
            "--log-every", "1", "--device", "cpu"]
    tlaunch.main(args + ["--master-params", "--work-param-cache"])
    out = capsys.readouterr().out
    assert "step 2/2" in out and "[train] done" in out
    with pytest.raises(ValueError, match="work_param_cache=True requires "
                                         "master_params=True"):
        tlaunch.main(args + ["--work-param-cache"])
