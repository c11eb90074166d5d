"""The port's bf16 gradient wire and loss scaling against the reference's
(tests/test_mixed_precision.py, tests/test_codec_conformance.py and
tests/test_resilience.py), on the CPU:

  - pack, pack_layer and pack_rest at dtype=bfloat16 equal the reference's
    slabs bit for bit (round to nearest even, zero padding included);
  - the folds on a bf16 slab, every (m, v) pair, guarded and unguarded,
    equal the port's own fp32-wire folds of the slab upcast on the host bit
    for bit, and the reference's bf16-wire folds (interpret mode) bit for
    bit but int8 m (INT8_M_WIRE_STEPS) and rowcol's sums (RC_REL_TOL);
  - a declared wire that differs from the slab fails loudly, and the fp32
    accumulation does not depend on the micro-batch count;
  - the config's wire, guard and loss-scale checks give the reference's
    messages for every wire x engine x state form x guard x loss scale;
  - the engines on reduced stablelm-1.6b on the bf16 wire against the
    reference's bf16-wire engines, and against the port's fp32-wire run
    within each pair's declared bf16_wire_lr;
  - dynamic loss scaling backs off on a NaN and tracks the fp32-wire run
    that skipped the same micro-batch; a static scale is transparent.

The CUDA forms are held against these plain versions on the card by
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
from repro.configs.base import grad_wire_dtype as jax_grad_wire_dtype
from repro.core import arena as jarena
from repro.core.accumulation import make_train_step as jax_make_train_step
from repro.kernels import fused_step as jfs
from repro.train import faults as jfaults
from repro_torch.configs.base import (GRAD_DTYPES, OptimizerConfig,
                                      get_config, grad_wire_dtype)
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel
from repro_torch.train import faults as tfaults
from repro_torch.data import make_data
from test_torch_codecs import (B1, B2, CODE_FLIP_FRAC, FOLDS, LOSS_FLIP_TOL,
                               LOSS_TOL, LR, PAIRS, _assert_bitwise,
                               _assert_state_matches, _pair_arenas)
from test_torch_engines import ENGINE_TOL
from test_torch_guard import (ARCH, GLOBAL_BATCH, N_MICRO, SEQ, STEPS,
                              TRACED_SCALE, _guard_vec, _init_params)

torch.set_num_threads(1)

# int8 m on the bf16 wire (ROADMAP queue 3 (b)): the reference's XLA CPU
# rounds int8 m's fold of a bf16 slab otherwise than of the same slab in
# fp32 (its own tests/test_mixed_precision.py upcast test fails there),
# while the port's bf16 fold is its fp32 fold of the upcast slab bit for
# bit. Measured on the 64-row edge arenas (seeds 0-3, two folds): codes off
# by at most 1 (48 of 65,536), row scales by 1-2 ulps, but where a flipped
# code is its row's max the next fold's scale follows it (one row, 4.6e-4
# relative); decoded m within 1.06 row-scale steps. Held, as queue 3 (k)'s
# traced-scale difference is, to two steps.
INT8_M_WIRE_STEPS = 2.0
# The engines on the bf16 wire against the reference's: the two models'
# gradients differ by float32 roundings (~1e-7), so a value within that of
# a bf16 rounding boundary rounds the other way on one side, and its slab
# element differs by one bf16 ulp (2^-8 relative). That moves the param by
# at most the pair's declared bf16_wire_lr x lr (the reference's own bound
# for a bf16 rounding of g), and on few elements. So the params are held as
# test_torch_codecs holds code flips: at most WIRE_FLIP_FRAC of the elements
# (CODE_FLIP_FRAC with an int8 codec) beyond ENGINE_TOL, none beyond
# ENGINE_TOL + (drift_lr + bf16_wire_lr) x lr. Measured (2 steps, adama and
# adama_layerwise alike): fp32/fp32 0.0002% and 0.0024% of the elements
# beyond 5e-6, largest 5.5e-6 and 8.6e-6; fp32/rowcol 0.008%, 2.5e-5;
# int8 m pairs up to 0.19% (int8 m's code flips), 4.7e-4 (int8/fp32); the
# dynamic-scale runs 0.008%, 1.2e-5. A wrong or missing update moves nearly
# every element by ~lr.
WIRE_FLIP_FRAC = 1e-3


def _bf16(x):
    """A float32 numpy array rounded to bfloat16 (by XLA's convert), as a
    JAX array and as a torch tensor of the same bits."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy())
    return j, t.view(torch.bfloat16)


def _port_copy(state):
    return (tuple(x.clone() for x in state) if isinstance(state, tuple)
            else state.clone())


def _assert_wire_matches(m_codec, v_codec, tm, jm, tv, jv, label):
    """As test_torch_codecs' _assert_state_matches, int8 m within
    INT8_M_WIRE_STEPS of the reference's row-scale steps, codes within 1."""
    if m_codec == "int8":
        (q, s), (jq, js) = ((np.asarray(x, np.float64) for x in pair)
                            for pair in (tm, jm))
        assert np.abs(q - jq).max() <= 1, label
        gap = np.abs(q * s - jq * js) / np.maximum(np.maximum(s, js), 1e-45)
        assert gap.max() <= INT8_M_WIRE_STEPS, (label, gap.max())
        tm = tuple(np.asarray(x) for x in jm)
    _assert_state_matches(m_codec, v_codec, tm, jm, tv, jv, label)


# ---------------------------------------------------------------------------
# The slab: pack at dtype=bfloat16
# ---------------------------------------------------------------------------


def _wire_values(rng, shape):
    """Gradient-like float32 values over 35 decades, both signs."""
    mag = np.float32(10.0) ** rng.uniform(-33, 3, shape).astype(np.float32)
    return (rng.standard_normal(shape).astype(np.float32) * mag)


def _edge_values():
    """float32 values at bf16's rounding edges: exact ties (low half
    0x8000) on even and odd bf16 mantissas, one ulp either side of a tie,
    a carry into the exponent, fp32 subnormals, -0.0, values that round up
    to bf16's infinity, and the largest finite bf16."""
    bits = []
    for hi in (0x3F80, 0x3F81, 0xBF80, 0xBF81, 0x0001, 0x7F7F, 0x3FFF):
        bits += [(hi << 16) | lo for lo in (0x8000, 0x7FFF, 0x8001, 0x0000,
                                            0xFFFF)]
    bits += [0x80000000, 0x00000001, 0x007FFFFF, 0x80400000, 0x7F7FFFFF,
             0xFF7FFFFF, 0x7F7F0000]
    return np.array(bits, dtype=np.uint32).view(np.float32)


def _grad_trees(seed=0):
    """A gradient tree shaped like reduced stablelm-1.6b's params, as JAX
    arrays and torch tensors of the same values, the edge values at the
    head of every leaf."""
    rng = np.random.default_rng(seed)
    edge = _edge_values()

    def fill(x):
        v = _wire_values(rng, x.shape).reshape(-1)
        k = min(v.size, edge.size)
        v[:k] = edge[:k]
        return v.reshape(x.shape)
    tree = jax.tree.map(fill, _init_params())
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree))


def _bits16(x):
    x = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).view(np.int16)
    return np.ascontiguousarray(x)


@pytest.mark.parametrize("what", ["pack", "pack_layer", "pack_rest"])
def test_bf16_pack_is_the_references_bit_for_bit(what):
    """The bf16 slab of a whole tree, of one layer and of the rest region
    equals the reference's bit for bit: each leaf rounded to nearest even
    (ties, carries, subnormals and the overflow to infinity included), the
    padding zero."""
    jtree, ttree = _grad_trees()
    jlay, tlay = jarena.build_layout(jtree), tarena.build_layout(ttree)
    if what == "pack":
        j = jarena.pack(jtree, jlay, dtype=jnp.bfloat16)
        t = tarena.pack(ttree, tlay, dtype=torch.bfloat16)
    elif what == "pack_layer":
        j = jarena.pack_layer(jax.tree.map(lambda x: x[1], jtree["blocks"]),
                              jlay.stack("blocks"), dtype=jnp.bfloat16)
        t = tarena.pack_layer({k: x[1] for k, x in ttree["blocks"].items()},
                              tlay.stack("blocks"), dtype=torch.bfloat16)
    else:
        rest = {k: x for k, x in jtree.items() if k != "blocks"}
        j = jarena.pack_rest(rest, jlay, dtype=jnp.bfloat16)
        t = tarena.pack_rest({k: x for k, x in ttree.items()
                              if k != "blocks"}, tlay, dtype=torch.bfloat16)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
    assert np.array_equal(_bits16(t), _bits16(j))
    # the fp32 slab, cast on the host, is the same slab
    full = tarena.pack(ttree, tlay) if what == "pack" else None
    if full is not None:
        assert torch.equal(full.to(torch.bfloat16).view(torch.int16),
                           t.view(torch.int16))


def test_pack_refuses_fp8_as_the_reference_does():
    jtree, ttree = _grad_trees()
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        jarena.pack(jtree, jarena.build_layout(jtree),
                    dtype=jnp.float8_e4m3fn)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tarena.pack(ttree, tarena.build_layout(ttree),
                    dtype=torch.float8_e4m3fn)


@pytest.mark.parametrize("name", GRAD_DTYPES + ("fp16",))
def test_grad_wire_dtype_matches_the_reference(name):
    try:
        want = jnp.dtype(jax_grad_wire_dtype(name))
    except ValueError as e:
        with pytest.raises(ValueError) as t:
            grad_wire_dtype(name)
        assert str(t.value) == str(e)
        return
    got = grad_wire_dtype(name)
    assert got.itemsize == want.itemsize
    assert str(got).split(".")[-1] == want.name


# ---------------------------------------------------------------------------
# The folds on a bf16 slab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_bf16_wire_fold_is_the_fp32_fold_of_the_upcast_slab(m_codec,
                                                           v_codec):
    """A first fold (decay fused, scale 1) and a later one (scale 1/4) of
    bf16 slabs: the port's state equals its fp32-wire folds of the same
    slabs upcast on the host bit for bit, and the reference's bf16-wire
    folds bit for bit but int8 m (INT8_M_WIRE_STEPS) and rowcol's sums
    (RC_REL_TOL)."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec)
    um, uv = _port_copy(tm), _port_copy(tv)
    for grad, kw in zip((g, np.flip(g, 0).copy()), FOLDS):
        j16, t16 = _bf16(grad)
        jm, jv = jfs.arena_fold(jm, jv, j16, beta1=B1, beta2=B2,
                                m_codec=m_codec, v_codec=v_codec,
                                grad_dtype=jnp.bfloat16, **kw)
        out = tfs.arena_fold(tm, tv, t16, beta1=B1, beta2=B2,
                             m_codec=m_codec, v_codec=v_codec,
                             grad_dtype=torch.bfloat16, **kw)
        assert out[0] is tm and out[1] is tv               # in place
        tfs.arena_fold(um, uv, t16.float(), beta1=B1, beta2=B2,
                       m_codec=m_codec, v_codec=v_codec, **kw)
        _assert_bitwise(tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0],
                        tfs._as_parts(um)[0] + tfs._as_parts(uv)[0],
                        f"bf16 vs upcast {kw}")
        _assert_wire_matches(m_codec, v_codec, tm, jm, tv, jv, str(kw))


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_guarded_bf16_wire_fold_is_the_fp32_fold_of_the_upcast_slab(
        m_codec, v_codec, ok):
    """The guarded form at the traced scale, through the guard vector: with
    ok, the bf16 fold and slice fold equal the fp32 ones of the upcast
    slab bit for bit; without, neither writes a byte."""
    _, tm, _, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=9)
    before = [x.clone() for x in tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0]]
    um, uv = _port_copy(tm), _port_copy(tv)
    _, t16 = _bf16(g)
    kw = dict(beta1=B1, beta2=B2, m_codec=m_codec, v_codec=v_codec)
    for state, slab in (((tm, tv), t16), ((um, uv), t16.float())):
        tfs.arena_fold(*state, slab, guard=_guard_vec((B1, B2), ok), **kw)
        tfs.arena_fold_slice(*state, slab[8:40], 16, block=8,
                             guard=_guard_vec(None, ok), **kw)
    got = tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0]
    _assert_bitwise(got, tfs._as_parts(um)[0] + tfs._as_parts(uv)[0],
                    f"guarded ok={ok}")
    if not ok:
        _assert_bitwise(got, tuple(before), "ok = 0 wrote")


@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_bf16_wire_slice_fold(m_codec, v_codec):
    """Rows [16, 48) folded from a bf16 slab (block 16, decay fused): bit
    for bit the fp32 slice fold of the upcast slab, the reference's within
    _assert_wire_matches, and the row-indexed columns outside the slice
    untouched."""
    jm, tm, jv, tv, g, _ = _pair_arenas(m_codec, v_codec, seed=3)
    um, uv = _port_copy(tm), _port_copy(tv)
    rows_of = [x for st, mo, name in ((tm, "m", m_codec), (tv, "v", v_codec))
               for x, c in zip(tfs._as_parts(st)[0],
                               tfs.kernel_codec(mo, name).cols)
               if c.row_indexed]
    before = [x.clone() for x in rows_of]
    j16, t16 = _bf16(g[24:56])
    kw = dict(beta1=B1, beta2=B2, block=16, scale=TRACED_SCALE,
              decay=(B1, B2), m_codec=m_codec, v_codec=v_codec)
    jm, jv = jfs.arena_fold_slice(jm, jv, j16, 16, grad_dtype=jnp.bfloat16,
                                  **kw)
    tfs.arena_fold_slice(tm, tv, t16, 16, grad_dtype=torch.bfloat16, **kw)
    tfs.arena_fold_slice(um, uv, t16.float(), 16, **kw)
    _assert_bitwise(tfs._as_parts(tm)[0] + tfs._as_parts(tv)[0],
                    tfs._as_parts(um)[0] + tfs._as_parts(uv)[0],
                    "bf16 vs upcast")
    _assert_wire_matches(m_codec, v_codec, tm, jm, tv, jv, "slice")
    for x, x0 in zip(rows_of, before):
        assert torch.equal(x[:16], x0[:16]) and torch.equal(x[48:], x0[48:])


def test_declared_wire_dtype_mismatch_fails_loudly():
    """tests/test_mixed_precision.py's contract, on both folds: a declared
    wire that is not the slab's raises TypeError naming grad_dtype; a slab
    in no wire's dtype raises naming the wire, through the state store
    too."""
    g = torch.zeros(8, tfs.LANES)
    m, v = torch.zeros(8, tfs.LANES), torch.zeros(8, tfs.LANES)
    kw = dict(beta1=B1, beta2=B2)
    with pytest.raises(TypeError, match="grad_dtype"):
        tfs.arena_fold(m, v, g, grad_dtype=torch.bfloat16, **kw)
    with pytest.raises(TypeError, match="wire"):
        tfs.arena_fold(m, v, g.half(), **kw)
    with pytest.raises(TypeError, match="grad_dtype"):
        tfs.arena_fold_slice(m, v, g.bfloat16(), 0, block=8,
                             grad_dtype=torch.float32, **kw)
    with pytest.raises(TypeError, match="wire"):
        tfs.arena_fold_slice(m, v, g.double(), 0, block=8, **kw)
    with pytest.raises(TypeError, match="wire"):
        tss.fold("fp32", "fp32", (m,), (v,), g.half(), **kw)
    # the apply's p stays float32 only
    with pytest.raises(TypeError, match="float32"):
        tfs.arena_apply(g.bfloat16(), m, v, lr=LR, bc1=0.1, bc2=0.001)
    # and the reference raises the same way
    with pytest.raises(TypeError, match="grad_dtype"):
        jfs.arena_fold(jnp.zeros((8, 1024)), jnp.zeros((8, 1024)),
                       jnp.zeros((8, 1024)), grad_dtype=jnp.bfloat16, **kw)


def test_fp32_accumulation_is_micro_batch_count_independent():
    """tests/test_mixed_precision.py's contract on the port: the same
    gradient mass folded as N bf16 slabs keeps the error at the one bf16
    rounding per slab for every N (m accumulates in fp32), measured against
    a float64 sum of the same rounded slabs."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, tfs.LANES))
                         .astype(np.float32))
    scale = float(g.abs().max()) * 0.1
    for n in (1, 2, 4, 8):
        m = torch.zeros(64, tfs.LANES)
        v = torch.zeros(64, tfs.LANES)
        m_ref = np.zeros((64, tfs.LANES), np.float64)
        for _ in range(n):
            slab = (g / n).to(torch.bfloat16)
            tfs.arena_fold(m, v, slab, beta1=0.9, beta2=0.999)
            m_ref += 0.1 * slab.double().numpy()
        err = float(np.abs(m.double().numpy() - m_ref).max())
        assert err <= 2e-6 * scale, (n, err)


# ---------------------------------------------------------------------------
# The config: the reference's wire, guard and loss-scale checks
# ---------------------------------------------------------------------------

WIRE_GRID = [dict(grad_dtype=w, accumulation=e, arena=a, finite_guard=f,
                  loss_scale=s)
             for w in GRAD_DTYPES + ("fp16",)
             for e in ("ga", "adama", "adama_layerwise")
             for a in (True, False) for f in (False, True)
             for s in ("off", "dynamic", "1024")]


def _outcome(make, kw):
    try:
        make(**kw)
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("kw", WIRE_GRID, ids=lambda kw: "-".join(
    str(x) for x in kw.values()))
def test_wire_config_checks_match_the_reference(kw):
    """Every wire x engine x state form x guard x loss scale: where the
    reference refuses, the port raises its ValueError with the same
    message; where it accepts, the port accepts too (the fp8 wire
    included), but for its own refusal, a NotImplementedError naming its
    ROADMAP item: per-leaf ga (item 12)."""
    want = _outcome(lambda **k: JaxOptimizerConfig(
        name="adama", use_pallas=True, **k), kw)
    got = _outcome(OptimizerConfig, kw)
    if want is not None:
        assert got == want
    elif kw["accumulation"] == "ga" and not kw["arena"]:
        assert got is not None and got[0] is NotImplementedError
        assert "ROADMAP" in got[1] and "item 12" in got[1]
    else:
        assert got is None


# ---------------------------------------------------------------------------
# Engines on reduced stablelm-1.6b, bf16 wire
# ---------------------------------------------------------------------------


def _data(steps):
    """tests/test_torch_guard.py's batches (the same seed), `steps` of
    them."""
    data = make_data(get_config(ARCH).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(steps)]


@functools.lru_cache(maxsize=None)
def _reference_run(engine, m_codec, v_codec, grad_dtype="bf16", fault=None,
                   steps=STEPS, **over):
    """The reference's run: per step (loss, packed params)."""
    opt = JaxOptimizerConfig(name="adama", accumulation=engine,
                             micro_batches=N_MICRO, use_pallas=True,
                             arena=True, state_codec=v_codec,
                             m_codec=m_codec, grad_dtype=grad_dtype, **over)
    step, init = jax_make_train_step(tiny(ARCH), opt,
                                     fault=jfaults.parse_fault(fault))
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, _init_params())
    state = init(params)
    layout = state["m"].layout
    out = []
    for batch in _data(steps):
        params, state, mx = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(mx["loss"]), np.asarray(jarena.pack(params,
                                                              layout))))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(engine, m_codec, v_codec, grad_dtype="bf16", fault=None,
              steps=STEPS, **over):
    """The port's run from the reference's params: per step (loss, packed
    params), and the last step's metrics and state."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    opt = OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                          state_codec=v_codec, m_codec=m_codec,
                          grad_dtype=grad_dtype, **over)
    tree = tmodel.Model(cfg, tmodel.params_from_jax(_init_params(),
                                                    "cpu")).tree()
    step, init = make_train_step(cfg, opt, fault=tfaults.parse_fault(fault))
    state = init(tree)
    out = []
    for batch in _data(steps):
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        with torch.no_grad():
            out.append((float(mx["loss"]),
                        tarena.pack(tree, state["m"].layout).numpy().copy()))
    return out, {k: float(x) for k, x in mx.items()}, state


def _assert_wire_params_close(p, want, m_codec, v_codec, label):
    """The port's params on the bf16 wire against the reference's (see
    WIRE_FLIP_FRAC)."""
    confs = [tss.get_codec(n, mo).conformance
             for mo, n in (("m", m_codec), ("v", v_codec))]
    frac = WIRE_FLIP_FRAC if m_codec == v_codec == "fp32" or (
        m_codec == "fp32" and v_codec in ("factored", "rowcol")) \
        else CODE_FLIP_FRAC
    d = np.abs(p - want)
    off = float((d > ENGINE_TOL).mean())
    assert off <= frac, (label, off)
    bound = ENGINE_TOL + sum((c.drift_lr or 0.0) + c.bf16_wire_lr
                             for c in confs) * LR
    assert d.max() <= bound, (label, d.max(), bound)


def _wire_tol(m_codec, v_codec):
    """The pair's declared bf16-wire drift, in params (the reference's
    tests/test_codec_conformance.py bound: the sum over the codecs of
    bf16_wire_lr, times lr)."""
    return sum(tss.get_codec(n, mo).conformance.bf16_wire_lr
               for mo, n in (("m", m_codec), ("v", v_codec))) * LR


@pytest.mark.parametrize("engine", ["adama", "adama_layerwise"])
@pytest.mark.parametrize("m_codec,v_codec", PAIRS)
def test_bf16_wire_engine_matches_reference(engine, m_codec, v_codec):
    """Two steps on the bf16 wire, every pair, both AdamA engines: losses
    as the reference's bf16-wire engine's, params within ENGINE_TOL of its
    but for the bf16 rounding flips of `_assert_wire_params_close`; and
    the port's params within the pair's declared bf16_wire_lr x lr a step
    of its own fp32-wire run, whose step-1 loss the wire does not move
    (the forward never sees it)."""
    want = _reference_run(engine, m_codec, v_codec)
    got, _, state = _port_run(engine, m_codec, v_codec)
    fp32, _, _ = _port_run(engine, m_codec, v_codec, grad_dtype="fp32")
    assert state["step"] == STEPS
    flips = m_codec == "int8" and v_codec == "rowcol"
    for k, ((loss, p), (wloss, wp), (floss, fp)) in enumerate(
            zip(got, want, fp32)):
        label = f"step {k + 1}"
        np.testing.assert_allclose(
            loss, wloss, rtol=0,
            atol=LOSS_FLIP_TOL if flips and k else LOSS_TOL)
        _assert_wire_params_close(p, wp, m_codec, v_codec, label)
        if k == 0:
            assert loss == floss
        assert np.abs(p - fp).max() <= (k + 1) * _wire_tol(m_codec,
                                                           v_codec), label


# ---------------------------------------------------------------------------
# Loss scaling (tests/test_resilience.py's contracts, on the port)
# ---------------------------------------------------------------------------

SCALE_STEPS = 3


@pytest.mark.parametrize("engine", ["adama", "adama_layerwise"])
def test_dynamic_scale_backs_off_and_matches_the_fp32_skip_run(engine):
    """bf16 wire + dynamic scaling with a NaN at micro-batch 1 of step 1:
    the scale backs off once (2^15 -> 2^14), the step counter is full, the
    params finite; the reference's run reports the same scale and skips;
    and the run tracks the fp32-wire guarded run that skipped the same
    micro-batch: losses within 0.05 (the reference's bound; measured
    7.2e-6) and params within the pair's bf16_wire_lr x lr a step
    (measured 1.9e-5); the reference's dynamic run as in
    test_bf16_wire_engine_matches_reference."""
    fault = "nan@micro=1,step=1"
    got, mx, state = _port_run(engine, "fp32", "fp32", fault=fault,
                               steps=SCALE_STEPS, finite_guard=True,
                               loss_scale="dynamic")
    assert mx["loss_scale"] == 2.0 ** 14
    assert mx["skipped_micro_batches"] == 1.0
    assert state["step"] == SCALE_STEPS
    assert all(np.isfinite(p).all() for _, p in got)
    fp32, mf, _ = _port_run(engine, "fp32", "fp32", grad_dtype="fp32",
                            fault=fault.replace("nan", "skip"),
                            steps=SCALE_STEPS, finite_guard=True)
    assert mf["loss_scale"] == 1.0 and mf["skipped_micro_batches"] == 1.0
    for k, ((loss, p), (floss, fp)) in enumerate(zip(got, fp32)):
        assert abs(loss - floss) < 0.05, (k, loss, floss)
        assert np.abs(p - fp).max() <= (k + 1) * _wire_tol("fp32", "fp32")
    ref = _reference_run(engine, "fp32", "fp32", fault=fault,
                         steps=SCALE_STEPS, finite_guard=True,
                         loss_scale="dynamic")
    for k, ((loss, p), (wloss, wp)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(loss, wloss, rtol=0, atol=LOSS_TOL)
        _assert_wire_params_close(p, wp, "fp32", "fp32", f"step {k + 1}")


@pytest.mark.parametrize("engine", ["adama", "adama_layerwise"])
def test_static_scale_is_transparent(engine):
    """A static scale of 1024 multiplies every slab by 1024 and the guarded
    folds divide it back out in-kernel. A power of two scales float32 and
    bf16 exactly unless a value leaves their range, so the run skips
    nothing and equals the unscaled guarded bf16 run bit for bit: losses,
    params after every step, and the moments. And it is the reference's
    static-scale run, as in test_bf16_wire_engine_matches_reference."""
    got, m1, s1 = _port_run(engine, "fp32", "fp32", steps=SCALE_STEPS,
                            finite_guard=True, loss_scale="1024")
    base, m0, s0 = _port_run(engine, "fp32", "fp32", steps=SCALE_STEPS,
                             finite_guard=True)
    assert m1["loss_scale"] == 1024.0 and m0["loss_scale"] == 1.0
    assert m1["skipped_micro_batches"] == 0.0
    assert s1["step"] == SCALE_STEPS
    for k, ((loss, p), (bloss, bp)) in enumerate(zip(got, base)):
        assert loss == bloss, (k, loss, bloss)
        assert np.array_equal(p, bp), k
    moments = [tuple(c.parts_of(st[k]))
               for st in (s1, s0)
               for c, k in zip(tss.state_codecs(st), "mv")]
    _assert_bitwise(moments[0] + moments[1], moments[2] + moments[3],
                    "moments")
    ref = _reference_run(engine, "fp32", "fp32", steps=SCALE_STEPS,
                         finite_guard=True, loss_scale="1024")
    for k, ((loss, p), (wloss, wp)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(loss, wloss, rtol=0, atol=LOSS_TOL)
        _assert_wire_params_close(p, wp, "fp32", "fp32", f"step {k + 1}")
