"""The data-parallel engine (repro_torch.core.dp_shardmap) at M = 1, in
this process over a one-rank gloo group:

- replicated adama (arena, per leaf, guarded) and row-range ZeRO-1 full
  pack (every (m_codec, v_codec) pair, guarded and not) equal the port's
  single-device adama engine bit for bit: params, every state column, the
  losses, the kernels launched. At M = 1 the reduce-scatter and the
  all-gather copy, /1 is exact and f32(1 * b2) = f32(b2).
- the bucketed ZeRO-1 schedule (the default) equals the single-device
  adama bit for bit on the row-local pairs (rowcol: its row-indexed
  columns bit for bit, its column sums, added bucket by bucket, within
  1e-6 relative, the params within ENGINE_TOL), and the ZeRO-1 stream
  (adama_layerwise) the single-device adama_layerwise bit for bit (the
  reduced models' rest regions are one bucket), on five pairs (every codec
  of each moment), guarded and not; a reduce-scatter a gradient bucket a
  micro-batch.
- the bf16 gradient wire and master params, alone and together, through
  the replicated schedule, the full pack, the bucketed schedule and the
  stream (together also guarded, with dynamic scaling and a NaN), bit for
  bit the single-device engine with the same fields: params, master,
  moments, losses, scaler; each reduce-scatter moves the wire's bytes,
  the master's all-gather half the fp32 gather's, and the leaves are bf16
  of the master;
- a DP run's checkpoints (full pack on the bf16 wire with a master, the
  guarded stream): crashed after step 2 and resumed, bit for bit the run
  that never stopped; every step saved is the single-device run's file;
- every variant (ga, naive, adama arena and per leaf, ZeRO-1, the guarded
  ones) within ENGINE_TOL of the reference's `make_dp_train_step` on a
  one-device mesh, from the same params and batches. ga and naive run
  per-leaf Adam arithmetic, which no single-device engine of the port
  computes, so the reference is their oracle; ga runs the reference's
  warmup schedule (queue 3 (f)).
- every combination the engine refuses raises and names its ROADMAP item;
  adama_layerwise without ZeRO-1 raises the reference's ValueError.

Multi-rank runs (M = 2 and 4) are tests/test_torch_zero.py's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _dp_worker import (ARCH, GUARDED_BF16_MASTER, SEQ, WIRES, batches,
                        init_tree, model_config, run, run_checkpointed)
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.core.dp_shardmap import make_dp_train_step as jax_make_dp
from repro.launch.mesh import make_mesh
from repro.optim import schedule as jsched
from repro.train import faults as jfaults
from repro_torch.configs.base import OptimizerConfig, RunConfig
from repro_torch.core import arena as tarena
from repro_torch.core.dp_shardmap import make_dp_train_step
from repro_torch.core.zero import zero1_bucket_plan
from repro_torch.train.loop import train
from test_torch_engines import ENGINE_TOL

torch.set_num_threads(1)

PAIRS = [(m, v) for m in ("fp32", "int8")
         for v in ("fp32", "int8", "factored", "rowcol")]
N_MICRO = 2
# ZeRO-1 full pack (zero_stage=1 alone is the bucketed schedule)
ZERO1 = dict(zero_stage=1, zero_bucketed=False)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group (file:// rendezvous) for this module."""
    d = tmp_path_factory.mktemp("rdv")
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# name -> (OptimizerConfig fields of both runs, fault, steps); the ZeRO-1
# pairs run one step each (two, replicated), which holds the fold and the
# apply of every codec column; the guarded ones skip micro-batch 1
BITWISE = {"replicated": ({}, None, 2),
           "replicated-per-leaf": (dict(arena=False), None, 2),
           "replicated-guarded": (dict(finite_guard=True),
                                  "nan@micro=1,step=1", 2)}
for _m, _v in PAIRS:
    BITWISE[f"zero1-{_m}-{_v}"] = (dict(m_codec=_m, state_codec=_v), None,
                                   1)
    BITWISE[f"zero1-{_m}-{_v}-guarded"] = (
        dict(m_codec=_m, state_codec=_v, finite_guard=True),
        "nan@micro=1,step=0", 1)


@pytest.mark.parametrize("case", sorted(BITWISE))
def test_m1_adama_equals_single_device_bit_for_bit(case, one_rank):
    kw, fault, steps = BITWISE[case]
    kw = dict(kw, micro_batches=N_MICRO)
    dp_kw = dict(kw, **ZERO1) if case.startswith("zero1") else kw
    want = run(kw, fault=fault, steps=steps)
    got = run(dp_kw, "adama", fault=fault, steps=steps)
    assert got["losses"] == want["losses"]
    assert np.array_equal(got["params"], want["params"])
    for k in ("m", "v"):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got["step"] == want["step"] == steps
    assert got["launches"] == want["launches"]
    assert got.get("scaler") == want.get("scaler")
    if fault:
        assert got["scaler"]["skipped"] == 1
    coll = got["collectives"]
    if case.startswith("zero1"):
        # N gradient scatters and one param gather a step
        assert coll["reduce_scatter"][0] == steps * N_MICRO
        assert coll["all_gather"][0] == steps


def _np_tree(tree):
    leaves, paths = tarena.tree_flatten(tree)
    return tarena.tree_unflatten(paths, [x.detach().numpy() for x in leaves])


def _reference_dp(opt_kw, variant, *, warmup, fault, steps=2, gb=8):
    """The reference's make_dp_train_step on a one-device mesh, from the
    port's seed-0 params and batches: (losses, packed params, m leaves,
    v leaves, metrics)."""
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                              compute_dtype="float32")
    arena = opt_kw.get("arena", True)
    jkw = {k: v for k, v in opt_kw.items() if k != "arena"}
    opt = JaxOptimizerConfig(name="adama", accumulation="adama",
                             use_pallas=arena, arena=arena, **jkw)
    sched = jsched.warmup_cosine(1e-3, 1, steps + 1) if warmup else None
    mesh = make_mesh((1,), ("data",))
    step, init = jax_make_dp(cfg, opt, mesh, ("data",), variant,
                             lr_schedule=sched,
                             fault=jfaults.parse_fault(fault))
    params = jax.tree.map(jnp.asarray, _np_tree(init_tree(model_config())))
    layout = jarena.build_layout(params)
    losses, metrics = [], []
    with mesh:
        f = jax.jit(step)
        state = init(params)
        for b in batches(model_config(), gb, steps):
            params, state, m = f(params, state,
                                 {k: jnp.asarray(v.numpy())
                                  for k, v in b.items()})
            losses.append(float(m["loss"]))
            metrics.append({k: float(v) for k, v in m.items()})

    def moment(x):
        if isinstance(x, jarena.Arena):
            return [np.asarray(x.data)]
        return [np.asarray(a) for a in jax.tree.leaves(x)]
    return (losses, np.asarray(jarena.pack(params, layout)),
            moment(state["m"]), moment(state["v"]), metrics)


# the bucketed schedule and the stream against the single-device engines:
# name -> (the variant and engine, OptimizerConfig fields, fault), one
# step each, on a pair of each codec of each moment; the guarded ones skip
# micro-batch 1
BUCKETED = {}
for _m, _v in (("fp32", "fp32"), ("int8", "int8"), ("int8", "factored"),
               ("fp32", "rowcol"), ("int8", "rowcol")):
    for _label, _variant in (("bucketed", "adama"),
                             ("stream", "adama_layerwise")):
        BUCKETED[f"{_label}-{_m}-{_v}"] = (
            _variant, dict(m_codec=_m, state_codec=_v), None)
for _m, _v in (("fp32", "fp32"), ("int8", "rowcol")):
    for _label, _variant in (("bucketed", "adama"),
                             ("stream", "adama_layerwise")):
        BUCKETED[f"{_label}-{_m}-{_v}-guarded"] = (
            _variant, dict(m_codec=_m, state_codec=_v, finite_guard=True),
            "nan@micro=1,step=0")
# rowcol's column sums, added bucket by bucket (queue 3 (j))
COLSUM_REL = 1e-6


@pytest.mark.parametrize("case", sorted(BUCKETED))
def test_m1_bucketed_and_stream_equal_single_device(case, one_rank):
    variant, kw, fault = BUCKETED[case]
    kw = dict(kw, micro_batches=N_MICRO)
    want = run(dict(kw, accumulation=variant), fault=fault, steps=1)
    got = run(dict(kw, zero_stage=1), variant, fault=fault, steps=1)
    colsums = variant == "adama" and kw["state_codec"] == "rowcol"
    if colsums:
        assert got["losses"] == want["losses"]
        np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                                   atol=ENGINE_TOL)
    else:
        assert got["losses"] == want["losses"]
        assert np.array_equal(got["params"], want["params"])
    for k in ("m", "v"):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if colsums and a.shape[0] == 1:
                rel = np.abs(a - b).max() / np.abs(b).max()
                assert rel <= COLSUM_REL, rel
            else:
                assert np.array_equal(a, b), k
    assert got["step"] == want["step"] == 1
    assert got.get("scaler") == want.get("scaler")
    if fault:
        assert got["scaler"]["skipped"] == 1
    layout = tarena.build_layout(init_tree(model_config()))
    plan = zero1_bucket_plan(layout, 1)
    assert got["collectives"]["reduce_scatter"][0] == \
        N_MICRO * len(plan.grad_buckets())
    assert got["collectives"]["all_gather"][0] == 1


# name -> (variant, OptimizerConfig fields, warmup schedule, fault). A
# guarded case skips micro-batch 1 of step 2: a step that folds a single
# micro-batch is ill-conditioned across frameworks, as ga's first step is
# (queue 3 (f))
REFERENCE = {
    "ga": ("ga", {}, True, None),
    "naive": ("naive", {}, False, None),
    "adama": ("adama", {}, False, None),
    "adama-per-leaf": ("adama", dict(arena=False), False, None),
    "adama-guarded": ("adama", dict(finite_guard=True), False,
                      "nan@micro=1,step=1"),
    "zero1": ("adama", ZERO1, False, None),
    "zero1-guarded": ("adama", dict(ZERO1, finite_guard=True), False,
                      "nan@micro=1,step=1"),
}


@pytest.mark.parametrize("case", sorted(REFERENCE))
def test_m1_variants_match_reference_dp_engine(case, one_rank):
    variant, kw, warmup, fault = REFERENCE[case]
    kw = dict(kw, micro_batches=N_MICRO)
    losses, params, m, v, metrics = _reference_dp(kw, variant, warmup=warmup,
                                                  fault=fault)
    got = run(kw, variant, warmup=warmup, fault=fault)
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["params"], params, rtol=0,
                               atol=ENGINE_TOL)
    for name, want in (("m", m), ("v", v)):
        assert len(got[name]) == len(want), name
        for a, b in zip(got[name], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=ENGINE_TOL)
    if fault:
        assert [x["skipped_micro_batches"] for x in got["metrics"]] == \
            [x["skipped_micro_batches"] for x in metrics]


# the bf16 wire and master params, alone and together, through every
# schedule: name -> (variant, OptimizerConfig fields, fault); two steps
# each (the second runs on the leaves the first's master apply wrote),
# the guarded ones with dynamic scaling and a NaN in micro-batch 1 of
# step 1, which backs the scale off once
SCHEDULES = (("replicated", "adama", {}), ("full", "adama", ZERO1),
             ("bucketed", "adama", dict(zero_stage=1)),
             ("stream", "adama_layerwise", dict(zero_stage=1)))
WIRE_MASTER = {}
for _label, _variant, _kw in SCHEDULES:
    for _name, _extra in WIRES:
        WIRE_MASTER[f"{_label}-{_name}"] = (_variant, dict(_kw, **_extra),
                                            None)
    WIRE_MASTER[f"{_label}-bf16-master-guarded"] = (
        _variant, dict(_kw, **GUARDED_BF16_MASTER), "nan@micro=1,step=0")


@pytest.mark.parametrize("case", sorted(WIRE_MASTER))
def test_m1_bf16_wire_and_master_equal_single_device(case, one_rank):
    """Bit for bit the single-device engine with the same grad_dtype and
    master_params: params, master, every state column, losses, scaler.
    Each gradient reduce-scatter moves the wire's bytes (bf16: 2 B an
    element) and the param all-gather the master's bf16 working rows
    (half the fp32 gather's bytes); the leaves are bf16 of the master."""
    variant, kw, fault = WIRE_MASTER[case]
    kw = dict(kw, micro_batches=N_MICRO)
    single = {k: v for k, v in kw.items()
              if k not in ("zero_stage", "zero_bucketed")}
    want = run(dict(single, accumulation=variant), fault=fault)
    got = run(kw, variant, fault=fault)
    assert got["losses"] == want["losses"]
    assert np.array_equal(got["params"], want["params"])
    for k in ("m", "v"):
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got[k], want[k])), k
    assert got.get("scaler") == want.get("scaler")
    if fault:
        assert got["scaler"]["skipped"] == 1
        assert got["scaler"]["scale"] == 2.0 ** 14
    master = kw.get("master_params", False)
    assert ("p" in got) == master
    if master:
        assert got["p"].dtype == np.float32
        assert np.array_equal(got["p"], want["p"])
        assert got["work_is_bf16_master"]
    rs, ag = got["collectives"]["reduce_scatter"], \
        got["collectives"]["all_gather"]
    if not kw.get("zero_stage"):
        assert rs == ag == (0, 0)
        return
    layout = tarena.build_layout(init_tree(model_config()))
    rows = (sum(b.rows for b in zero1_bucket_plan(layout, 1).grad_buckets())
            if kw.get("zero_bucketed", True) else layout.rows)
    wire = 2 if kw.get("grad_dtype") == "bf16" else 4
    assert rs == (rs[0], 2 * N_MICRO * rows * tarena.LANES * wire)
    assert ag == (2, 2 * layout.rows * tarena.LANES * (2 if master else 4))


# (OptimizerConfig fields, variant, a tp group?, the ROADMAP item named)
REFUSED = [
    (dict(zero_stage=1, zero_async=True), "adama", False, "10.3"),
    (dict(grad_dtype="fp8_e4m3", finite_guard=True, **ZERO1), "adama", False,
     "10.3"),
    ({}, "adama", True, "10.4"),
]


@pytest.mark.parametrize("kw, variant, tp, item", REFUSED)
def test_unported_combinations_name_their_item(kw, variant, tp, item,
                                               one_rank):
    with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
        make_dp_train_step(model_config(), OptimizerConfig(**kw), None,
                           variant, tp_group=object() if tp else None)


def test_reference_refusals_keep_their_messages(one_rank):
    cfg = model_config()
    cases = [
        (dict(master_params=True, work_param_cache=True), "adama",
         "work_param_cache=True is a pjit-engine knob"),
        (dict(finite_guard=True), "ga", "finite_guard=True in the "
                                        "shard_map DP engine"),
        (dict(zero_stage=1, zero_bucketed=False, arena=False), "adama",
         "requires the arena"),
        (dict(zero_stage=1, zero_bucketed=False), "naive",
         "defined for the 'adama'"),
        (dict(m_codec="int8"), "adama", "requires zero_stage=1"),
        ({}, "adama_layerwise", "IS the bucketed ZeRO-1 stream"),
        ({}, "sgd", "unknown DP variant"),
    ]
    for kw, variant, msg in cases:
        with pytest.raises(ValueError, match=msg):
            make_dp_train_step(cfg, OptimizerConfig(**kw), None, variant)



# a DP run's checkpoints at M = 1: name -> (variant, OptimizerConfig fields)
CHECKPOINTED = {
    "full-bf16-master": ("adama", dict(ZERO1, grad_dtype="bf16",
                                       master_params=True)),
    "stream-bf16-master-guarded": ("adama_layerwise", dict(
        zero_stage=1, grad_dtype="bf16", master_params=True,
        finite_guard=True, loss_scale="dynamic")),
}


@pytest.mark.parametrize("case", sorted(CHECKPOINTED))
def test_m1_dp_run_resumes_bit_for_bit_and_saves_one_devices_bytes(
        case, one_rank, tmp_path):
    """train() over the one-rank group, crashed after step 2's update and
    resumed from step 1, equals the run that never stopped bit for bit;
    every step it saved is the single-device run's checkpoint, array for
    array (canonical rows whatever the schedule)."""
    variant, kw = CHECKPOINTED[case]
    kw = dict(kw, micro_batches=N_MICRO)
    out = run_checkpointed(kw, variant, tmp_path / "dp",
                           group=dist.group.WORLD)
    assert out["crashed"]
    clean, resumed = out["clean"], out["resumed"]
    assert resumed["losses"] == clean["losses"][1:]
    assert np.array_equal(resumed["params"], clean["params"])
    for k in ("m", "v"):
        assert all(np.array_equal(a, b)
                   for a, b in zip(resumed[k], clean[k])), k
    assert resumed.get("scaler") == clean.get("scaler")
    if "p" in clean:
        assert np.array_equal(resumed["p"], clean["p"])
    single = {k: v for k, v in kw.items()
              if k not in ("zero_stage", "zero_bucketed")}
    run_cfg = RunConfig(model=model_config(), seq_len=SEQ, global_batch=8,
                        steps=2, optimizer=OptimizerConfig(
                            accumulation=variant, **single),
                        checkpoint_dir=str(tmp_path / "one"),
                        checkpoint_every=1)
    train(run_cfg, device="cpu", log_fn=lambda _: None)
    for step in (1, 2):
        a = np.load(tmp_path / f"dp/clean/step_{step:08d}/arrays.npz")
        b = np.load(tmp_path / f"one/step_{step:08d}/arrays.npz")
        assert a.files == b.files
        assert all(np.array_equal(a[f], b[f]) for f in a.files), step
