"""The port's checkpoints (`repro_torch.train.checkpoint`) against the
reference's (`repro.train.checkpoint`; its own tests are
tests/test_checkpoint_data.py, test_resilience.py, test_mixed_precision.py,
test_fp8_wire.py, test_state_store.py and test_codec_conformance.py), on
the CPU at reduced stablelm-1.6b:

  - a checkpoint the reference writes after 2 steps of its engine (all 8
    codec pairs, per-leaf adama, and guarded fp8 int8/rowcol with master
    params, the cache and dynamic loss scaling) restores into the port
    bit for bit, and one more step on each side agrees within the engine
    tests' tolerances;
  - a checkpoint the port writes restores into the reference bit for bit,
    and its structure.json is the reference's in every key the reference
    writes but `treedef` (null in the port's);
  - a port run killed by `crash@step=1` between an update and its save
    resumes bit for bit the run that never stopped (ga, adama,
    adama_layerwise, guarded fp8 int8/rowcol with master params and the
    cache, per-leaf adama), with the same kernel calls per step;
  - refusals: every cross-pair restore on both sides, a missing or stale
    "ef", `elastic` / `bucket_plan` and a layout padded for ZeRO-1 (ROADMAP
    item 10);
  - damage (bit flip, trailer, truncation) raises CheckpointCorruptError
    before anything is copied, and the port's damage helpers write what the
    reference's do, byte for byte;
  - retention, a failed save leaving nothing behind, export_working_params
    and the CLI.
"""
import dataclasses
import json
import shutil

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
from repro.train import checkpoint as jckpt
from repro.train import faults as jfaults
from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
from repro_torch.core import adama as tadama
from repro_torch.core import arena as tarena
from repro_torch.core import state_store as tss
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fp8_wire as tfw
from repro_torch.kernels import fused_step as tfs
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import faults as tfaults
from repro_torch.train.loop import train
from test_torch_codecs import LOSS_TOL, LR, PAIRS, _assert_params_close
from test_torch_engines import ENGINE_TOL
from test_torch_fp8_wire import FP8_CODE_FLIP_FRAC
from test_torch_guard import ARCH, GLOBAL_BATCH, N_MICRO, SEQ, _init_params
from test_torch_master import _bf16_ulp

torch.set_num_threads(1)

SAVED = 2                       # steps before the checkpoint
FP8_SET = dict(m_codec="int8", state_codec="rowcol", grad_dtype="fp8_e4m3",
               finite_guard=True, loss_scale="dynamic", master_params=True,
               work_param_cache=True)
# name -> the OptimizerConfig fields both sides share (engine adama)
CONFIGS = {**{f"{m}-{v}": dict(m_codec=m, state_codec=v) for m, v in PAIRS},
           "per-leaf": dict(arena=False), "fp8-master-cache": FP8_SET}


def _batches(n):
    data = make_data(get_config(ARCH).reduced(), SEQ, GLOBAL_BATCH, seed=5)
    return [data.batch(i) for i in range(n)]


def _jax_opt(engine="adama", **kw):
    kw = dict(kw)
    arena = kw.pop("arena", True)
    return JaxOptimizerConfig(name="adama", accumulation=engine,
                              micro_batches=N_MICRO, use_pallas=True,
                              arena=arena, **kw)


def _port_opt(engine="adama", **kw):
    return OptimizerConfig(accumulation=engine, micro_batches=N_MICRO, **kw)


def _port_cfg():
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32")


def _port_tree():
    return tmodel.Model(_port_cfg(), tmodel.params_from_jax(
        _init_params(), "cpu")).tree()


def _ref_bytes(x):
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _port_bytes(x):
    if isinstance(x, int):
        return np.int32(x).tobytes()
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.contiguous().numpy().tobytes()


def _assert_leaves_equal(port_tree, ref_tree, label):
    """Every leaf of the two trees (or of a list of the port's leaves), in
    the reference's flatten order: the same shape, dtype and bytes."""
    got = (port_tree if isinstance(port_tree, list)
           else tckpt.tree_leaves(port_tree))
    want = jax.tree.leaves(ref_tree)
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        shape = () if isinstance(a, int) else tuple(a.shape)
        name = "int32" if isinstance(a, int) else \
            str(a.dtype).replace("torch.", "")
        assert (shape, name) == (b.shape, str(b.dtype)), (label, i)
        assert _port_bytes(a) == _ref_bytes(b), (label, i)


def _flat_params(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


# ---------------------------------------------------------------------------
# The reference's checkpoint into the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """name -> the reference's run: its checkpoint directory (step SAVED),
    and after one more step its loss, params and state."""
    cache = {}

    def get(name):
        if name not in cache:
            step, init = jax_make_train_step(tiny(ARCH),
                                             _jax_opt(**CONFIGS[name]))
            step = jax.jit(step)
            params = jax.tree.map(jnp.asarray, _init_params())
            state = init(params)
            batches = [{k: jnp.asarray(v) for k, v in b.items()}
                       for b in _batches(SAVED + 1)]
            for b in batches[:SAVED]:
                params, state, _ = step(params, state, b)
            d = tmp_path_factory.mktemp(f"ref-{name}")
            jckpt.save(str(d), SAVED, {"params": params, "opt": state})
            params, state, mx = step(params, state, batches[SAVED])
            cache[name] = dict(dir=d, loss=float(mx["loss"]),
                               params=_flat_params(jax.tree.leaves(params)),
                               state=state)
        return cache[name]
    return get


def _port_step_after_restore(name, d):
    """The port restores the reference's step-SAVED checkpoint into a fresh
    tree and state (their bytes kept as restored), then takes step
    SAVED + 1."""
    tree = _port_tree()
    step, init = make_train_step(_port_cfg(), _port_opt(**CONFIGS[name]))
    state = init(tree)
    restored = tckpt.restore(d, SAVED, {"params": tree, "opt": state})
    assert restored["params"]["embed"] is tree["embed"]    # in place
    leaves = [(x if isinstance(x, int) else x.detach().clone())
              for x in tckpt.tree_leaves(restored)]
    state = restored["opt"]
    assert state["step"] == SAVED and isinstance(state["step"], int)
    batch = _batches(SAVED + 1)[SAVED]
    tree, state, mx = step(
        tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return leaves, tree, state, mx


# One step from the same restored state, the two sides differ by their
# models' float32 roundings only. Measured (step 3 after the reference's
# step-2 checkpoint): fp32/fp32 and per-leaf every param within 3.5e-7 and
# 8.2e-8, losses within 4.8e-7; int8/int8 and int8/rowcol 0.16% and 0.19%
# of the params beyond ENGINE_TOL (int8 m's code flips), largest 8.3e-5;
# the fp8 set's master 0.058% beyond, largest 2.0e-4, its bf16 leaves
# 0.040%, largest 4.9e-4 (one bf16 ulp at 0.1).
def _fp8_master_close(got, want, label, ulps=0):
    """The fp8 set's master (ulps=0) or bf16 leaves (ulps=1) one step after
    identical states: e4m3 and int8-m flips (queue 3 (p)) on at most
    FP8_CODE_FLIP_FRAC of the elements beyond ENGINE_TOL, none beyond
    ENGINE_TOL + the pair's (drift_lr + fp8_wire_lr) x lr (+ one bf16 ulp
    on a leaf, queue 3 (m))."""
    confs = [tss.get_codec("int8", "m").conformance,
             tss.get_codec("rowcol", "v").conformance]
    bound = ENGINE_TOL + sum((c.drift_lr or 0.0) + c.fp8_wire_lr
                             for c in confs) * LR
    d = np.abs(got - want)
    assert float((d > ENGINE_TOL).mean()) <= FP8_CODE_FLIP_FRAC, label
    slack = bound + ulps * _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (d <= slack).all(), (label, float(d.max()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_checkpoint_restores_into_the_port(name, reference_runs):
    """Every leaf of the reference's checkpoint lands in the port's tree
    bit for bit (step a host int again), and one more step from it on each
    side agrees: the loss (the same params on both sides) within LOSS_TOL,
    the params as the engine tests hold them (fp32/fp32 and per-leaf
    within ENGINE_TOL; the codec pairs by `_assert_params_close`; the fp8
    set's master and leaves by `_fp8_master_close`), the counters exactly."""
    ref = reference_runs(name)
    j_params = jax.tree.map(jnp.asarray, _init_params())
    _, init = jax_make_train_step(tiny(ARCH), _jax_opt(**CONFIGS[name]))
    want = jckpt.restore(str(ref["dir"]), SAVED, jax.eval_shape(
        lambda: {"params": j_params, "opt": init(j_params)}))
    leaves, tree, state, mx = _port_step_after_restore(name, ref["dir"])
    _assert_leaves_equal(leaves, want, name)
    assert state["step"] == int(ref["state"]["step"]) == SAVED + 1
    np.testing.assert_allclose(float(mx["loss"]), ref["loss"], rtol=0,
                               atol=LOSS_TOL)
    with torch.no_grad():
        got = _flat_params([x.numpy() for x in
                            tarena.tree_flatten(tree)[0]])
    kw = CONFIGS[name]
    if name == "fp8-master-cache":
        for k in ("skipped_micro_batches", "loss_scale", "consec_skips"):
            assert float(mx[k]) == float(ref["state"]["scaler"][
                {"skipped_micro_batches": "skipped", "loss_scale": "scale",
                 "consec_skips": "consec"}[k]]), k
        _fp8_master_close(state["p"].data.numpy(),
                          np.asarray(ref["state"]["p"].data), name)
        _fp8_master_close(got, ref["params"], name, ulps=1)
    elif name in ("fp32-fp32", "per-leaf"):
        np.testing.assert_allclose(got, ref["params"], rtol=0,
                                   atol=ENGINE_TOL)
    else:
        _assert_params_close(got, ref["params"], kw["m_codec"],
                             kw["state_codec"], name)


# ---------------------------------------------------------------------------
# The port's checkpoint into the reference
# ---------------------------------------------------------------------------


def _port_run(opt, steps, fault=None, tree=None):
    """The port's run from the reference's params: (tree, state, metrics)."""
    tree = _port_tree() if tree is None else tree
    step, init = make_train_step(_port_cfg(), opt,
                                 fault=tfaults.parse_fault(fault))
    state = init(tree)
    mx = {}
    for b in _batches(steps):
        tree, state, mx = step(
            tree, state, {k: torch.from_numpy(v) for k, v in b.items()})
    return tree, state, mx


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_checkpoint_restores_into_the_reference(name, tmp_path):
    """After 2 port steps: the reference's restore onto its eval_shape tree
    gives the port's leaves bit for bit, and the reference's save of that
    tree writes the port's structure.json in every key it writes, but
    `treedef`, which the port leaves null."""
    tree, state, _ = _port_run(_port_opt(**CONFIGS[name]), SAVED)
    full = {"params": tree, "opt": state}
    tckpt.save(tmp_path / "port", SAVED, full)
    j_params = jax.tree.map(jnp.asarray, _init_params())
    _, init = jax_make_train_step(tiny(ARCH), _jax_opt(**CONFIGS[name]))
    got = jckpt.restore(str(tmp_path / "port"), SAVED, jax.eval_shape(
        lambda: {"params": j_params, "opt": init(j_params)}))
    _assert_leaves_equal(full, got, name)
    jckpt.save(str(tmp_path / "ref"), SAVED, got)
    ours = json.loads((tmp_path / "port" / "step_00000002" /
                       "structure.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "step_00000002" /
                         "structure.json").read_text())
    assert ours.pop("treedef") is None and isinstance(theirs.pop("treedef"),
                                                      str)
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"paths", "codecs"}
    if name != "per-leaf":
        assert ours["codecs"] == {"opt/m": CONFIGS[name]["m_codec"],
                                  "opt/v": CONFIGS[name]["state_codec"]}


def _generic_tree(step_as_int):
    """tests/test_checkpoint_data.py's tree: fp32, bf16 and an int32 step
    (a host int in the port's own state)."""
    return {"params": {"w": torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4),
                       "b": torch.ones(5, dtype=torch.bfloat16)},
            "opt": {"m": torch.zeros(3, 4),
                    "step": 7 if step_as_int else torch.tensor(
                        7, dtype=torch.int32)}}


def test_generic_tree_round_trips_both_ways(tmp_path):
    """The reference's round-trip tree, written by either side, restores
    into the other with its dtypes (bf16 kept, the step an int32 leaf
    there and a host int here); a 0-d int32 tensor takes the int's place
    on disk."""
    tree = _generic_tree(True)
    tckpt.save(tmp_path / "p", 10, tree)
    assert tckpt.latest_step(tmp_path / "p") == 10
    target = {"params": {"w": torch.zeros(3, 4),
                         "b": torch.zeros(5, dtype=torch.bfloat16)},
              "opt": {"m": torch.ones(3, 4), "step": 0}}
    out = tckpt.restore(tmp_path / "p", 10, target)
    assert out["opt"]["step"] == 7 and target["opt"]["step"] == 0
    assert out["params"]["b"] is target["params"]["b"]
    for a, b in zip(tckpt.tree_leaves(out), tckpt.tree_leaves(tree)):
        assert _port_bytes(a) == _port_bytes(b)
    jtree = {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                        "b": jnp.ones((5,), jnp.bfloat16)},
             "opt": {"m": jnp.zeros((3, 4)),
                     "step": jnp.asarray(7, jnp.int32)}}
    got = jckpt.restore(str(tmp_path / "p"), 10,
                        jax.eval_shape(lambda: jtree))
    _assert_leaves_equal(tree, got, "port -> reference")
    jckpt.save(str(tmp_path / "j"), 10, jtree)
    out = tckpt.restore(tmp_path / "j", 10, _generic_tree(False))
    _assert_leaves_equal(out, jtree, "reference -> port")
    tckpt.save(tmp_path / "t", 1, _generic_tree(False))
    out = tckpt.restore(tmp_path / "t", 1, _generic_tree(True))
    assert out["opt"]["step"] == 7 and isinstance(out["opt"]["step"], int)


# ---------------------------------------------------------------------------
# Crash and resume, bit for bit
# ---------------------------------------------------------------------------

RESUME = {
    "ga": dict(engine="ga"),
    "adama": dict(engine="adama"),
    "adama_layerwise": dict(engine="adama_layerwise"),
    "per-leaf-adama": dict(engine="adama", arena=False),
    "fp8-master-cache-layerwise": dict(engine="adama_layerwise", **FP8_SET),
}
COUNTED = ((tfs, "arena_fold"), (tfs, "arena_fold_slice"),
           (tfs, "arena_apply"), (tfs, "finite_and"), (tfw, "fp8_encode"),
           (tfw, "fp8_ef_update"))


def _counting(monkeypatch):
    """Count the kernel wrappers' calls (their launch counters move only
    on the card)."""
    calls = {}
    for mod, name in COUNTED:
        def wrapper(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    return calls


def _resume_run(case, calls, steps=3, fault=None, **ckpt):
    """train() on reduced stablelm-1.6b: (result, calls per step index)."""
    kw = dict(RESUME[case])
    run = RunConfig(model=_port_cfg(),
                    optimizer=_port_opt(kw.pop("engine"), **kw),
                    seq_len=SEQ, global_batch=GLOBAL_BATCH, seed=0,
                    steps=steps, log_every=1, inject_fault=fault, **ckpt)
    per_step, seen = {}, {}

    def after(i):
        class Ctx:
            def __enter__(self):
                seen.update(calls)

            def __exit__(self, *exc):
                per_step[i] = {k: calls.get(k, 0) - seen.get(k, 0)
                               for k in calls}
        return Ctx()
    logs = []
    out = train(run, device="cpu", log_fn=logs.append, step_context=after)
    return out, per_step, logs


@pytest.mark.parametrize("case", sorted(RESUME))
def test_crash_between_update_and_save_resumes_bitwise(case, tmp_path,
                                                       monkeypatch):
    """crash@step=1 kills the run after step 2's update and before its
    save, so step 1's checkpoint is the newest; a second train() on the
    same directory restores it, runs steps 2-3 with the clean run's losses
    and kernel calls per step, and ends on every leaf of the clean run's
    params and state bit for bit (the fp8 set with a NaN at micro-batch 1
    of step 3 in both: the scaler and the residual carried over)."""
    calls = _counting(monkeypatch)
    nan = "nan@micro=1,step=2" if case.startswith("fp8") else None
    clean, clean_calls, _ = _resume_run(case, calls, fault=nan)
    d = tmp_path / "ckpt"
    with pytest.raises(tfaults.InjectedCrash, match="before its save"):
        _resume_run(case, calls, fault="crash@step=1", checkpoint_dir=str(d),
                    checkpoint_every=1, keep_last_n=1)
    assert tckpt.latest_step(d) == 1
    assert sorted(p.name for p in d.iterdir()) == ["step_00000001"]
    out, out_calls, logs = _resume_run(case, calls, fault=nan,
                                       checkpoint_dir=str(d),
                                       checkpoint_every=1, keep_last_n=1)
    assert logs[0] == "[train] restored step 1"
    assert out["losses"] == clean["losses"][1:]
    assert out_calls == {i: clean_calls[i] for i in (1, 2)}
    assert out["opt_state"]["step"] == clean["opt_state"]["step"] == 3
    a = {"params": out["params"], "opt": out["opt_state"]}
    b = {"params": clean["params"], "opt": clean["opt_state"]}
    la, lb = tckpt.tree_leaves(a), tckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert _port_bytes(x) == _port_bytes(y), (case, i)
    if nan:
        assert clean["metrics"]["loss_scale"] == 2.0 ** 14
        assert out["metrics"]["skipped_micro_batches"] == 1
    assert tckpt.latest_step(d) == 3


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _signature(state):
    return [(tuple(x.shape), str(x.dtype)) for x in
            tckpt.tree_leaves(state) if not isinstance(x, int)]


def test_leaf_signatures_tell_the_pairs_apart():
    """Without the reference's treedef string, the port tells a reference
    checkpoint's codec pair by its leaves: the 8 pairs' (shape, dtype)
    signatures differ, and so do their shapes alone (the reference's own
    check on a port checkpoint)."""
    tree = _port_tree()
    sigs = {pr: _signature(tadama.init_arena(tree, codec=pr[1],
                                             m_codec=pr[0]))
            for pr in PAIRS}
    assert len({tuple(s) for s in sigs.values()}) == len(PAIRS) == 8
    assert len({tuple(sh for sh, _ in s) for s in sigs.values()}) == 8


def _j_state(pair):
    return jadama.init_arena(jax.tree.map(jnp.asarray, _init_params()),
                             codec=pair[1], m_codec=pair[0])


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_cross_pair_restore_is_refused_on_both_sides(pair, tmp_path):
    """A checkpoint of one pair, written by either side, refuses to restore
    into each of the 7 other pairs' states in the port; the reference
    refuses the port's likewise. Every refusal is a ValueError naming a
    mismatch (leaf count, shape or dtype), raised before anything is
    copied."""
    tree = _port_tree()
    j_params = jax.tree.map(jnp.asarray, _init_params())
    tckpt.save(tmp_path / "port", 1, {"params": tree, "opt": tadama.init_arena(
        tree, codec=pair[1], m_codec=pair[0])})
    jckpt.save(str(tmp_path / "ref"), 1, {"params": j_params,
                                          "opt": _j_state(pair)})
    for other in PAIRS:
        if other == pair:
            continue
        target = {"params": tree, "opt": tadama.init_arena(
            tree, codec=other[1], m_codec=other[0])}
        before = [_port_bytes(x) for x in tckpt.tree_leaves(target)]
        for writer in ("port", "ref"):
            with pytest.raises(ValueError, match="mismatch"):
                tckpt.restore(tmp_path / writer, 1, target)
        assert [_port_bytes(x) for x in tckpt.tree_leaves(target)] == before
        jt = {"params": j_params, "opt": _j_state(other)}
        with pytest.raises(ValueError, match="mismatch"):
            jckpt.restore(str(tmp_path / "port"), 1,
                          jax.eval_shape(lambda t=jt: t))
    # and each restores into its own pair
    target = {"params": _port_tree(), "opt": tadama.init_arena(
        tree, codec=pair[1], m_codec=pair[0])}
    tckpt.restore(tmp_path / "ref", 1, target)


def _ef_trees():
    tree = _port_tree()
    return (tadama.init_arena(tree, error_feedback=True),
            tadama.init_arena(tree))


def test_missing_or_stale_ef_region_is_refused(tmp_path):
    """An fp8 + error-feedback state refuses a checkpoint written without
    "ef", and the reverse, with the reference's message naming the region,
    for checkpoints of either writer."""
    st_ef, st_no = _ef_trees()
    tckpt.save(tmp_path / "noef", 1, st_no)
    tckpt.save(tmp_path / "ef", 1, st_ef)
    j_params = jax.tree.map(jnp.asarray, _init_params())
    jckpt.save(str(tmp_path / "jnoef"), 1, jadama.init_arena(j_params))
    jckpt.save(str(tmp_path / "jef"), 1,
               jadama.init_arena(j_params, error_feedback=True))
    msgs = []
    for d in ("noef", "jnoef"):
        with pytest.raises(ValueError, match=r"lacks region.*'ef'") as e:
            tckpt.restore(tmp_path / d, 1, st_ef)
        msgs.append(str(e.value))
    for d in ("ef", "jef"):
        with pytest.raises(ValueError, match=r"stale region.*'ef'"):
            tckpt.restore(tmp_path / d, 1, st_no)
    with pytest.raises(ValueError) as e:
        jckpt.restore(str(tmp_path / "jnoef"), 1, jax.eval_shape(
            lambda: jadama.init_arena(j_params, error_feedback=True)))
    assert msgs == [str(e.value)] * 2
    tckpt.restore(tmp_path / "jef", 1, st_ef)


def test_elastic_bucket_plan_and_zero_layouts_wait_for_item_10(tmp_path):
    """elastic=True and bucket_plan= raise NotImplementedError citing
    ROADMAP item 10, as does a reference checkpoint of a layout padded for
    4 shards (ZeRO-1) restored into the port's one-device layout."""
    st, _ = _ef_trees()
    tckpt.save(tmp_path, 1, st)
    for kw in (dict(elastic=True), dict(bucket_plan=object())):
        with pytest.raises(NotImplementedError, match="item 10"):
            tckpt.restore(tmp_path, 1, st, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        tckpt.save(tmp_path, 2, st, bucket_plan=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        tckpt.export_working_params(tmp_path, 1, st, elastic=True)
    vals = {"blocks": {"w": np.arange(4 * 96 * 33, dtype=np.float32)
                       .reshape(4, 96, 33)},
            "head": np.arange(1000, dtype=np.float32)}
    jvals = jax.tree.map(jnp.asarray, vals)
    tvals = tmodel.params_from_jax(vals, "cpu")
    lay1 = tarena.build_layout(tvals)
    target = {"m": tarena.Arena.zeros(lay1, "cpu"), "step": 0}
    for n_shards in (1, 4):
        lay = jarena.build_layout(jvals, n_shards=n_shards)
        assert (lay.rows == lay1.rows) == (n_shards == 1)
        jckpt.save(str(tmp_path / f"zero{n_shards}"), 3, {
            "m": jarena.Arena(jarena.pack(jvals, lay), lay),
            "step": jnp.asarray(3, jnp.int32)})
    with pytest.raises(NotImplementedError, match="another shard count.*"
                                                  "item 10"):
        tckpt.restore(tmp_path / "zero4", 3, target)
    out = tckpt.restore(tmp_path / "zero1", 3, target)
    assert out["step"] == 3 and torch.equal(out["m"].data,
                                            tarena.pack(tvals, lay1))


def test_shape_and_layout_mismatches_are_refused(tmp_path):
    """The reference's shape message; a dtype the reference would not see
    (an fp32 target for a bf16 leaf); an Arena of another model's layout;
    a leaf path the checkpoint does not hold."""
    tckpt.save(tmp_path, 1, _generic_tree(True))
    bad = _generic_tree(True)
    bad["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape mismatch at leaf 3"):
        tckpt.restore(tmp_path, 1, bad)
    bad = _generic_tree(True)
    bad["params"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="dtype mismatch at leaf 2 "
                                         r"\(params/b\): checkpoint bfloat16"):
        tckpt.restore(tmp_path, 1, bad)
    bad = _generic_tree(True)
    bad["params"] = {"w": bad["params"]["w"], "c": bad["params"]["b"]}
    with pytest.raises(ValueError, match="structure mismatch.*'params/b'"):
        tckpt.restore(tmp_path, 1, bad)
    a = {"blocks": {"w": torch.zeros(2, 3000)}, "head": torch.zeros(70000)}
    b = {"blocks": {"w": torch.zeros(3, 3000)}, "head": torch.zeros(5000)}
    la, lb = tarena.build_layout(a), tarena.build_layout(b)
    assert la.rows == lb.rows
    tckpt.save(tmp_path / "a", 1, {"m": tarena.Arena.zeros(la, "cpu")})
    with pytest.raises(ValueError, match="arena layout mismatch.*stack "
                                         "'blocks'"):
        tckpt.restore(tmp_path / "a", 1,
                      {"m": tarena.Arena.zeros(lb, "cpu")})


# ---------------------------------------------------------------------------
# Damage
# ---------------------------------------------------------------------------


def _damage_tree():
    """tests/test_resilience.py's tree."""
    return {"w": torch.arange(4096, dtype=torch.float32).reshape(4, 1024),
            "b": torch.ones(8, dtype=torch.bfloat16), "step": 7}


def _zeroed(tree):
    return {"w": torch.zeros_like(tree["w"]),
            "b": torch.zeros_like(tree["b"]), "step": 0}


DAMAGE = {"bit flip mid-file": ("corrupt", "mid", "arrays.npz"),
          "trailer bit flip": ("corrupt", None, "arrays.npz"),
          "truncation": ("truncate", None, "truncated or ")}


@pytest.mark.parametrize("case", sorted(DAMAGE))
def test_damaged_checkpoint_is_refused_before_any_copy(case, tmp_path):
    """Each damage raises CheckpointCorruptError naming arrays.npz (a
    truncation as 'truncated or damaged'), and the target keeps every
    byte: the checks come before any copy. The reference refuses the
    damaged port checkpoint alike."""
    kind, where, match = DAMAGE[case]
    tree = _damage_tree()
    tckpt.save(tmp_path, 3, tree)
    path = tmp_path / "step_00000003" / "arrays.npz"
    if kind == "corrupt":
        kw = {"offset": path.stat().st_size // 2} if where else {}
        assert tfaults.corrupt_checkpoint_array(tmp_path, 3, **kw) == \
            str(path)
    else:
        tfaults.truncate_checkpoint(tmp_path, 3)
    target = _zeroed(tree)
    before = [_port_bytes(x) for x in tckpt.tree_leaves(target)]
    with pytest.raises(tckpt.CheckpointCorruptError, match=match):
        tckpt.restore(tmp_path, 3, target)
    assert [_port_bytes(x) for x in tckpt.tree_leaves(target)] == before
    jtree = {"w": jnp.zeros((4, 1024)), "b": jnp.zeros((8,), jnp.bfloat16),
             "step": jnp.asarray(0, jnp.int32)}
    with pytest.raises(jckpt.CheckpointCorruptError, match=match):
        jckpt.restore(str(tmp_path), 3, jax.eval_shape(lambda: jtree))


def test_checksum_mismatch_and_unreadable_metadata(tmp_path):
    """A flipped bit inside the array data past zip's own check reaches the
    crc32 check; a damaged structure.json is unreadable metadata."""
    tree = _damage_tree()
    tckpt.save(tmp_path, 1, tree)
    d = tmp_path / "step_00000001"
    info = json.loads((d / "structure.json").read_text())
    info["meta"][2]["crc32"] ^= 1
    (d / "structure.json").write_text(json.dumps(info))
    with pytest.raises(tckpt.CheckpointCorruptError,
                       match="checksum mismatch on array a2"):
        tckpt.restore(tmp_path, 1, _zeroed(tree))
    (d / "structure.json").write_bytes(b"\xff{")
    with pytest.raises(tckpt.CheckpointCorruptError,
                       match="unreadable metadata"):
        tckpt.restore(tmp_path, 1, _zeroed(tree))


@pytest.mark.parametrize("helper,kw", [
    ("corrupt_checkpoint_array", {}), ("corrupt_checkpoint_array",
                                       {"offset": 1000}),
    ("truncate_checkpoint", {}), ("truncate_checkpoint",
                                  {"keep_bytes": 10 ** 9})])
def test_damage_helpers_write_what_the_reference_helpers_write(helper, kw,
                                                               tmp_path):
    """The port's helper and the reference's, each on its own copy of one
    checkpoint, leave byte-equal files; a second flip at the same offset
    restores the file."""
    tckpt.save(tmp_path / "src", 1, _damage_tree())
    for side in ("port", "ref"):
        shutil.copytree(tmp_path / "src", tmp_path / side)
    out = getattr(tfaults, helper)(tmp_path / "port", 1, **kw)
    getattr(jfaults, helper)(tmp_path / "ref", 1, **kw)
    name = "step_00000001/arrays.npz"
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "ref" / name).read_bytes()
    assert out == str(tmp_path / "port" / name)
    if helper == "corrupt_checkpoint_array":
        assert got != (tmp_path / "src" / name).read_bytes()
        tfaults.corrupt_checkpoint_array(tmp_path / "port", 1, **kw)
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "src" / name).read_bytes()


# ---------------------------------------------------------------------------
# Disk handling
# ---------------------------------------------------------------------------


def test_retention_keeps_the_newest_steps(tmp_path):
    for s in (1, 2, 3, 4, 5):
        tckpt.save(tmp_path, s, _damage_tree(), keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]
    assert tckpt.latest_step(tmp_path) == 5
    assert tckpt.latest_step(tmp_path / "absent") is None


@pytest.mark.parametrize("where", ["savez", "fsync"])
def test_a_save_that_raises_midway_leaves_nothing(where, tmp_path,
                                                  monkeypatch):
    """A save that fails while writing the archive, or before its rename
    (the data's fsync), leaves neither a step directory nor a .tmp_ one,
    and the previous step stays the newest, restorable."""
    tree = _damage_tree()
    tckpt.save(tmp_path, 1, tree)

    def boom(path, **kw):
        with open(path, "wb") as f:
            f.write(b"PK partial")
        raise OSError("disk full")

    def bad_fsync(path):
        raise OSError("fsync failed")
    if where == "savez":
        monkeypatch.setattr(tckpt.np, "savez", boom)
    else:
        monkeypatch.setattr(tckpt, "_fsync_path", bad_fsync)
    with pytest.raises(OSError):
        tckpt.save(tmp_path, 2, tree)
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]
    assert tckpt.latest_step(tmp_path) == 1
    assert tckpt.restore(tmp_path, 1, _zeroed(tree))["step"] == 7


# ---------------------------------------------------------------------------
# export_working_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", [True, False])
def test_export_working_params_matches_the_reference(cache, tmp_path):
    """From "wp" (the cache) or from bf16(master): the port's export of a
    port checkpoint is the reference's export of it, leaf for leaf bit for
    bit (recorded dtypes: fp32 leaves holding bf16 values), latest step
    by default."""
    kw = dict(master_params=True, work_param_cache=cache)
    tree, state, _ = _port_run(_port_opt(**kw), 1)
    tckpt.save(tmp_path, 1, {"params": tree, "opt": state})
    fresh = _port_tree()
    target = {"params": fresh, "opt": make_train_step(
        _port_cfg(), _port_opt(**kw))[1](fresh)}
    got = tckpt.export_working_params(tmp_path, None, target)
    j_params = jax.tree.map(jnp.asarray, _init_params())
    _, init = jax_make_train_step(tiny(ARCH), _jax_opt(**kw))
    want = jckpt.export_working_params(str(tmp_path), None, jax.eval_shape(
        lambda: {"params": j_params, "opt": init(j_params)}))
    _assert_leaves_equal(got, want, f"cache={cache}")
    for x in tarena.tree_flatten(got)[0]:
        assert torch.equal(x, x.to(torch.bfloat16).float())


def test_export_without_a_master_region_is_refused(tmp_path):
    tree, state, _ = _port_run(_port_opt(), 1)
    tckpt.save(tmp_path, 1, {"params": tree, "opt": state})
    with pytest.raises(tckpt.MissingMasterRegionError,
                       match="no master-param region 'p'"):
        tckpt.export_working_params(tmp_path, 1,
                                    {"params": tree, "opt": state})
    with pytest.raises(FileNotFoundError):
        tckpt.export_working_params(tmp_path / "absent", None,
                                    {"params": tree, "opt": state})


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    """`--checkpoint-dir` run twice: the second run prints `[train]
    restored step 2` and runs steps 3-4 only."""
    args = ["--arch", "stablelm-1.6b", "--reduced", "--global-batch", "4",
            "--micro-batches", "2", "--seq-len", "16", "--log-every", "1",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "1", "--keep-last-n", "2"]
    tlaunch.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "restored" not in out and "step 2/2" in out
    tlaunch.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    assert "step 2/4" not in out and "step 3/4" in out and "step 4/4" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004"]
