"""Row-range ZeRO-1 and the data-parallel engine on M gloo ranks.

- `build_layout(n_shards=, tp_shards=)` and `shard_rows` against the
  reference's, row for row, with its ValueError texts, on the reduced
  bert-large, stablelm-1.6b, deepseek-v2-lite-16b (two stacked regions) and
  whisper-base (three), and bert-large's full arena.
- M = 2 and 4 ranks (spawned processes, tests/_dp_worker.py), on the
  reduced stablelm-1.6b (a causal LM: every rank's micro-batch holds as many
  loss tokens as any other, so a mean of the ranks' losses is the loss of
  their union):
  - ZeRO-1 full pack for the seven codec pairs of the reference's
    tests/test_distributed.py against the port's single-device adama on
    the reordered batch (one device's micro-batch i = every rank's
    micro-batch i), the arena laid out for M shards alike; the eighth pair,
    int8/factored, and every pair guarded on a clean run equal their
    unguarded runs bit for bit;
  - replicated adama and ga against one device over N x M micro-batches;
  - each rank's row-indexed columns hold rows / M rows, and
    `optimizer_state_bytes` is their sum plus the shared columns';
  - one bad rank (`nan@micro=1,device=1`) makes both ranks skip the
    micro-batch, and the run equals `skip@micro=1` bit for bit;
  - the bytes each schedule moves a step at N = 4 (§3.3, Fig. 7);
  - at M = 2, ZeRO-1 fp32/fp32 (full pack and bucketed), the ZeRO-1
    stream and replicated adama against the reference's DP engine on two
    fake XLA devices, in a subprocess started beside the ranks;
  - the bf16 wire and master params through the full pack at a constant
    lr, every pair (each alone and together at M = 2, together at M = 4,
    and together guarded), against the single-device engine with the
    same fields, and fp32/fp32 against the reference's single-device
    make_train_step (grad_dtype="bf16", master_params=True), the
    master's update element by element (UPDATE_TOL and the rest); the
    master fp32, rows / M of it a rank, the leaves bf16 of it; a bf16 wire's
    reduce-scatters and a master's all-gather exactly half the bytes;
    dynamic scaling on the bf16 wire backs off once after a NaN (M = 4);
  - checkpoints at M = 2: crash and resume bit for bit (bucketed, full
    pack, both on the bf16 wire with a master, the guarded stream), a
    bucketed save the full pack's bytes, the reference's `restore` of
    the checkpoint into its init_arena(n_shards=2) state, only rank 0
    touching the files and no step counter moving, and a layout padded
    for 4 ranks refused naming item 10.4.
  Moments are held relative to the largest |value| of the oracle's, and
  params under the reference's warmup schedule (queue 3 (f)).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _dp_worker import (GUARDED_BF16_MASTER, LR, WIRES, batches, collect,
                        init_tree, model_config, run, start_ranks)
from conftest import tiny
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.core import zero as jzero
from repro.models.model import init_params as jax_init_params
from repro_torch.core import arena as tarena
from repro_torch.core import buckets as tbuckets
from repro_torch.core import state_store
from repro_torch.core import zero as tzero
from repro_torch.kernels import fused_step
from test_torch_engines import ENGINE_TOL
from test_torch_master import _bf16_ulp

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parent.parent / "src")
LAYOUT_ARCHS = ("bert_large", "stablelm_1_6b", "deepseek_v2_lite_16b",
                "whisper_base")
SHARDS = (1, 2, 3, 4, 8, 16)
DP_ARCH = "stablelm_1_6b"
N_MICRO, GB = 2, 8
PAIRS7 = (("fp32", "fp32"), ("fp32", "int8"), ("fp32", "factored"),
          ("fp32", "rowcol"), ("int8", "fp32"), ("int8", "int8"),
          ("int8", "rowcol"))
PAIRS8 = PAIRS7 + (("int8", "factored"),)
ZERO1 = dict(zero_stage=1, zero_bucketed=False)
# ZeRO-1 runs' steps by M: two at M = 2 (the second mini-batch's decay of
# the sharded state and of rowcol's summed column sums), one at M = 4
ZERO1_STEPS = {2: 2, 4: 1}
# moments against their oracle, relative to its largest |value|: fp32
# columns differ by the order of the sums (measured <= 3.2e-7); a pair
# with an int8 column by at most a code step of its largest row (1/127,
# measured 7.9e-3), here twice that
FP32_REL = 2e-6
CODE_REL = 2 / 127
# a pair with an int8 column: step 2's loss, on params that moved apart
# within the codec's drift at step 1 (measured 2.5e-5)
LOSSY_LOSS_TOL = 1e-4
# The bf16 wire and master params run at the constant lr LR (under the
# warmup schedule step 1's lr is 0: a one-step run at M = 4 would move
# nothing). Against one device: the bf16 wire rounds each rank's addend to
# bf16 before the sum (and gloo adds bf16 in bf16), one device the union's
# gradient once, so fp32 columns differ by a few bf16 roundings of their
# largest value (2^-8 = 3.9e-3 each), held within BF16_REL of it
# (measured 8.4e-3; 1.2e-2 with an int8 column, within CODE_REL); the
# losses of steps after the first within BF16_LOSS_TOL (measured 2.7e-4).
# A run's UPDATE (its master, or its fp32 params, less the seed-0 start)
# is held against the single-device engine's (`assert_same_update`). An
# Adam step moves an element by at most ~lr whatever its gradient, and
# a gradient that bf16 rounding moves (or flips, where it is tiny) moves
# that element's update by up to that much; so, measured over the bf16
# wire's M = 2 and 4 runs of every pair:
# - at most UPDATE_FRAC of the elements differ by more than UPDATE_TOL
#   (measured at most 8.5e-3 of them, int8 m; 4.5e-5 on fp32/fp32);
# - the update's norm within UPDATE_NORM_REL of the engine's (measured
#   1.1e-4) and their cosine at least UPDATE_COS (1 - 4.1e-4 measured);
# - as many elements moved by more than lr / 2, within MOVED_SHARE
#   (measured 1e-4);
# - every element within UPDATE_BOUND a step (two updates' worth and a
#   tenth; measured 1.83e-3 in one step, 2.15e-3 in two).
# A rank that skips the apply (an update of 0) fails the norm (ratio 0)
# and the share (the elements whose update exceeds UPDATE_TOL: 28-69% by
# pair); one that applies with the wrong sign fails the cosine (-1); one
# that drops the bias correction the norm (3.16x at step 1, 0.24x at step
# 2). The bf16 leaves of a master are bf16 of it (checked exactly on every
# rank), so within UPDATE_BOUND and one bf16 ulp of the engine's (a master
# on either side of a rounding boundary: 7.8e-3 at a norm weight of 1).
BF16_REL = 2 ** -6
BF16_LOSS_TOL = 1e-3
UPDATE_TOL = LR / 10
UPDATE_FRAC = 0.02
UPDATE_NORM_REL = 1e-3
UPDATE_COS = 0.998
MOVED_SHARE = 1e-3
UPDATE_BOUND = 2.2 * LR


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def _abstract_trees(cfg):
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    ttree = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), jtree)
    return jtree, ttree


def _same_layout(jl, tl):
    assert jl.rows == tl.rows
    assert [(s.name, s.n_layers, s.layer_rows, s.row) for s in jl.stacks] \
        == [(s.name, s.n_layers, s.layer_rows, s.row) for s in tl.stacks]
    for js, ts in zip(jl.stacks, tl.stacks):
        assert [(tuple(a.shape), a.row, a.rows) for a in js.leaves] == \
            [(a.shape, a.row, a.rows) for a in ts.leaves]
    assert (jl.rest.row, jl.rest.rows) == (tl.rest.row, tl.rest.rows)
    assert [(tuple(a.shape), a.row, a.rows) for a in jl.rest.leaves] == \
        [(a.shape, a.row, a.rows) for a in tl.rest.leaves]


def _shards_or_error(fn, layout, n):
    try:
        return [(s.index, s.start, s.rows) for s in fn(layout, n)]
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("tp", (1, 2))
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_sharded_layouts_and_row_ranges_match_reference(arch, tp):
    jtree, ttree = _abstract_trees(tiny(arch))
    assert len(jarena.split_tree(jtree)[0]) == \
        {"deepseek_v2_lite_16b": 2, "whisper_base": 2}.get(arch, 1)
    for n in SHARDS:
        assert tarena.region_grain(n * tp) == jarena.region_grain(n * tp)
        jl = jarena.build_layout(jtree, n_shards=n, tp_shards=tp)
        tl = tarena.build_layout(ttree, n_shards=n, tp_shards=tp)
        _same_layout(jl, tl)
        # the product's arithmetic: (n, tp) lays out as (n * tp, 1)
        _same_layout(jl, tarena.build_layout(ttree, n_shards=n * tp))
        for m in (0, 1, 2, 3, 4, 5, 8, 16, 64, 128):
            assert _shards_or_error(tzero.shard_rows, tl, m) == \
                _shards_or_error(jzero.shard_rows, jl, m), (n, m)


def test_whisper_has_three_stacked_regions_and_bert_large_pads_as_worked():
    """whisper-base's layout has its encoder, decoder and rest regions;
    bert-large's full arena (357,888 rows) stays at M = 2 and pads to
    358,400 (4 x 89,600) at M = 4 and 8, as the reference's arithmetic
    gives."""
    _, ttree = _abstract_trees(tiny("whisper_base"))
    lay = tarena.build_layout(ttree, n_shards=4)
    assert [s.name for s in lay.stacks] == ["blocks", "enc_blocks"]
    assert lay.rest.rows > 0
    cfg = jax_get_config("bert_large")
    jtree, ttree = _abstract_trees(cfg)
    rows = {n: tarena.build_layout(ttree, n_shards=n).rows
            for n in (1, 2, 4, 8)}
    assert rows == {1: 357_888, 2: 357_888, 4: 358_400, 8: 358_400}
    assert rows[4] == jarena.build_layout(jtree, n_shards=4).rows
    per = tzero.shard_rows(tarena.build_layout(ttree, n_shards=4), 4)
    assert [s.rows for s in per] == [89_600] * 4
    assert all(s.rows % fused_step.BLOCK_ROWS == 0 for s in per)


# ---------------------------------------------------------------------------
# M ranks
# ---------------------------------------------------------------------------


def _zero_cases(steps):
    out = []
    for m, v in PAIRS8:
        kw = dict(micro_batches=N_MICRO, m_codec=m, state_codec=v, **ZERO1)
        out.append((f"zero1-{m}-{v}", dict(opt_kw=kw, variant="adama",
                                           warmup=True, arch=DP_ARCH,
                                           gb=GB, steps=steps)))
        out.append((f"zero1-{m}-{v}-guarded", dict(
            opt_kw=dict(kw, finite_guard=True), variant="adama",
            warmup=True, arch=DP_ARCH, gb=GB, steps=steps)))
    base = dict(variant="adama", warmup=True, arch=DP_ARCH, gb=GB)
    out += [("replicated", dict(base, opt_kw=dict(micro_batches=N_MICRO))),
            ("ga", dict(base, variant="ga",
                        opt_kw=dict(micro_batches=N_MICRO)))]
    return out + _wire_master_cases(steps)


def _wire_master_cases(steps):
    """The bf16 wire and master params through the full pack for every
    pair, at the constant lr: each alone and together at M = 2 (`steps`
    2), together at M = 4, and together guarded (a clean run, dynamic
    scaling)."""
    out = []
    wires = WIRES if steps == 2 else WIRES[-1:]
    for m, v in PAIRS8:
        kw = dict(micro_batches=N_MICRO, m_codec=m, state_codec=v, **ZERO1)
        for label, extra in wires:
            out.append((f"zero1-{m}-{v}-{label}", dict(
                opt_kw=dict(kw, **extra), variant="adama", warmup=False,
                arch=DP_ARCH, gb=GB, steps=steps)))
        out.append((f"zero1-{m}-{v}-bf16-master-guarded", dict(
            opt_kw=dict(kw, **GUARDED_BF16_MASTER), variant="adama",
            warmup=False, arch=DP_ARCH, gb=GB, steps=steps)))
    return out


def _two_rank_cases(d):
    out = []
    g = dict(micro_batches=N_MICRO, finite_guard=True)
    for label, kw in (("zero1", dict(g, **ZERO1)), ("replicated", g)):
        for fault in ("nan@micro=1,device=1", "skip@micro=1"):
            out.append((f"{label}-{fault.partition('@')[0]}", dict(
                opt_kw=kw, variant="adama", arch=DP_ARCH, gb=GB,
                fault=fault)))
    # the bucketed schedule and the stream, against the reference's below
    for label, variant in (("bucketed", "adama"),
                           ("stream", "adama_layerwise")):
        out.append((f"{label}-fp32-fp32", dict(
            opt_kw=dict(micro_batches=N_MICRO, zero_stage=1),
            variant=variant, warmup=True, arch=DP_ARCH, gb=GB)))
    # step 2 skipped whole: the state must stay as step 1 left it
    out += [("replicated-skip-step-2", dict(opt_kw=g, variant="adama",
                                            arch=DP_ARCH, gb=GB,
                                            fault="skip@step=1")),
            ("replicated-1-step", dict(opt_kw=g, variant="adama",
                                       arch=DP_ARCH, gb=GB, steps=1))]
    for variant, kw in (("ga", {}), ("naive", {}), ("adama", {}),
                        ("adama", ZERO1)):
        name = "bytes-" + variant + ("-zero1" if kw else "")
        out.append((name, dict(opt_kw=dict(kw, micro_batches=4),
                               variant=variant, arch=DP_ARCH, gb=GB,
                               steps=1)))
    return out + _checkpoint_cases(d)


# a DP run's checkpoints at M = 2: name -> (variant, OptimizerConfig fields)
CHECKPOINTED = {
    "bucketed": ("adama", dict(zero_stage=1)),
    "full": ("adama", ZERO1),
    "bucketed-bf16-master": ("adama", dict(zero_stage=1, grad_dtype="bf16",
                                           master_params=True)),
    "full-bf16-master": ("adama", dict(ZERO1, grad_dtype="bf16",
                                       master_params=True)),
    "stream-bf16-master-guarded": ("adama_layerwise", dict(
        zero_stage=1, **GUARDED_BF16_MASTER)),
}


def _checkpoint_cases(d):
    out = [(f"ckpt-{name}", dict(kind="checkpointed", variant=variant,
                                 opt_kw=dict(kw, micro_batches=N_MICRO),
                                 ckpt_dir=f"{d}/ckpt-{name}", arch=DP_ARCH,
                                 gb=GB))
           for name, (variant, kw) in CHECKPOINTED.items()]
    out.append(("ckpt-rank0-files", dict(
        kind="rank0_files", variant="adama", opt_kw=dict(
            micro_batches=N_MICRO, zero_stage=1, grad_dtype="bf16",
            master_params=True), ckpt_dir=f"{d}/ckpt-rank0-files",
        arch=DP_ARCH, gb=GB)))
    out.append(("ckpt-other-m", dict(kind="other_m_restore",
                                     variant="adama",
                                     opt_kw=dict(micro_batches=N_MICRO,
                                                 zero_stage=1),
                                     ckpt_dir=f"{d}/ckpt-other-m",
                                     arch=DP_ARCH)))
    return out


def _four_rank_cases():
    """The reference's test_zero1_dynamic_scale_bf16_recovers: bucketed
    bf16, dynamic scaling, a NaN in micro-batch 1 of step 1, 3 steps."""
    return [("bf16-dynamic-nan", dict(
        opt_kw=dict(micro_batches=N_MICRO, zero_stage=1, grad_dtype="bf16",
                    finite_guard=True, loss_scale="dynamic"),
        variant="adama", arch=DP_ARCH, gb=GB, steps=3,
        fault="nan@micro=1,step=0"))]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's jobs, started together: M = 2 and 4 gloo ranks and the
    reference's subprocess (REFERENCE)."""
    d = tmp_path_factory.mktemp("dp")
    ref = _start_reference(d)
    jobs = {2: start_ranks(2, d, "m2", _zero_cases(ZERO1_STEPS[2])
                           + _two_rank_cases(d)),
            4: start_ranks(4, d, "m4", _zero_cases(ZERO1_STEPS[4])
                           + _four_rank_cases())}
    return d, ref, jobs


@pytest.fixture(scope="module")
def ranks(started):
    """{M: each rank's results} for M = 2 and 4."""
    return {m: collect(job) for m, job in started[2].items()}


@pytest.fixture(scope="module")
def reference(started):
    """The reference subprocess's arrays (REFERENCE)."""
    d, proc, _ = started
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "DONE" in out, err[-4000:]
    return dict(np.load(d / "reference.npz"))


def _whole(results, name, k):
    """Moment k's columns over all ranks: a row-indexed column's rank
    shards stacked in rank order, a shared one as rank 0 holds it (all
    ranks hold the same)."""
    cols = []
    for j, x in enumerate(results[0][name][k]):
        if results[0][name]["mask"][k][j]:
            cols.append(np.concatenate([r[name][k][j] for r in results]))
        else:
            assert all(np.array_equal(r[name][k][j], x) for r in results)
            cols.append(x)
    return cols


def _decoded(codec, moment, cols):
    return state_store.get_codec(codec, moment).decode(
        tuple(torch.from_numpy(c) for c in cols)).numpy()


def _assert_same_params_on_every_rank(results, name):
    for r in results[1:]:
        assert r[name]["params_digest"] == results[0][name]["params_digest"]
        assert r[name]["losses"] == results[0][name]["losses"]


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("pair", PAIRS7, ids=lambda p: "-".join(p))
def test_zero1_matches_single_device_on_the_reordered_batch(ranks, m, pair):
    res = ranks[m]
    name = f"zero1-{pair[0]}-{pair[1]}"
    _assert_same_params_on_every_rank(res, name)
    want = run(dict(micro_batches=N_MICRO, m_codec=pair[0],
                    state_codec=pair[1]), arch=DP_ARCH, gb=GB, warmup=True,
               reorder=(m, N_MICRO), state_shards=m, steps=ZERO1_STEPS[m])
    got = res[0][name]
    lossy = "int8" in pair
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSSY_LOSS_TOL if lossy else 1e-5)
    np.testing.assert_allclose(
        got["params"], want["params"], rtol=0,
        atol=(state_store.get_codec("int8").conformance.drift_lr * LR
              * ZERO1_STEPS[m]
              if lossy else ENGINE_TOL))
    for k, codec in (("m", pair[0]), ("v", pair[1])):
        a = _decoded(codec, k, _whole(res, name, k))
        b = _decoded(codec, k, want[k])
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= (CODE_REL if lossy else FP32_REL), (k, rel)
    assert got["step"] == ZERO1_STEPS[m]
    assert got["layout_rows"] == want["layout_rows"]


@pytest.mark.parametrize("m", (2, 4))
def test_guarded_zero1_equals_unguarded_for_every_pair(ranks, m):
    for pair in PAIRS8:
        name = f"zero1-{pair[0]}-{pair[1]}"
        for r in ranks[m]:
            a, b = r[name], r[name + "-guarded"]
            assert a["params_digest"] == b["params_digest"], pair
            assert a["losses"] == b["losses"], pair
            for k in ("m", "v"):
                assert all(np.array_equal(x, y)
                           for x, y in zip(a[k], b[k])), (pair, k)
            assert b["scaler"]["skipped"] == 0


@pytest.mark.parametrize("m", (2, 4))
def test_replicated_adama_and_ga_match_one_device_over_n_times_m(ranks, m):
    res = ranks[m]
    for name, kw in (("replicated", {}), ("ga", dict(accumulation="ga"))):
        _assert_same_params_on_every_rank(res, name)
        want = run(dict(kw, micro_batches=N_MICRO * m), arch=DP_ARCH, gb=GB,
                   warmup=True)
        got = res[0][name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                                   atol=ENGINE_TOL)
        if name == "replicated":
            for k in ("m", "v"):
                rel = (np.abs(got[k][0] - want[k][0]).max()
                       / np.abs(want[k][0]).max())
                assert rel <= FP32_REL, (k, rel)


@pytest.mark.parametrize("m", (2, 4))
def test_each_rank_holds_its_rows_of_every_row_indexed_column(ranks, m):
    for pair in PAIRS8:
        name = f"zero1-{pair[0]}-{pair[1]}"
        for rank, r in enumerate(ranks[m]):
            got = r[name]
            rows = got["layout_rows"]
            assert rows % m == 0
            want_bytes = 0
            for k, codec in (("m", pair[0]), ("v", pair[1])):
                cols = state_store.get_codec(codec, k).kernel.cols
                for x, c, ri in zip(got[k], cols, got["mask"][k]):
                    assert ri == c.row_indexed
                    assert x.shape == ((rows // m if ri else 1), c.width)
                    want_bytes += x.shape[0] * c.width * x.itemsize
            assert got["state_bytes"] == want_bytes


@pytest.mark.parametrize("label", ("zero1", "replicated"))
def test_one_bad_rank_makes_every_rank_skip(ranks, label):
    res = ranks[2]
    nan, skip = f"{label}-nan", f"{label}-skip"
    for r in res:
        a, b = r[nan], r[skip]
        assert a["params_digest"] == b["params_digest"]
        for k in ("m", "v"):
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
        assert a["step"] == b["step"] == 2
        assert a["scaler"] == b["scaler"]
        assert a["scaler"]["skipped"] == 2          # one a step
        assert [x["skipped_micro_batches"] for x in a["metrics"]] == [1, 2]
    _assert_same_params_on_every_rank(res, nan)


def test_a_wholly_skipped_mini_batch_leaves_the_replicated_state(ranks):
    """No rank folds, so no rank pre-scaled v by M*b2: the sum of the M
    equal copies is divided by M, not M^2 (ROADMAP queue 3 (z): the
    reference divides by M^2 there), and params, m and v stay as step 1
    left them."""
    for r in ranks[2]:
        a, b = r["replicated-skip-step-2"], r["replicated-1-step"]
        assert a["scaler"]["skipped"] == N_MICRO and a["step"] == 1
        assert a["params_digest"] == b["params_digest"]
        for k in ("m", "v"):
            assert np.array_equal(a[k][0], b[k][0]), k


def test_collective_bytes_follow_the_schedules(ranks):
    """M = 2, N = 4, one step: ga all-reduces the gradient once (P), AdamA
    its two moment arenas, naive every micro-batch's gradient (N x P),
    ZeRO-1 scatters the gradient arena N times and gathers the params once
    (N x A + A); each also all-reduces its 4-byte loss."""
    r = ranks[2][0]
    p_bytes = r["bytes-ga"]["param_bytes"]
    a_bytes = r["bytes-adama-zero1"]["layout_rows"] * fused_step.LANES * 4
    rep_a = r["bytes-adama"]["layout_rows"] * fused_step.LANES * 4
    got = {k: r[k]["collectives"] for k in
           ("bytes-ga", "bytes-naive", "bytes-adama", "bytes-adama-zero1")}
    assert got["bytes-ga"] == {"all_reduce": (len(_leaves()) + 1,
                                              p_bytes + 4),
                               "reduce_scatter": (0, 0),
                               "all_gather": (0, 0)}
    assert got["bytes-naive"]["all_reduce"][1] == 4 * p_bytes + 4
    assert got["bytes-adama"] == {"all_reduce": (3, 2 * rep_a + 4),
                                  "reduce_scatter": (0, 0),
                                  "all_gather": (0, 0)}
    assert got["bytes-adama-zero1"] == {"all_reduce": (1, 4),
                                        "reduce_scatter": (4, 4 * a_bytes),
                                        "all_gather": (1, a_bytes)}


def _leaves():
    return tarena.tree_flatten(init_tree(model_config(DP_ARCH)))[0]


REFERENCE = """
    import dataclasses, json, sys, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, OptimizerConfig
    from repro.core import arena as jarena
    from repro.core.accumulation import make_train_step
    from repro.core.dp_shardmap import make_dp_train_step
    from repro.launch.mesh import make_mesh
    from repro.optim import schedule as jsched
    d = sys.argv[1]
    cfg = dataclasses.replace(get_config('stablelm_1_6b').reduced(),
                              compute_dtype='float32')
    flat = dict(np.load(d + '/params.npz'))
    params = {}
    for path, x in flat.items():
        node = params
        keys = path.split('/')
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(x)
    out = {}

    def drive(name, step, init, data, mesh=None):
        steps = len(data.files) // 2
        p, st = params, init(params)
        losses = []
        f = jax.jit(step)
        for s in range(steps):
            b = {k: jnp.asarray(data[f'{k}{s}']) for k in ('tokens', 'labels')}
            if mesh is None:
                p, st, m = f(p, st, b)
            else:
                with mesh:
                    p, st, m = f(p, st, b)
            losses.append(float(m['loss']))
        out[name + '-params'] = np.asarray(
            jarena.pack(p, jarena.build_layout(p)), np.float32)
        out[name + '-m'] = np.asarray(st['m'].data)
        out[name + '-v'] = np.asarray(st['v'].data)
        out[name + '-losses'] = np.asarray(losses)
        if 'p' in st:
            out[name + '-p'] = np.asarray(st['p'].data)

    data = np.load(d + '/batches.npz')
    steps = len(data.files) // 2
    mesh = make_mesh((2,), ('data',))
    for name, variant, kw in (
            ('zero1', 'adama', dict(zero_stage=1, zero_bucketed=False)),
            ('replicated', 'adama', {}),
            ('bucketed', 'adama', dict(zero_stage=1)),
            ('stream', 'adama_layerwise', dict(zero_stage=1))):
        oc = OptimizerConfig(name='adama', accumulation='adama',
                             micro_batches=2, use_pallas=True, arena=True,
                             **kw)
        step, init = make_dp_train_step(
            cfg, oc, mesh, ('data',), variant,
            lr_schedule=jsched.warmup_cosine(1e-3, 1, steps + 1))
        drive(name, step, init, data, mesh)
    # one device, the bf16 wire and master params at the constant lr, on
    # the batches reordered for M ranks
    for m in (2, 4):
        data = np.load(d + f'/batches-r{m}.npz')
        oc = OptimizerConfig(name='adama', accumulation='adama',
                             micro_batches=2, use_pallas=True, arena=True,
                             grad_dtype='bf16', master_params=True)
        step, init = make_train_step(cfg, oc)
        drive(f'bf16-master-r{m}', step, init, data)
    np.savez(d + '/reference.npz', **out)
    print('DONE')
"""


def _start_reference(d):
    """REFERENCE in a subprocess on two fake XLA devices, from the port's
    seed-0 params and batches (and the batches reordered for M = 2 and
    4); the `reference` fixture waits for it."""
    cfg = model_config(DP_ARCH)
    leaves, paths = tarena.tree_flatten(init_tree(cfg))
    np.savez(d / "params.npz", **{"/".join(p): x.detach().numpy()
                                  for p, x in zip(paths, leaves)})
    np.savez(d / "batches.npz", **{
        f"{k}{s}": v.numpy() for s, b in enumerate(batches(cfg, GB, 2))
        for k, v in b.items()})
    for m in (2, 4):
        np.savez(d / f"batches-r{m}.npz", **{
            f"{k}{s}": v.numpy() for s, b in enumerate(batches(
                cfg, GB, ZERO1_STEPS[m], reorder=(m, N_MICRO)))
            for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE),
                             str(d)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def test_two_ranks_match_the_reference_dp_engine(ranks, reference):
    """ZeRO-1 full pack and bucketed fp32/fp32, the ZeRO-1 stream
    (adama_layerwise) and replicated adama on two gloo ranks against the
    reference's make_dp_train_step on two fake devices, from the same
    params and batches, within ENGINE_TOL (the bucketed states in
    partition order on both sides)."""
    ref = reference
    res = ranks[2]
    for name, dp in (("zero1", "zero1-fp32-fp32"),
                     ("replicated", "replicated"),
                     ("bucketed", "bucketed-fp32-fp32"),
                     ("stream", "stream-fp32-fp32")):
        got = res[0][dp]
        np.testing.assert_allclose(got["losses"], ref[name + "-losses"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["params"], ref[name + "-params"],
                                   rtol=0, atol=ENGINE_TOL)
        for k in ("m", "v"):
            mine = got[k] if name == "replicated" else _whole(res, dp, k)
            np.testing.assert_allclose(mine[0], ref[f"{name}-{k}"], rtol=0,
                                       atol=ENGINE_TOL)


# ---------------------------------------------------------------------------
# The bf16 gradient wire and master params (full pack; the bucketed
# schedule and the stream in tests/test_torch_zero_stream.py)
# ---------------------------------------------------------------------------


def _wire_kw(label):
    return dict(WIRES)[label]


def _start(m):
    """The seed-0 params packed in the layout for M shards (the start of
    a master laid out so)."""
    tree = init_tree(model_config(DP_ARCH))
    with torch.no_grad():
        return tarena.pack(tree,
                           tarena.build_layout(tree, n_shards=m)).numpy()


def assert_same_update(got, want, start, steps):
    """`got` - `start` against `want` - `start`, as the comment above
    UPDATE_TOL says."""
    du = (got - start).astype(np.float64).ravel()
    dw = (want - start).astype(np.float64).ravel()
    e = np.abs(du - dw)
    assert e.max() <= UPDATE_BOUND * steps, e.max()
    assert np.mean(e > UPDATE_TOL) <= UPDATE_FRAC, np.mean(e > UPDATE_TOL)
    nu, nw = np.linalg.norm(du), np.linalg.norm(dw)
    assert nw > 0 and abs(nu / nw - 1) <= UPDATE_NORM_REL, (nu, nw)
    assert du @ dw >= UPDATE_COS * nu * nw, du @ dw / (nu * nw)
    moved = [np.mean(np.abs(d) > LR / 2) for d in (du, dw)]
    assert abs(moved[0] - moved[1]) <= MOVED_SHARE, moved


def check_wire_master(res, m, name, pair, label, engine="adama",
                      perm=None):
    """A bf16-wire and/or master run on M ranks against the port's
    single-device `engine` with the same fields on the reordered batch,
    the arena laid out for M shards alike: step 1's loss within 1e-6
    (the params it runs on are the same); the update of the master (or of
    the fp32 params without one) as assert_same_update holds it; on the
    fp32 wire the master and the moments as
    test_zero1_matches_single_device holds params and moments, on the
    bf16 wire the moments within BF16_REL; the leaves of a master within
    the update's bound and one bf16 ulp. The master is fp32, each rank
    holds rows / M of it, and the leaves are bf16 of the whole master
    (partition order under a bucketed run, `perm` its partition_index)."""
    _assert_same_params_on_every_rank(res, name)
    kw = _wire_kw(label)
    steps = ZERO1_STEPS[m]
    want = run(dict(micro_batches=N_MICRO, m_codec=pair[0],
                    state_codec=pair[1], accumulation=engine, **kw),
               arch=DP_ARCH, gb=GB, reorder=(m, N_MICRO), state_shards=m,
               steps=steps)
    got = res[0][name]
    lossy = "int8" in pair
    bf16 = kw.get("grad_dtype") == "bf16"
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-6)
    master = kw.get("master_params", False)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=BF16_LOSS_TOL if master or bf16
                               else LOSSY_LOSS_TOL if lossy else 1e-5)
    tol = state_store.get_codec("int8").conformance.drift_lr * LR * steps \
        if lossy else ENGINE_TOL
    a, b = got["params"], want["params"]
    if master:
        ulp = _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        bound = UPDATE_BOUND * steps if bf16 else tol
        assert (np.abs(a - b) <= bound + ulp).all(), np.abs(a - b).max()
    else:
        assert_same_update(a, b, _start(1), steps)
    for k, codec in (("m", pair[0]), ("v", pair[1])):
        whole = _whole(res, name, k)
        if perm is not None:
            whole = [x[perm] if x.shape[0] == perm.shape[0] else x
                     for x in whole]
        a = _decoded(codec, k, whole)
        b = _decoded(codec, k, want[k])
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= max(CODE_REL if lossy else FP32_REL,
                          BF16_REL if bf16 else 0), (k, rel)
    assert got["step"] == steps
    assert ("p" in got) == master
    if master:
        p = np.concatenate([r[name]["p"] for r in res])
        assert p.dtype == np.float32 and p.shape[0] == got["layout_rows"]
        assert all(r[name]["p"].shape[0] == p.shape[0] // m for r in res)
        if perm is not None:
            p = p[perm]
        assert_same_update(p, want["p"], _start(m), steps)
        if not bf16:
            np.testing.assert_allclose(p, want["p"], rtol=0, atol=tol)
        assert all(r[name]["work_is_bf16_master"] for r in res)


WIRE_CASES = [(2, pair, label) for pair in PAIRS8 for label, _ in WIRES] + \
    [(4, pair, "bf16-master") for pair in PAIRS8]


@pytest.mark.parametrize("m, pair, label", WIRE_CASES,
                         ids=lambda x: "-".join(x) if isinstance(x, tuple)
                         else str(x))
def test_zero1_bf16_wire_and_master_match_single_device(ranks, m, pair,
                                                        label):
    check_wire_master(ranks[m], m, f"zero1-{pair[0]}-{pair[1]}-{label}",
                      pair, label)


@pytest.mark.parametrize("m", (2, 4))
def test_guarded_bf16_master_equals_unguarded_for_every_pair(ranks, m):
    """A clean guarded run with dynamic scaling on the bf16 wire and a
    master: the same params, master, moments and losses as unguarded,
    bit for bit, and no skip."""
    for pair in PAIRS8:
        name = f"zero1-{pair[0]}-{pair[1]}-bf16-master"
        for r in ranks[m]:
            a, b = r[name], r[name + "-guarded"]
            assert a["params_digest"] == b["params_digest"], pair
            assert np.array_equal(a["p"], b["p"]), pair
            assert a["losses"] == b["losses"], pair
            for k in ("m", "v"):
                assert all(np.array_equal(x, y)
                           for x, y in zip(a[k], b[k])), (pair, k)
            assert b["scaler"]["skipped"] == 0


@pytest.mark.parametrize("m", (2, 4))
def test_bf16_master_matches_the_reference_single_device_engine(
        ranks, reference, m):
    """ZeRO-1 on the bf16 wire with master params (fp32/fp32) against the
    reference's make_train_step with grad_dtype="bf16",
    master_params=True on the batch reordered for M ranks: the losses
    within BF16_LOSS_TOL, and the master's update (the ranks' rows
    gathered, in the reference's one-device layout) as
    assert_same_update holds it (the reference's own DP bf16 test is the
    one that fails, ROADMAP queue 3 (d))."""
    name = "zero1-fp32-fp32-bf16-master"
    got = ranks[m][0][name]
    np.testing.assert_allclose(got["losses"],
                               reference[f"bf16-master-r{m}-losses"],
                               rtol=0, atol=BF16_LOSS_TOL)
    tree = init_tree(model_config(DP_ARCH))
    p = torch.from_numpy(np.concatenate([r[name]["p"] for r in ranks[m]]))
    with torch.no_grad():
        p = tarena.pack(tarena.unpack(p, tarena.build_layout(
            tree, n_shards=m)), tarena.build_layout(tree)).numpy()
    assert_same_update(p, reference[f"bf16-master-r{m}-p"], _start(1),
                       ZERO1_STEPS[m])


def test_bf16_wire_and_master_halve_their_collectives(ranks):
    """M = 2, N = 2, two steps of the full pack: the bf16 wire's gradient
    reduce-scatters move exactly half the fp32 wire's bytes, in as many
    calls; the master's param all-gather exactly half the fp32 gather's;
    both together at most 0.55x the fp32 step's total (the reference's
    bound)."""
    r = ranks[2][0]
    fp32 = r["zero1-fp32-fp32"]["collectives"]
    bf16 = r["zero1-fp32-fp32-bf16"]["collectives"]
    master = r["zero1-fp32-fp32-master"]["collectives"]
    both = r["zero1-fp32-fp32-bf16-master"]["collectives"]
    rs, ag = fp32["reduce_scatter"], fp32["all_gather"]
    assert bf16["reduce_scatter"] == (rs[0], rs[1] // 2)
    assert bf16["all_gather"] == ag
    assert master["all_gather"] == (ag[0], ag[1] // 2)
    assert master["reduce_scatter"] == rs
    assert both["reduce_scatter"] == (rs[0], rs[1] // 2)
    assert both["all_gather"] == (ag[0], ag[1] // 2)

    def total(c):
        return sum(b for _, b in c.values())
    assert total(both) <= 0.55 * total(fp32)


def test_dynamic_scale_on_the_bf16_wire_backs_off_once(ranks):
    """The reference's test_zero1_dynamic_scale_bf16_recovers at M = 4: a
    NaN in micro-batch 1 of step 1 backs the scale off once, 2^15 ->
    2^14 on every rank, the step counter reaches 3, the params stay
    finite."""
    for r in ranks[4]:
        got = r["bf16-dynamic-nan"]
        assert got["metrics"][-1]["loss_scale"] == 2.0 ** 14
        assert got["scaler"]["skipped"] == 1
        assert got["step"] == 3
    assert np.isfinite(ranks[4][0]["bf16-dynamic-nan"]["params"]).all()
    _assert_same_params_on_every_rank(ranks[4], "bf16-dynamic-nan")


# ---------------------------------------------------------------------------
# Checkpoints of sharded state at M = 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CHECKPOINTED))
def test_m2_crash_and_resume_equals_the_run_that_never_stopped(ranks, name):
    """train() over two ranks with a checkpoint a step, crashed after step
    2's update and resumed from step 1, ends on the uninterrupted run's
    params, master, moments, scaler and losses, bit for bit, on every
    rank."""
    for r in ranks[2]:
        out = r[f"ckpt-{name}"]
        assert out["crashed"]
        clean, resumed = out["clean"], out["resumed"]
        assert resumed["losses"] == clean["losses"][1:]
        assert resumed["params_digest"] == clean["params_digest"]
        for k in ("m", "v"):
            assert all(np.array_equal(a, b)
                       for a, b in zip(resumed[k], clean[k])), k
        assert ("p" in clean) == ("master" in name)
        if "p" in clean:
            assert np.array_equal(resumed["p"], clean["p"])
        assert resumed.get("scaler") == clean.get("scaler")


def _files(d, step):
    with np.load(Path(d) / f"step_{step:08d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("wire", ("", "-bf16-master"))
def test_bucketed_checkpoint_is_the_full_packs_bytes(ranks, wire):
    """Every step a bucketed run saves is, array for array, what the
    full-pack run at the same M saves: canonical rows whatever the
    schedule (as tests/test_distributed.py holds for the reference)."""
    r = ranks[2][0]
    a, b = r[f"ckpt-bucketed{wire}"]["dir"], r[f"ckpt-full{wire}"]["dir"]
    for step in (1, 2):
        fa, fb = _files(f"{a}/clean", step), _files(f"{b}/clean", step)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa), step


def test_m2_checkpoint_restores_into_the_reference(ranks):
    """The bucketed bf16-wire master run's M = 2 checkpoint restores into
    the reference's {"params", "opt": init_arena(n_shards=2,
    master_params=True)} with its own `restore`: the rows the ranks held,
    unpermuted, and the params."""
    from repro.core import adama as jadama
    from repro.train import checkpoint as jckpt
    res = ranks[2]
    out = res[0]["ckpt-bucketed-bf16-master"]
    cfg = model_config(DP_ARCH)
    leaves, paths = tarena.tree_flatten(init_tree(cfg))
    jparams = {}
    for path, x in zip(paths, leaves):
        node = jparams
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(x.detach().numpy())
    target = jax.eval_shape(lambda: {"params": jparams, "opt": jadama.
                                     init_arena(jparams, n_shards=2,
                                                master_params=True)})
    got = jckpt.restore(f"{out['dir']}/clean", 2, target)
    lay = tarena.build_layout(init_tree(cfg), n_shards=2)
    perm = tbuckets.partition_index(tzero.zero1_bucket_plan(lay, 2))
    clean = [r["ckpt-bucketed-bf16-master"]["clean"] for r in res]
    for k in ("m", "v", "p"):
        whole = np.concatenate([c[k][0] if k != "p" else c[k]
                                for c in clean])[perm]
        assert np.array_equal(np.asarray(got["opt"][k].data), whole), k
    assert int(got["opt"]["step"]) == 2
    assert np.array_equal(np.asarray(jarena.pack(
        got["params"], jarena.build_layout(got["params"]))),
        clean[0]["params"])


def test_only_rank_0_touches_the_files_and_no_step_counter_moves(ranks):
    """A bucketed bf16-wire master state saved and restored at M = 2 where
    rank 1 is given a directory that does not exist: every rank restores
    exactly what it saved, latest_step is rank 0's on both, a step not on
    disk raises rank 0's FileNotFoundError on both, rank 1's directory is
    never made, and the save's gathers and the restore's transfers leave
    core/collectives.py's counters (a step's traffic) at zero."""
    for k, r in enumerate(ranks[2]):
        got = r["ckpt-rank0-files"]
        assert got["same"] and got["last"] == 1
        assert got["missing"] == "FileNotFoundError"
        assert got["dir_exists"] == (k == 0)
        assert all(c == (0, 0) for c in got["collectives"].values())


def test_restore_at_another_rank_count_names_item_10_4(ranks):
    """A checkpoint of a layout padded for 4 ranks, restored into two
    ranks' state, is refused naming ROADMAP item 10.4 (elastic restore),
    on every rank."""
    for r in ranks[2]:
        kind, msg = r["ckpt-other-m"]
        assert kind == "NotImplementedError"
        assert "another shard count" in msg and "item 10.4)" in msg
