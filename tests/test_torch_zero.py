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
    fake XLA devices, in a subprocess.
  Moments are held relative to the largest |value| of the oracle's, and
  params under the reference's warmup schedule (queue 3 (f)).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _dp_worker import (LR, batches, collect, init_tree, model_config, run,
                        start_ranks)
from conftest import tiny
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.core import zero as jzero
from repro.models.model import init_params as jax_init_params
from repro_torch.core import arena as tarena
from repro_torch.core import state_store
from repro_torch.core import zero as tzero
from repro_torch.kernels import fused_step
from test_torch_engines import ENGINE_TOL

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
    return out


def _two_rank_cases():
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
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{M: each rank's results} for M = 2 and 4."""
    d = tmp_path_factory.mktemp("dp")
    jobs = {2: start_ranks(2, d, "m2", _zero_cases(ZERO1_STEPS[2])
                           + _two_rank_cases()),
            4: start_ranks(4, d, "m4", _zero_cases(ZERO1_STEPS[4]))}
    return {m: collect(job) for m, job in jobs.items()}


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
        assert np.array_equal(r[name]["params"], results[0][name]["params"])
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
            assert np.array_equal(a["params"], b["params"]), pair
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
        assert np.array_equal(a["params"], b["params"])
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
        assert np.array_equal(a["params"], b["params"])
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


REFERENCE_M2 = """
    import dataclasses, json, sys, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, OptimizerConfig
    from repro.core import arena as jarena
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
    data = np.load(d + '/batches.npz')
    steps = len(data.files) // 2
    mesh = make_mesh((2,), ('data',))
    out = {}
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
        p, st = params, init(params)
        losses = []
        with mesh:
            f = jax.jit(step)
            for s in range(steps):
                b = {k: jnp.asarray(data[f'{k}{s}'])
                     for k in ('tokens', 'labels')}
                p, st, m = f(p, st, b)
                losses.append(float(m['loss']))
        out[name + '-params'] = np.asarray(
            jarena.pack(p, jarena.build_layout(p)))
        out[name + '-m'] = np.asarray(st['m'].data)
        out[name + '-v'] = np.asarray(st['v'].data)
        out[name + '-losses'] = np.asarray(losses)
    np.savez(d + '/reference.npz', **out)
    print('DONE')
"""


def test_two_ranks_match_the_reference_dp_engine(ranks, tmp_path):
    """ZeRO-1 full pack and bucketed fp32/fp32, the ZeRO-1 stream
    (adama_layerwise) and replicated adama on two gloo ranks against the
    reference's make_dp_train_step on two fake devices, from the same
    params and batches, within ENGINE_TOL (the bucketed states in
    partition order on both sides)."""
    cfg = model_config(DP_ARCH)
    leaves, paths = tarena.tree_flatten(init_tree(cfg))
    np.savez(tmp_path / "params.npz", **{"/".join(p): x.detach().numpy()
                                         for p, x in zip(paths, leaves)})
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{s}": v.numpy() for s, b in enumerate(batches(cfg, GB, 2))
        for k, v in b.items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_M2),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0 and "DONE" in out.stdout, out.stderr[-4000:]
    ref = np.load(tmp_path / "reference.npz")
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
