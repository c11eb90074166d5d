"""The bucketed ZeRO-1 schedule and Algorithm 2's ZeRO-1 stream on M = 2
and 4 gloo ranks (spawned once per module and M, tests/_dp_worker.py), on
the reduced stablelm-1.6b (a causal LM, as tests/test_torch_zero.py says
why):

- bucketed ZeRO-1 (the default schedule) for the seven codec pairs of
  tests/test_torch_zero.py against the full-pack run, the bucketed state
  unpermuted to arena order: at M = 2 every row-local pair bit for bit in
  params, losses, m and v (a sum of two float32 values does not depend on
  their order); at M = 4 and for rowcol within the tolerances below, the
  measured differences stated; a small rest cap (cuts inside leaves)
  likewise;
- bucketed ZeRO-1 against the single-device adama on the reordered batch,
  as test_torch_zero.py holds the full pack (at M = 4 on a pair of each
  codec of each moment, and the rowcol pairs at M = 2: the others equal
  the full pack there bit for bit);
- the stream (`adama_layerwise` under ZeRO-1) against the port's
  single-device adama_layerwise on the reordered batch, for fp32/fp32,
  int8/int8 and int8/rowcol, within the full-pack test's tolerances;
- one bad rank (`nan@micro=1,device=1`) equals `skip@micro=1` bit for bit,
  for the bucketed schedule and the stream;
- each rank's row-indexed columns hold rows / M rows;
- at N = 4, the bucketed schedule's and the stream's collectives a step:
  N x (gradient buckets) reduce-scatters + 1 all-gather, moving the full
  pack's bytes less N x the padding bucket's.
"""
import numpy as np
import pytest

from _dp_worker import (LR, collect, init_tree, model_config, run,
                        start_ranks)
from repro_torch.core import arena as tarena
from repro_torch.core import buckets as tbuckets
from repro_torch.core import state_store
from repro_torch.core import zero as tzero
from repro_torch.kernels import fused_step
from test_torch_engines import ENGINE_TOL
from test_torch_zero import (CODE_REL, DP_ARCH, FP32_REL, GB,
                             LOSSY_LOSS_TOL, N_MICRO, PAIRS7, ZERO1,
                             ZERO1_STEPS, _assert_same_params_on_every_rank,
                             _decoded, _whole)

STREAM_PAIRS = (("fp32", "fp32"), ("int8", "int8"), ("int8", "rowcol"))
# a rest cap that cuts the reduced stablelm's rest region inside leaves
SMALL_CAP = 64
# rowcol's column sums: the buckets' partials added in bucket order
# against the whole arena's one fold (queue 3 (j))
COLSUM_REL = 1e-6
# at M = 4 gloo adds a bucket's four addends in another order than the
# whole arena's: the bucketed schedule against the full pack measured
# 3.4e-8 in params on the fp32-m pairs (4.2e-4 with int8 m, a code step),
# 1.6e-7 relative in fp32 columns (2.8e-3 in int8 m); at M = 2 rowcol's
# bucket-by-bucket column sums move the params by 1.2e-7


def _cases(m, steps):
    out = []
    base = dict(variant="adama", warmup=True, arch=DP_ARCH, gb=GB,
                steps=steps)
    for mc, vc in PAIRS7:
        kw = dict(micro_batches=N_MICRO, m_codec=mc, state_codec=vc)
        out += [(f"full-{mc}-{vc}", dict(base, opt_kw=dict(kw, **ZERO1))),
                (f"bucketed-{mc}-{vc}", dict(base, opt_kw=dict(
                    kw, zero_stage=1)))]
        if (mc, vc) in STREAM_PAIRS:
            out.append((f"stream-{mc}-{vc}", dict(
                base, variant="adama_layerwise",
                opt_kw=dict(kw, zero_stage=1))))
    out.append(("capped", dict(base, opt_kw=dict(
        micro_batches=N_MICRO, zero_stage=1, zero_bucket_rows=SMALL_CAP))))
    if m == 2:
        g = dict(micro_batches=N_MICRO, finite_guard=True, zero_stage=1)
        for variant in ("adama", "adama_layerwise"):
            label = "stream" if variant == "adama_layerwise" else "bucketed"
            for fault in ("nan@micro=1,device=1", "skip@micro=1"):
                out.append((f"guarded-{label}-{fault.partition('@')[0]}",
                            dict(opt_kw=g, variant=variant, arch=DP_ARCH,
                                 gb=GB, fault=fault)))
            out.append((f"bytes-{label}", dict(
                opt_kw=dict(micro_batches=4, zero_stage=1), variant=variant,
                arch=DP_ARCH, gb=GB, steps=1)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{M: each rank's results} for M = 2 and 4."""
    d = tmp_path_factory.mktemp("zs")
    jobs = {m: start_ranks(m, d, f"m{m}", _cases(m, ZERO1_STEPS[m]))
            for m in (2, 4)}
    return {m: collect(job) for m, job in jobs.items()}


def _perm(m, cap=0):
    """partition_index of the reduced model's layout for M ranks."""
    lay = tarena.build_layout(init_tree(model_config(DP_ARCH)), n_shards=m)
    return tbuckets.partition_index(tzero.zero1_bucket_plan(lay, m, cap))


def _arena_order(res, name, k, perm):
    """Moment k's global columns in arena order: the ranks' partition-
    order rows of a row-indexed column unpermuted, a shared one as is."""
    return [x[perm] if x.shape[0] == perm.shape[0] else x
            for x in _whole(res, name, k)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("pair", PAIRS7 + (("capped", ""),),
                         ids=lambda p: "-".join(x for x in p if x))
def test_bucketed_equals_the_full_pack(ranks, m, pair):
    res = ranks[m]
    capped = pair[0] == "capped"
    name = "capped" if capped else f"bucketed-{pair[0]}-{pair[1]}"
    full = "full-fp32-fp32" if capped else f"full-{pair[0]}-{pair[1]}"
    _assert_same_params_on_every_rank(res, name)
    perm = _perm(m, SMALL_CAP if capped else 0)
    rowcol, lossy = pair[1] == "rowcol", "int8" in pair
    got, want = res[0][name], res[0][full]
    assert got["layout_rows"] == want["layout_rows"] == perm.shape[0]
    if m == 2 and not rowcol:
        assert got["losses"] == want["losses"]
        assert np.array_equal(got["params"], want["params"])
    else:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=LOSSY_LOSS_TOL if lossy else 1e-6)
        np.testing.assert_allclose(
            got["params"], want["params"], rtol=0,
            atol=(state_store.get_codec("int8").conformance.drift_lr * LR
                  * ZERO1_STEPS[m] if lossy else ENGINE_TOL))
    for k in ("m", "v"):
        a = _arena_order(res, name, k, perm)
        b = _whole(res, full, k)
        for j, (x, y) in enumerate(zip(a, b)):
            if m == 2 and not rowcol:
                assert np.array_equal(x, y), (k, j)
            elif x.shape[0] == 1:               # rowcol's column sums
                assert _rel(x, y) <= COLSUM_REL, (k, j, _rel(x, y))
        codec = "fp32" if capped else pair[k == "v"]
        rel = _rel(_decoded(codec, k, a), _decoded(codec, k, b))
        assert rel <= (CODE_REL if lossy else FP32_REL), (k, rel)


# at M = 2 the row-local pairs equal the full pack bit for bit (above),
# which tests/test_torch_zero.py holds against one device; at M = 4 a
# pair of each codec of each moment
ONE_DEVICE = [(4, p) for p in (("fp32", "fp32"), ("fp32", "factored"),
                               ("int8", "int8"), ("int8", "rowcol"))] + \
    [(2, p) for p in PAIRS7 if p[1] == "rowcol"]


@pytest.mark.parametrize("m, pair", ONE_DEVICE,
                         ids=lambda x: "-".join(x) if isinstance(x, tuple)
                         else str(x))
def test_bucketed_matches_single_device_on_the_reordered_batch(ranks, m,
                                                               pair):
    _check_one_device(ranks[m], m, f"bucketed-{pair[0]}-{pair[1]}", pair,
                      "adama")


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("pair", STREAM_PAIRS, ids=lambda p: "-".join(p))
def test_stream_matches_single_device_layerwise(ranks, m, pair):
    _check_one_device(ranks[m], m, f"stream-{pair[0]}-{pair[1]}", pair,
                      "adama_layerwise")


def _check_one_device(res, m, name, pair, engine):
    """`name` against the port's single-device `engine` on the reordered
    batch (one device's micro-batch i = every rank's micro-batch i), the
    arena laid out for M shards alike, with test_torch_zero.py's
    tolerances."""
    _assert_same_params_on_every_rank(res, name)
    want = run(dict(micro_batches=N_MICRO, m_codec=pair[0],
                    state_codec=pair[1], accumulation=engine), arch=DP_ARCH,
               gb=GB, warmup=True, reorder=(m, N_MICRO), state_shards=m,
               steps=ZERO1_STEPS[m])
    got = res[0][name]
    lossy = "int8" in pair
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSSY_LOSS_TOL if lossy else 1e-5)
    np.testing.assert_allclose(
        got["params"], want["params"], rtol=0,
        atol=(state_store.get_codec("int8").conformance.drift_lr * LR
              * ZERO1_STEPS[m] if lossy else ENGINE_TOL))
    perm = _perm(m)
    for k, codec in (("m", pair[0]), ("v", pair[1])):
        a = _decoded(codec, k, _arena_order(res, name, k, perm))
        b = _decoded(codec, k, want[k])
        assert _rel(a, b) <= (CODE_REL if lossy else FP32_REL), k
    assert got["step"] == ZERO1_STEPS[m]


@pytest.mark.parametrize("label", ("bucketed", "stream"))
def test_one_bad_rank_equals_the_forced_skip(ranks, label):
    for r in ranks[2]:
        a, b = r[f"guarded-{label}-nan"], r[f"guarded-{label}-skip"]
        assert np.array_equal(a["params"], b["params"])
        assert a["losses"] == b["losses"]
        for k in ("m", "v"):
            assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
        assert a["step"] == b["step"] == 2
        assert a["scaler"] == b["scaler"]
        assert [x["skipped_micro_batches"] for x in a["metrics"]] == [1, 2]
    _assert_same_params_on_every_rank(ranks[2], f"guarded-{label}-nan")


@pytest.mark.parametrize("m", (2, 4))
def test_each_rank_holds_its_rows_of_every_row_indexed_column(ranks, m):
    names = [f"bucketed-{mc}-{vc}" for mc, vc in PAIRS7] + [
        f"stream-{mc}-{vc}" for mc, vc in STREAM_PAIRS]
    for name in names:
        _, mc, vc = name.split("-")
        for r in ranks[m]:
            got = r[name]
            rows = got["layout_rows"]
            for k, codec in (("m", mc), ("v", vc)):
                cols = state_store.get_codec(codec, k).kernel.cols
                for x, c in zip(got[k], cols):
                    assert x.shape == ((rows // m if c.row_indexed else 1),
                                       c.width), (name, k)


@pytest.mark.parametrize("label", ("bucketed", "stream"))
def test_collectives_a_step(ranks, label):
    """M = 2, N = 4, one step: a reduce-scatter a gradient bucket a
    micro-batch and one all-gather of the params, the full pack's bytes
    (N x A + A) less N x the padding bucket's, which is never sent."""
    r = ranks[2][0][f"bytes-{label}"]
    lay = tarena.build_layout(init_tree(model_config(DP_ARCH)), n_shards=2)
    plan = tzero.zero1_bucket_plan(lay, 2)
    n_b = len(plan.grad_buckets())
    a = lay.rows * fused_step.LANES * 4
    pad = sum(b.rows for b in plan.buckets if not b.has_grad) * \
        fused_step.LANES * 4
    coll = r["collectives"]
    assert coll["reduce_scatter"] == (4 * n_b, 4 * a - 4 * pad)
    assert coll["all_gather"] == (1, a)
    assert coll["all_reduce"] == (1, 4)                 # the loss
    calls = coll["reduce_scatter"][0] + coll["all_gather"][0]
    moved = coll["reduce_scatter"][1] + coll["all_gather"][1]
    assert (calls, moved) == (4 * n_b + 1, 4 * a + a - 4 * pad)
