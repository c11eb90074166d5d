"""The bucketed ZeRO-1 plan and its helpers (repro_torch.core.buckets,
`arena.pack_stack_layers` / `pack_rest_rows`, `zero.zero1_bucket_plan`)
against the reference's, in this process (no ranks):

- plans: bucket for bucket, field for field, with the derived numbers
  (`shard_rows`, `grad_buckets`, `max_grad_bucket_bytes`,
  `grad_peak_bytes`, `stack_slice`, `tp_subslice`) and the same ValueError
  on a layout not built for the mesh, on the reduced bert-large,
  stablelm-1.6b, deepseek-v2-lite-16b (two stacked regions) and
  whisper-base (three regions) and bert-large's full layout, for M in {1,
  2, 3, 4, 8}, tp 1 and 2, the default cap and a small one that cuts the
  rest region inside a leaf;
- packs: every bucket's slab, `pack_stack_layers` over layer ranges and
  `pack_rest_rows` over cuts inside leaves, equal to the reference's and
  to the rows of the whole pack, bit for bit (fp32 and bf16);
- the permutation: `partition_index` and `gather_owned_rows` equal the
  reference's; `permute_rows` / `unpermute_rows` and `permute_state` /
  `unpermute_state` round-trip bit for bit; `pack_owned_rows` and
  `unpermute_into_` (the engine's apply) equal the gather of the whole
  pack and the unpack of its unpermuted rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.core import buckets as jbuckets
from repro.core import zero as jzero
from repro.models.model import init_params as jax_init_params
from repro_torch.core import arena as tarena
from repro_torch.core import buckets as tbuckets
from repro_torch.core import state_store
from repro_torch.core import zero as tzero
from repro_torch.core.adama import init_arena

ARCHS = ("bert_large", "stablelm_1_6b", "deepseek_v2_lite_16b",
         "whisper_base")
SHARDS = (1, 2, 3, 4, 8)
# a small rest cap: it cuts the reduced models' rest regions inside leaves
SMALL_CAP = 40


def _abstract_trees(cfg):
    jtree = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.key(0)))
    ttree = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), jtree)
    return jtree, ttree


def _random_trees(cfg, seed=0):
    """The same random values as a jax tree and a torch tree."""
    jtree, _ = _abstract_trees(cfg)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jtree)
    vals = [rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    return (jax.tree.unflatten(treedef, [jnp.asarray(v) for v in vals]),
            jax.tree.unflatten(treedef, [torch.from_numpy(v) for v in vals]))


def _fields(b):
    return (b.start, b.rows, b.slice_rows, b.own_offset, b.kind, b.name,
            b.layer_lo, b.layer_hi, b.has_grad, b.fold_block)


def _plan_or_error(mod, layout, n, tp, cap):
    try:
        return mod.zero1_bucket_plan(layout, n, cap, tp_shards=tp)
    except ValueError as e:
        return str(e)


def _same_plan(jp, tp_):
    if isinstance(jp, str):
        assert tp_ == jp
        return
    assert not isinstance(tp_, str), tp_
    assert [_fields(b) for b in tp_.buckets] == \
        [_fields(b) for b in jp.buckets]
    assert (tp_.n_shards, tp_.tp_shards, tp_.shard_rows) == \
        (jp.n_shards, jp.tp_shards, jp.shard_rows)
    assert [_fields(b) for b in tp_.grad_buckets()] == \
        [_fields(b) for b in jp.grad_buckets()]
    assert tp_.max_grad_bucket_rows == jp.max_grad_bucket_rows
    assert tp_.max_grad_bucket_bytes == jp.max_grad_bucket_bytes
    assert tp_.grad_peak_bytes(2) == jp.grad_peak_bytes(2)
    for s in jp.layout.stacks:
        assert tp_.stack_slice(s.name) == jp.stack_slice(s.name)
    for b in jp.buckets:
        for t in range(jp.tp_shards):
            assert tp_.tp_subslice(b, t) == jp.tp_subslice(b, t)
    with pytest.raises(IndexError):
        tp_.tp_subslice(tp_.buckets[0], tp_.tp_shards)
    with pytest.raises(KeyError):
        tp_.stack_slice("nope")


@pytest.mark.parametrize("cap", (0, SMALL_CAP), ids=("default", "small"))
@pytest.mark.parametrize("tp", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_reference(arch, tp, cap):
    jtree, ttree = _abstract_trees(tiny(arch))
    for n in SHARDS:
        jl = jarena.build_layout(jtree, n_shards=n, tp_shards=tp)
        tl = tarena.build_layout(ttree, n_shards=n, tp_shards=tp)
        assert jl.rows == tl.rows
        for m in SHARDS:              # m != n: a layout not built for m
            _same_plan(_plan_or_error(jzero, jl, m, tp, cap),
                       _plan_or_error(tzero, tl, m, tp, cap))
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tzero.zero1_bucket_plan(tl, 1, tp_shards=bad)


def test_small_cap_cuts_rest_leaves():
    """The small cap's rest buckets start inside a leaf on every model:
    the packs below then cross mid-leaf cuts."""
    for arch in ARCHS:
        _, ttree = _abstract_trees(tiny(arch))
        lay = tarena.build_layout(ttree, n_shards=2)
        plan = tzero.zero1_bucket_plan(lay, 2, SMALL_CAP)
        inside = [b for b in plan.buckets if b.kind == "rest" and any(
            lay.rest.row + ls.row < b.start < lay.rest.row + ls.row + ls.rows
            for ls in lay.rest.leaves)]
        assert inside, arch


@pytest.mark.parametrize("tp", (1, 2))
def test_bert_large_full_plans_match_reference(tp):
    """bert-large's full layout: 24 layer buckets of 12,352 rows and 15
    rest buckets (14 x 4,096 + 3,904) at M = 1; a padding bucket of 192
    rows at M = 1, 704 at M = 4."""
    jtree, ttree = _abstract_trees(jax_get_config("bert_large"))
    for n in SHARDS:
        jl = jarena.build_layout(jtree, n_shards=n, tp_shards=tp)
        tl = tarena.build_layout(ttree, n_shards=n, tp_shards=tp)
        _same_plan(_plan_or_error(jzero, jl, n, tp, 0),
                   _plan_or_error(tzero, tl, n, tp, 0))
    if tp == 1:
        plan = tzero.zero1_bucket_plan(tarena.build_layout(ttree), 1)
        kinds = [b.kind for b in plan.buckets]
        assert kinds == ["stack"] * 24 + ["rest"] * 15 + ["pad"]
        assert {b.rows for b in plan.buckets[:24]} == {12_352}
        assert [b.rows for b in plan.buckets[24:39]] == [4096] * 14 + [3904]
        assert plan.buckets[-1].rows == 192
        assert sum(b.rows for b in plan.grad_buckets()) == 357_696
        plan4 = tzero.zero1_bucket_plan(
            tarena.build_layout(ttree, n_shards=4), 4)
        assert plan4.buckets[-1].rows == 704
        assert {b.slice_rows for b in plan4.grad_buckets()} == \
            {3088, 1024, 976}


def _np(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def _jnp(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_packs_match_reference_and_the_whole_pack(arch, dtype):
    jtree, ttree = _random_trees(tiny(arch))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for n, cap in ((1, 0), (2, SMALL_CAP), (4, SMALL_CAP)):
        lay = tarena.build_layout(ttree, n_shards=n)
        jl = jarena.build_layout(jtree, n_shards=n)
        whole = _np(tarena.pack(ttree, lay, dtype=tdt))
        assert np.array_equal(whole, _jnp(jarena.pack(jtree, jl, dtype=jdt)))
        plan = tzero.zero1_bucket_plan(lay, n, cap)
        jplan = jzero.zero1_bucket_plan(jl, n, cap)
        for b, jb in zip(plan.buckets, jplan.buckets):
            got = _np(tbuckets.pack_bucket(ttree, lay, b, dtype=tdt))
            assert np.array_equal(got, whole[b.start:b.stop]), b
            assert np.array_equal(got, _jnp(jbuckets.pack_bucket(
                jtree, jl, jb, dtype=jdt))), b
        for spec, jspec in zip(lay.stacks, jl.stacks):
            for j0, j1 in ((0, spec.n_layers), (spec.n_layers - 1,
                                                spec.n_layers)):
                got = _np(tarena.pack_stack_layers(ttree[spec.name], spec,
                                                   j0, j1, dtype=tdt))
                lo = spec.row + j0 * spec.layer_rows
                assert np.array_equal(
                    got, whole[lo:spec.row + j1 * spec.layer_rows])
                assert np.array_equal(got, _jnp(jarena.pack_stack_layers(
                    jtree[spec.name], jspec, j0, j1, dtype=jdt)))
        rest = lay.rest
        _, trest = tarena.split_tree(ttree)
        _, jrest = jarena.split_tree(jtree)
        for lo, hi in ((rest.row, rest.row + rest.rows),
                       (rest.row + 3, rest.row + rest.rows - 5),
                       (rest.row + 1, rest.row + 2)):
            got = _np(tarena.pack_rest_rows(trest, lay, lo, hi, dtype=tdt))
            assert np.array_equal(got, whole[lo:hi])
            assert np.array_equal(got, _jnp(jarena.pack_rest_rows(
                jrest, jl, lo, hi, dtype=jdt)))


def test_pack_helpers_refuse_what_the_reference_refuses():
    _, ttree = _random_trees(tiny("stablelm_1_6b"))
    lay = tarena.build_layout(ttree)
    spec = lay.stacks[0]
    _, trest = tarena.split_tree(ttree)
    for j0, j1 in ((0, 0), (-1, 1), (0, spec.n_layers + 1)):
        with pytest.raises(ValueError):
            tarena.pack_stack_layers(ttree["blocks"], spec, j0, j1)
    for lo, hi in ((lay.rest.row - 1, lay.rest.row + 1),
                   (lay.rest.row + 2, lay.rest.row + 2)):
        with pytest.raises(ValueError):
            tarena.pack_rest_rows(trest, lay, lo, hi)
    with pytest.raises(TypeError):
        tarena.pack_rest_rows(trest, lay, lay.rest.row, lay.rest.row + 1,
                              dtype=torch.float8_e4m3fn)


@pytest.mark.parametrize("n", (1, 2, 3, 4))
@pytest.mark.parametrize("arch", ("stablelm_1_6b", "whisper_base"))
def test_permutation_matches_reference_and_round_trips(arch, n):
    jtree, ttree = _random_trees(tiny(arch), seed=n)
    for cap in (0, SMALL_CAP):
        lay = tarena.build_layout(ttree, n_shards=n)
        jl = jarena.build_layout(jtree, n_shards=n)
        plan = tzero.zero1_bucket_plan(lay, n, cap)
        jplan = jzero.zero1_bucket_plan(jl, n, cap)
        perm = tbuckets.partition_index(plan)
        assert perm.dtype == np.int32
        assert np.array_equal(perm, jbuckets.partition_index(jplan))
        assert np.array_equal(np.sort(perm), np.arange(lay.rows))
        arena = tarena.pack(ttree, lay)
        jarena_ = jarena.pack(jtree, jl)
        owned = [tbuckets.gather_owned_rows(arena, plan, k) for k in range(n)]
        for k, x in enumerate(owned):
            assert x.shape == (plan.shard_rows, tarena.LANES)
            assert np.array_equal(x.numpy(), np.asarray(
                jbuckets.gather_owned_rows(jarena_, jplan, k)))
            assert np.array_equal(
                tbuckets.pack_owned_rows(ttree, plan, k).numpy(), x.numpy())
        part = torch.cat(owned)             # what an all-gather gives
        assert np.array_equal(tbuckets.permute_rows(arena, plan).numpy(),
                              part.numpy())
        assert np.array_equal(tbuckets.unpermute_rows(part, plan).numpy(),
                              arena.numpy())
        assert np.array_equal(tbuckets.unpermute_rows(part, plan).numpy(),
                              np.asarray(jbuckets.unpermute_rows(
                                  jnp.asarray(part.numpy()), jplan)))
        # the engine's apply: the leaves from the partition-order rows
        out = jax.tree.map(torch.zeros_like, ttree)
        tbuckets.unpermute_into_(out, part, plan)
        for a, b in zip(tarena.tree_flatten(out)[0],
                        tarena.tree_flatten(ttree)[0]):
            assert np.array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("pair", (("fp32", "fp32"), ("int8", "int8"),
                                  ("int8", "rowcol"), ("fp32", "factored")),
                         ids=lambda p: "-".join(p))
def test_state_permutation_round_trips(pair):
    """permute_state / unpermute_state move every global row-indexed
    column (and the regions beside the moments) and pass the shared
    columns, the step and the scaler through, bit for bit."""
    _, ttree = _random_trees(tiny("stablelm_1_6b"))
    lay = tarena.build_layout(ttree, n_shards=2)
    plan = tzero.zero1_bucket_plan(lay, 2, SMALL_CAP)
    state = init_arena(ttree, codec=pair[1], m_codec=pair[0], n_shards=2)
    gen = torch.Generator().manual_seed(3)
    for k in ("m", "v"):
        for x in state_store.codec_of(state[k], k).parts_of(state[k]):
            x.copy_(torch.randint(-100, 100, x.shape, generator=gen)
                    .to(x.dtype))
    state["p"] = tarena.Arena(tarena.pack(ttree, lay), lay)
    state["scaler"] = {"scale": torch.ones(())}
    perm = tbuckets.permute_state(state, plan)
    back = tbuckets.unpermute_state(perm, plan)
    assert perm["step"] is state["step"] and \
        perm["scaler"] is state["scaler"]
    for k in ("m", "v"):
        parts = state_store.codec_of(state[k], k).parts_of(state[k])
        pparts = state_store.codec_of(perm[k], k).parts_of(perm[k])
        bparts = state_store.codec_of(back[k], k).parts_of(back[k])
        for x, y, z in zip(parts, pparts, bparts):
            assert torch.equal(x, z)
            if x.shape[0] == lay.rows:
                assert torch.equal(y, tbuckets.permute_rows(x, plan))
            else:                               # rowcol's column sums
                assert y is x
    assert torch.equal(back["p"].data, state["p"].data)
    assert torch.equal(perm["p"].data,
                       tbuckets.permute_rows(state["p"].data, plan))
