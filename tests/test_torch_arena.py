"""The port's arena (repro_torch.core.arena) against the reference's
(repro.core.arena): the layout row for row, pack and unpack bit for bit,
for the reduced model trees and hand-made edge trees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.core import arena as jarena
from repro.models.model import init_params as jax_init_params
from repro_torch.core import arena as tarena

torch.set_num_threads(1)

# "+qlora": minicpm3 with a q low-rank projection (wq_a, q_norm, wq_b), which
# the reference's reduced config drops
ARCHS = ("bert_large", "stablelm_1_6b", "rwkv6_7b", "mistral_nemo_12b",
         "minicpm3_4b", "minicpm3_4b+qlora", "deepseek_v2_lite_16b",
         "hymba_1_5b")


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _hand_trees():
    """name -> numpy tree, plus the leaf paths cast to bf16."""
    rng = np.random.default_rng(0)
    lanes, block = tarena.LANES, tarena.BLOCK_ROWS
    return {
        "scalar_and_big": ({"s": _rand(rng, ()), "big": _rand(rng, (300, 150)),
                            "blocks": {"w": _rand(rng, (3, 257, 9)),
                                       "b": _rand(rng, (3, 5))}}, ()),
        "no_stack": ({"a": _rand(rng, (7,)), "z": _rand(rng, (2, 1100)),
                      "m": {"y": _rand(rng, (4,)), "x": _rand(rng, (33, 31))}},
                     ()),
        "bare_leaf": (_rand(rng, (5000,)), ()),
        "edge_mixed": ({"a": _rand(rng, (7,)), "b": _rand(rng, (300, 150)),
                        "blocks": {"w": _rand(rng, (3, 257, 9)),
                                   "s": _rand(rng, (3, 5))},
                        "c": _rand(rng, (block * lanes + 13,))},
                       (("b",), ("blocks", "s"))),
    }


def _trees(np_tree, bf16_paths):
    """The same tree for both packages (bf16 leaves rounded identically)."""
    leaves, paths = tarena.tree_flatten(np_tree)
    t_leaves = [torch.from_numpy(x.copy()) for x in leaves]
    j_leaves = [jnp.asarray(x) for x in leaves]
    for i, p in enumerate(paths):
        if p in bf16_paths:
            t_leaves[i] = t_leaves[i].to(torch.bfloat16)
            j_leaves[i] = j_leaves[i].astype(jnp.bfloat16)
    return (tarena.tree_unflatten(paths, j_leaves),
            tarena.tree_unflatten(paths, t_leaves))


def _model_tree(arch):
    arch, _, variant = arch.partition("+")
    over = {"qlora": dict(q_lora_rank=96)}.get(variant, {})
    params = jax_init_params(tiny(arch, **over), jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _jax_paths(tree):
    return tuple(tuple(k.key for k in path)
                 for path, _ in jax.tree_util.tree_leaves_with_path(tree))


def _same_leaves(jspecs, tspecs):
    assert len(jspecs) == len(tspecs)
    for js, ts in zip(jspecs, tspecs):
        assert tuple(js.shape) == ts.shape
        assert (js.row, js.rows) == (ts.row, ts.rows)
        assert np.dtype(js.dtype).name == str(ts.dtype).replace("torch.", "")


def _assert_same_layout(jtree, ttree):
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    assert jl.rows == tl.rows
    assert len(jl.stacks) == len(tl.stacks)
    jstack_items, jrest = jarena.split_tree(jtree)
    for (name, sub), js, ts in zip(jstack_items, jl.stacks, tl.stacks):
        assert (js.name, js.n_layers, js.layer_rows, js.row) == \
            (ts.name, ts.n_layers, ts.layer_rows, ts.row)
        assert _jax_paths(sub) == tuple(p for p in ts.paths)
        _same_leaves(js.leaves, ts.leaves)
    assert (jl.rest.row, jl.rest.rows) == (tl.rest.row, tl.rest.rows)
    if isinstance(jrest, dict):
        assert _jax_paths(jrest) == tl.rest.paths
    _same_leaves(jl.rest.leaves, tl.rest.leaves)
    return jl, tl


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_pack_match_reference_on_model_trees(arch):
    np_tree = _model_tree(arch)
    jtree, ttree = _trees(np_tree, ())
    jl, tl = _assert_same_layout(jtree, ttree)
    assert tarena.region_grain() == jarena.region_grain()
    jpacked = np.asarray(jarena.pack(jtree, jl))
    tpacked = tarena.pack(ttree, tl)
    assert tpacked.dtype == torch.float32
    assert np.array_equal(jpacked, tpacked.numpy())


@pytest.mark.parametrize("name", sorted(_hand_trees()))
def test_layout_and_pack_match_reference_on_edge_trees(name):
    np_tree, bf16 = _hand_trees()[name]
    jtree, ttree = _trees(np_tree, bf16)
    jl, tl = _assert_same_layout(jtree, ttree)
    jpacked = np.asarray(jarena.pack(jtree, jl))
    assert np.array_equal(jpacked, tarena.pack(ttree, tl).numpy())


@pytest.mark.parametrize("name", sorted(_hand_trees()) + list(ARCHS))
def test_unpack_matches_reference_bitwise(name):
    if name in ARCHS:
        np_tree, bf16 = _model_tree(name), ()
    else:
        np_tree, bf16 = _hand_trees()[name]
    jtree, ttree = _trees(np_tree, bf16)
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    # the same arbitrary arena (padding lanes included) through both unpacks
    rng = np.random.default_rng(1)
    arena = rng.standard_normal((tl.rows, tarena.LANES)).astype(np.float32)
    jout, _ = tarena.tree_flatten(jax.tree.map(
        np.asarray, jarena.unpack(jnp.asarray(arena), jl)))
    tout, tpaths = tarena.tree_flatten(tarena.unpack(torch.from_numpy(arena),
                                                     tl))
    assert tpaths == tarena.tree_flatten(ttree)[1]
    for j, t in zip(jout, tout):
        assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name
        assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
    # and unpack inverts pack
    back = tarena.unpack(tarena.pack(ttree, tl), tl)
    for a, b in zip(tarena.tree_flatten(ttree)[0], tarena.tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_tree_flatten_is_sorted_key_order_like_jax():
    tree = {"b": {"z": np.zeros(1), "a": np.zeros(2)}, "a": np.zeros(3),
            "blocks": {"c": np.zeros((2, 1))}}
    _, paths = tarena.tree_flatten(tree)
    assert paths == _jax_paths(tree)
    leaves = [np.full(1, i) for i in range(len(paths))]
    back = tarena.tree_unflatten(paths, leaves)
    assert tarena.tree_flatten(back)[1] == paths


def test_pack_rejects_a_tree_that_is_not_the_layouts():
    tree = {"a": torch.zeros(4), "blocks": {"w": torch.zeros(2, 3)}}
    layout = tarena.build_layout(tree)
    with pytest.raises(ValueError, match="does not match"):
        tarena.pack({"a": torch.zeros(4), "blocks": {"v": torch.zeros(2, 3)}},
                    layout)
