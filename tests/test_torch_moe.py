"""The port's MoE family (repro_torch.models.modules.route_row / moe_ffn,
the dense_blocks prefix stack, Algorithm 2 over two stacked regions)
against the reference's (repro.models.modules._route_row / moe_ffn,
repro.core.arena.build_layout, repro.core.layerwise), on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.configs import get_config as jax_get_config
from repro.core import arena as jarena
from repro.models import model as jmodel
from repro.models import modules as jmd
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.models import model as tmodel
from repro_torch.models import modules as tmd

torch.set_num_threads(1)

ARCH = "deepseek_v2_lite_16b"
# moe_ffn in fp32 against the reference: the expert products and the
# shared experts' matmuls sum in another order than XLA's. Measured largest
# |difference|: y 4.7e-9 (of values up to 0.038), dx 7.9e-9 (of 0.044),
# the weights' gradients 2.4e-7 (of values up to 1.9); the aux loss equal
FFN_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _tcfg(**over):
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32", **over)


def _ids_and_gates(seed, s, k, e, skew=0.0):
    """Distinct top-k expert ids per token (expert 0 favoured by `skew`,
    which overflows its capacity) and positive gates."""
    rng = np.random.default_rng(seed)
    score = rng.random((s, e))
    score[:, 0] += skew
    ids = np.argsort(-score, axis=-1, kind="stable")[:, :k].astype(np.int32)
    gates = rng.random((s, k)).astype(np.float32) + 0.1
    return ids, gates


# (seq, top_k, experts, capacity, skew, x dtype)
ROUTE_CASES = {
    "overflow": (24, 2, 4, 5, 0.5, np.float32),
    "overflow-bf16": (24, 2, 4, 5, 0.5, jnp.bfloat16),
    "no-drop": (16, 3, 8, 16, 0.0, np.float32),
    "one-slot": (9, 2, 4, 1, 0.0, np.float32),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_row_matches_reference_bit_for_bit(case):
    """buf, tok_slot and gate_slot equal the reference's exactly, dropped
    copies (past the capacity) included; the batched form equals the rows
    one by one."""
    s, k, e, cap, skew, dtype = ROUTE_CASES[case]
    rows = []
    for r in range(2):
        ids, gates = _ids_and_gates(10 + r, s, k, e, skew)
        x = np.random.default_rng(20 + r).standard_normal(
            (s, 16)).astype(np.float32)
        jbuf, jtok, jgate = jmd._route_row(jnp.asarray(ids),
                                           jnp.asarray(gates),
                                           jnp.asarray(x, dtype), e, cap)
        tx = torch.from_numpy(x).to(torch.bfloat16 if dtype is jnp.bfloat16
                                    else torch.float32)
        buf, tok, gate = tmd.route_row(torch.from_numpy(ids).long(),
                                       torch.from_numpy(gates), tx, e, cap)
        assert buf.dtype == tx.dtype and buf.shape == (e * cap, 16)
        assert np.array_equal(buf.float().numpy(),
                              np.asarray(jbuf, np.float32))
        assert np.array_equal(tok.numpy(), np.asarray(jtok))
        assert np.array_equal(gate.numpy(), np.asarray(jgate))
        if case.startswith("overflow"):            # some copies dropped
            assert int((np.asarray(jgate) > 0).sum()) < s * k
        rows.append((torch.from_numpy(ids).long(), torch.from_numpy(gates),
                     tx, buf, tok, gate))
    batched = tmd.route_row(*(torch.stack([r[i] for r in rows])
                              for i in range(3)), e, cap)
    for i, got in enumerate(batched):
        assert torch.equal(got, torch.stack([r[3 + i] for r in rows]))


@pytest.mark.parametrize("case", ["overflow", "no-drop"])
def test_route_row_gradients_match_reference(case):
    """The dispatch's and the gate map's backward (each token's slots summed
    in ascending slot order, dropped copies given nothing) against
    jax.vjp of `_route_row`, bit for bit in fp32."""
    s, k, e, cap, skew, _ = ROUTE_CASES[case]
    ids, gates = _ids_and_gates(30, s, k, e, skew)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((s, 16)).astype(np.float32)
    dbuf = rng.standard_normal((e * cap, 16)).astype(np.float32)
    dgate = rng.standard_normal((e * cap,)).astype(np.float32)
    _, vjp = jax.vjp(lambda g, xr: (lambda o: (o[0], o[2]))(
        jmd._route_row(jnp.asarray(ids), g, xr, e, cap)),
        jnp.asarray(gates), jnp.asarray(x))
    jdg, jdx = vjp((jnp.asarray(dbuf), jnp.asarray(dgate)))
    tg = torch.from_numpy(gates).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    buf, _, gate = tmd.route_row(torch.from_numpy(ids).long(), tg, tx, e,
                                 cap)
    tdg, tdx = torch.autograd.grad((buf, gate), (tg, tx), grad_outputs=(
        torch.from_numpy(dbuf), torch.from_numpy(dgate)))
    assert np.array_equal(tdx.numpy(), np.asarray(jdx))
    assert np.array_equal(tdg.numpy(), np.asarray(jdg))


@pytest.mark.parametrize("ties", ["all", "pairs"])
def test_top_k_breaks_ties_as_lax_top_k(ties):
    """Equal probs pick the lower expert first, as lax.top_k does: a zero
    router (every prob 1/E) sends every token to experts 0..k-1."""
    e, k = 8, 3
    if ties == "all":
        probs = np.full((5, e), 1.0 / e, np.float32)
    else:
        probs = np.repeat(np.random.default_rng(4).random((5, e // 2)),
                          2, axis=-1).astype(np.float32)
    jg, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tg, ti = tmd.moe_top_k(torch.from_numpy(probs), k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    if ties == "all":
        assert np.array_equal(ti.numpy(), np.broadcast_to(np.arange(k),
                                                          (5, k)))


def _moe_block(seed, zero_router=False):
    jcfg = tiny(ARCH)
    block = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(
        jcfg, jax.random.key(seed))["blocks"])
    if zero_router:
        block["router"] = np.zeros_like(block["router"])
    keys = [k for k in block if k == "router" or k.endswith(("_e", "_s"))]
    return jcfg, {k: block[k] for k in keys}


@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_ffn_and_its_gradients_match_reference(zero_router):
    """y and the aux loss, and the gradients of (y, aux) with respect to x
    and every MoE leaf, against jax.vjp of the reference's moe_ffn (fp32
    compute, 4 experts, top-2, one shared expert, capacity 10 at seq 16:
    some copies dropped); the top-k ids are the reference's. With a zero
    router every token routes to experts 0 and 1, which overflow."""
    jcfg, block = _moe_block(2, zero_router)
    tcfg = _tcfg()
    x = np.random.default_rng(5).standard_normal(
        (3, 16, jcfg.d_model)).astype(np.float32)
    rng = np.random.default_rng(6)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    daux = np.float32(0.7)
    (jy, jaux), vjp = jax.vjp(lambda p, xx: jmd.moe_ffn(jcfg, p, xx),
                              block, jnp.asarray(x))
    jdp, jdx = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in block.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = tmd.moe_ffn(tcfg, tp, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **FFN_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    keys = sorted(tp)
    *tdp, tdx = torch.autograd.grad(
        (ty, taux), [tp[k] for k in keys] + [tx],
        grad_outputs=(torch.from_numpy(dy), torch.tensor(daux)))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **GRAD_TOL)
    for k, g in zip(keys, tdp):
        np.testing.assert_allclose(g.numpy(), np.asarray(jdp[k]),
                                   err_msg=k, **GRAD_TOL)
    # the same experts picked
    logits = (x @ block["router"]).astype(np.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 2)
    _, tids = tmd.moe_top_k(torch.softmax(torch.from_numpy(logits), -1), 2)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    if zero_router:
        assert (tids.numpy() == np.arange(2)).all()
        # the aux loss's gradient reaches the router
        assert float(np.abs(np.asarray(jdp["router"])).max()) > 0


def _meta_tree(cfg):
    meta = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.key(0)))
    return meta, jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), meta)


@pytest.mark.parametrize("which", ["reduced", "full-width-4-layers"])
def test_layout_matches_reference_row_for_row(which):
    """The arena layout of the two stacked regions: `blocks` before
    `dense_blocks` (the reference's STACK_KEYS order) though the forward
    runs dense_blocks first; at full width and 4 layers, 3 MoE layers of
    571,200 rows from row 0, the dense layer's 79,168 from 1,713,600, the
    rest's 409,664 from 1,792,768: 2,202,624 rows."""
    if which == "reduced":
        jcfg = tiny(ARCH)
        gen = torch.Generator()
        gen.manual_seed(0)
        ttree = tmodel.init_params(_tcfg(), gen)
        jtree = jmodel.init_params(jcfg, jax.random.key(0))
    else:
        jcfg = dataclasses.replace(jax_get_config(ARCH), num_layers=4)
        jtree, ttree = _meta_tree(jcfg)
    jl, tl = jarena.build_layout(jtree), tarena.build_layout(ttree)
    assert tl.rows == jl.rows
    for name in ("blocks", "dense_blocks"):
        js, ts = jl.stack(name), tl.stack(name)
        assert (ts.row, ts.layer_rows, ts.n_layers) == \
            (js.row, js.layer_rows, js.n_layers), name
        assert ts.paths == tuple((k,) for k in sorted(ttree[name])), name
        assert [(x.row, x.rows) for x in ts.leaves] == \
            [(x.row, x.rows) for x in js.leaves], name
        assert tl.slice_block(ts) == jl.slice_block(js)
    assert (tl.rest.row, tl.rest.rows) == (jl.rest.row, jl.rest.rows)
    assert tl.stack("blocks").row < tl.stack("dense_blocks").row
    if which != "reduced":
        b, d = tl.stack("blocks"), tl.stack("dense_blocks")
        assert (b.row, b.layer_rows, b.n_layers, d.row, d.layer_rows,
                tl.rest.row, tl.rest.rows, tl.rows) == (
            0, 571_200, 3, 1_713_600, 79_168, 1_792_768, 409_664,
            2_202_624)


def _layerwise_run(cfg, arena=True, record=None, engine="adama_layerwise"):
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tmodel.Model(cfg, tmodel.init_params(cfg, gen))
    step, init = make_train_step(cfg, OptimizerConfig(
        accumulation=engine, micro_batches=2, arena=arena))
    tree = model.tree()
    state = init(tree)
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 16, 4, seed=1).batch(0).items()}
    tree, state, metrics = step(tree, state, batch)
    return tree, state, metrics


def test_layerwise_folds_blocks_then_dense_blocks_then_the_rest(
        monkeypatch):
    """Per micro-batch, at 3 layers (2 MoE, 1 dense): the slice folds of
    blocks 1, 0, then dense_blocks 0, then the rest region, each at its
    arena offset."""
    calls = []
    orig = tfs.arena_fold_slice

    def record(m, v, g, row_offset, **kw):
        calls.append((row_offset, g.shape[0]))
        return orig(m, v, g, row_offset, **kw)
    monkeypatch.setattr(tfs, "arena_fold_slice", record)
    _, state, _ = _layerwise_run(_tcfg(num_layers=3))
    lay = state["m"].layout
    b, d = lay.stack("blocks"), lay.stack("dense_blocks")
    assert (b.n_layers, d.n_layers) == (2, 1)
    want = [(b.row + b.layer_rows, b.layer_rows), (b.row, b.layer_rows),
            (d.row, d.layer_rows), (lay.rest.row, lay.rest.rows)]
    assert calls == want * 2


def test_layerwise_equals_adama_and_the_aux_reaches_the_router():
    """Algorithm 2 over the two stacks computes Algorithm 1's step
    (test_torch_layerwise's tolerances); with router_aux_weight 0 the
    routers' first moments change in both, so the aux loss's gradient
    reaches them through the layer-wise backward's seed."""
    out = {}
    for w in (0.001, 0.0):
        cfg = _tcfg(num_layers=3)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_aux_weight=w))
        for engine in ("adama", "adama_layerwise"):
            _, state, metrics = _layerwise_run(cfg, engine=engine)
            lay = state["m"].layout
            spec = lay.stack("blocks")
            leaf = spec.leaves[spec.paths.index(("router",))]
            rows = [state["m"].data[spec.row + j * spec.layer_rows + leaf.row:
                                    spec.row + j * spec.layer_rows +
                                    leaf.row + leaf.rows]
                    for j in range(spec.n_layers)]
            out[w, engine] = (state["m"].data, torch.cat(rows),
                              float(metrics["loss"]))
    for w in (0.001, 0.0):
        (ma, ra, la), (ml, rl, ll) = out[w, "adama"], \
            out[w, "adama_layerwise"]
        assert float((ma - ml).abs().max()) < 5e-7
        assert abs(la - ll) < 1e-5
    for engine in ("adama", "adama_layerwise"):
        with_aux, without = out[0.001, engine][1], out[0.0, engine][1]
        assert not torch.equal(with_aux, without)
        assert out[0.001, engine][2] > out[0.0, engine][2]


def test_cli_trains_the_moe_family_with_a_depth_cut(capsys):
    """launch/train.py takes deepseek-v2-lite-16b and sets its depth with
    --num-layers (the card runs it at 4 of its 27 layers: the dense prefix
    and 3 MoE layers)."""
    from repro_torch.launch.train import main
    main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--num-layers",
          "3", "--steps", "2", "--global-batch", "2", "--micro-batches",
          "2", "--seq-len", "24", "--accumulation", "adama_layerwise",
          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] done; final loss" in out, out


def test_remat_equals_the_plain_forward_bit_for_bit():
    """loss_fn with each layer checkpointed (its (x, aux) recomputed in the
    backward) equals the plain one: loss and every gradient bit for bit."""
    cfg = _tcfg(num_layers=3)
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = tmodel.init_params(cfg, gen)
    leaves, _ = tarena.tree_flatten(tree)
    for x in leaves:
        x.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             make_data(cfg, 16, 2, seed=2).batch(0).items()}
    out = []
    for remat in (False, True):
        loss = tmodel.loss_fn(cfg, tree, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
