"""The paper's §3.3 data-parallel schedules (`repro/core/dp_shardmap.py`)
on a `torch.distributed` process group, one process per rank.

The reference runs them under `jax.shard_map` over a mesh's data axes;
here the group stands where the mesh stood: M is its size, the rank is the
reference's linear dp index, and each rank takes its contiguous block of
GB/M rows of the global batch (the block `P(dp_axes)` gives a device).
Params are replicated; every rank starts from the same ones (the same
seed) and applies the same update.

Variants (collectives/moved_bytes counts each one's volume, Fig. 7):

  ga     local gradients summed into a per-leaf fp32 tree (a + g/N, as
         XLA contracts it), ONE all-reduce of it / M, then plain Adam
         (optim/adam.py). Volume P a mini-batch.
  naive  every micro-batch's gradient tree all-reduced / (N*M) before it
         is folded: the strawman the paper rejects. Volume N*P.
  adama  the paper's schedule: each rank folds its LOCAL gradients into its
         local (m, v), v pre-scaled by M*b2 (Eq. 6), then one all-reduce of
         m / M and v / M^2 a mini-batch (Eqs. 7-8), then the apply.
         Volume 2P, whatever N; the same math as one device over N*M
         micro-batches. Arena state: the decay (b1, M*b2) fused into fold 0
         (one fold kernel a micro-batch, one apply a mini-batch); per-leaf
         state: a begin-minibatch pass, then the per-leaf kernels. With
         `finite_guard`, each micro-batch's verdict is taken on the local
         packed slab and agreed by an all-reduce before any fold commits
         (every rank skips, or none does, or the state sum would mix
         folded and unfolded ranks).

With OptimizerConfig(zero_stage=1) `adama` runs ROW-RANGE ZeRO-1 (the
paper's Table-3 "ZeRO-S1 + AdamA"), for every (m_codec, v_codec) pair:
each rank owns 1/M of every row-indexed state column (core/zero.py), each
micro-batch's gradient is reduce-scattered into the owned rows and folded
there at scale 1/(N*M): fully reduced before it enters v, so no M*b2
pre-scale. Rowcol's column sums, the one shared column, take the decay
b2/M on every rank and are summed once a mini-batch
(state_store.psum_replicated_state). The apply updates the owned param
rows, which one all-gather spreads. Nothing quantized is ever summed, so
every codec composes. Guarded, the verdict is taken on the received rows
and agreed before any fold. Two schedules (`zero_bucketed`):

  bucketed   (the default) the gradient goes one BUCKET at a time
             (core/buckets.py: a bucket per layer, size-capped buckets over
             the rest region): pack the bucket's rows, reduce-scatter, fold
             the received slice at its `own_offset` with one slice fold.
             The live packed gradient is one bucket; rank k owns slice k of
             every bucket, so its state is in partition order
             (buckets.unpermute_state). Guarded, every bucket is scattered
             and checked first, the verdict agreed once, then all fold.
             The apply packs the owned param rows bucket by bucket,
             gathers them and unpermutes them into the leaves bucket by
             bucket: no arena-order copy of the params.
  full pack  (zero_bucketed=False) contiguous row ranges [k*R/M,
             (k+1)*R/M); the whole gradient arena packed, one
             reduce-scatter a micro-batch.

Volume N*P + P a mini-batch either way (the bucketed schedule never sends
the padding bucket).

`adama_layerwise` (zero_stage=1 and arena state only, as in the
reference) is Algorithm 2 under ZeRO-1, the bucketed stream: each layer's
gradient is reduce-scattered out of the backward into the owned rows
(core/layerwise.py's ZeroStream), so no whole-model gradient exists on
any rank; then the bucketed apply.

The bf16 gradient wire (`grad_dtype="bf16"`, the arena variants): every
gradient slab above, the replicated fold's, the full pack, each bucket and
each of the stream's layer slabs, is packed as bf16, so every gradient
reduce-scatter moves half the bytes; the fold kernels upcast the received
rows in-pass and the moments accumulate in fp32 as on the fp32 wire.
Guarded, the finite flag is taken on the bf16 rows. Each rank's addend
is rounded to bf16 before the sum, and the backend rounds the bf16 sum as
it adds, so at M > 1 the wire matches the fp32 wire within tolerance, not
bit for bit (at M = 1 the single-device bf16 wire, bit for bit).

Master params (`master_params=True`): the state holds the fp32 master
region "p". Replicated, the whole master, as on one device. Under ZeRO-1
each rank holds its owned rows of it, in partition order under the
bucketed schedule (packed so at init, the reference's pre-permute); the
apply runs the master form on the owned rows only, updating them in place
and emitting their bf16 working rows, and the all-gather moves those bf16
rows (half the bytes) into the leaves, bucket by bucket: the params are
never packed. The leaves then hold bf16 of the master.

Still refused, each naming its ROADMAP queue-1 item: zero_async and the
fp8 wire (10.3); a tensor-parallel group (10.4).

Every collective runs whatever M is: at M = 1 the scatter and the gather
copy, /1 is exact and f32(1*b2) = f32(b2), so `adama` and ZeRO-1 equal the
single-device adama engine bit for bit (the bucketed schedule on every
row-local pair: rowcol's column sums are added bucket by bucket), and the
stream the single-device adama_layerwise.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      grad_wire_dtype, is_fp8_wire)
from repro_torch.core import adama
from repro_torch.core import arena as arena_mod
from repro_torch.core import buckets, collectives, state_store
from repro_torch.core.accumulation import (_fold_decay, _grads, _Guard, _lr,
                                           _split_micro, inv_n, make_loss,
                                           scale_leaves)
from repro_torch.core.layerwise import ZeroStream, layerwise_loss_and_fold
from repro_torch.core.zero import shard_rows, zero1_bucket_plan
from repro_torch.kernels import fused_step
from repro_torch.kernels.adama_accum import _fma32
from repro_torch.optim import adam
from repro_torch.train import faults as fault_mod
from repro_torch.train import scaler as scaler_mod

VARIANTS = ("ga", "naive", "adama", "adama_layerwise")


def _item(n: str) -> str:
    return f"not ported (ROADMAP queue 1, item {n})"


def _refuse(opt: OptimizerConfig, variant: str, tp_group) -> None:
    """The reference engine's refusals, in its order and with its messages,
    and the port's own for what waits, each naming its ROADMAP item."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown DP variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    if tp_group is not None:
        raise NotImplementedError(
            f"a tensor-parallel group (manual-DP x TP) is {_item('10.4')}")
    zero1 = opt.zero_stage == 1
    if opt.work_param_cache:
        raise ValueError(
            "work_param_cache=True is a pjit-engine knob: the shard_map DP "
            "engine's master path already sources params from the owned "
            "arena rows (never re-packing the tree), so there is no "
            "pack/unpack pair to skip — drop work_param_cache or use the "
            "pjit engine")
    if is_fp8_wire(opt):
        raise NotImplementedError(
            f"grad_dtype='fp8_e4m3' in the DP engine rides the bucketed "
            f"ZeRO-1 schedule's per-bucket reduce-scatters under one agreed "
            f"scale column: {_item('10.3')}")
    if opt.zero_async:
        raise NotImplementedError(
            f"zero_async=True (the double-buffered bucket pipeline) is "
            f"{_item('10.3')}")
    if opt.grad_clip:
        raise ValueError("grad_clip is not applied by the DP engine (nor by "
                         "the reference's); drop grad_clip")
    if opt.finite_guard and variant not in ("adama", "adama_layerwise"):
        raise ValueError(
            f"finite_guard=True in the shard_map DP engine is defined for "
            f"the 'adama' and 'adama_layerwise' variants (the guarded fold "
            f"kernels), got variant={variant!r}")
    if zero1 and not opt.arena:
        raise ValueError(
            "zero_stage=1 in the shard_map DP engine requires the arena "
            "state store (use_pallas=True, arena=True): ZeRO-1 here shards "
            "the flat arena by row range; the per-leaf ZeRO-1 path lives in "
            "the pjit engine (sharding/rules.opt_pspecs)")
    if zero1 and variant not in ("adama", "adama_layerwise"):
        raise ValueError(
            f"zero_stage=1 row-range sharding is defined for the 'adama' "
            f"and 'adama_layerwise' variants only, got variant={variant!r}")
    if variant == "adama_layerwise" and not (zero1 and opt.arena):
        raise ValueError(
            "the shard_map 'adama_layerwise' variant IS the bucketed ZeRO-1 "
            "stream (each layer's gradient reduce-scatters out of the "
            "backward into the owned row range): it requires zero_stage=1 "
            "with the arena state store (arena=True, use_pallas=True). For "
            "replicated-state DP use variant='adama', or run "
            "adama_layerwise in the pjit engine")
    if opt.arena and not zero1 and variant == "adama" and \
            (opt.state_codec != "fp32" or opt.m_codec != "fp32"):
        raise ValueError(
            f"m_codec={opt.m_codec!r}/state_codec={opt.state_codec!r} with "
            f"the shard_map DP engine requires zero_stage=1: the "
            f"mini-batch-end state psum (Eqs. 7-8) cannot sum codec-encoded "
            f"moments, while the row-range ZeRO-1 schedule reduce-scatters "
            f"fp32 gradients instead")


def _bucketed(opt: OptimizerConfig, variant: str) -> bool:
    """Whether the run is ZeRO-1's bucketed schedule (or the stream), whose
    state is in partition order."""
    return opt.zero_stage == 1 and (opt.zero_bucketed
                                    or variant == "adama_layerwise")


def state_plan(opt: OptimizerConfig, variant: str, state, group=None):
    """The bucket plan whose partition order a run's state is in (the
    bucketed schedule and the stream over `group`), else None: what
    train/checkpoint.py's `bucket_plan=` takes."""
    if not _bucketed(opt, variant):
        return None
    return zero1_bucket_plan(state["m"].layout, dist.get_world_size(group),
                             opt.zero_bucket_rows)


def _pmean(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """The mean over ranks of a device scalar (the reference's pmean)."""
    x = x.reshape(1).float().clone()
    return collectives.all_reduce(x, group).reshape(()) / m


def _accumulate_leaves_(acc, g, r: torch.Tensor) -> None:
    """acc[i] <- acc[i] + g_i / N for each leaf g_i of the gradient tree g,
    as XLA CPU contracts the reference's per-leaf `a + g / n`: fma(g_i,
    f32(1/N), acc[i]) (`addcmul_` on CUDA, exact on the CPU). A function,
    so that no loop variable keeps a leaf alive after the caller drops
    the tree."""
    for a, x in zip(acc, arena_mod.tree_flatten(g)[0]):
        if a.is_cuda:
            a.addcmul_(x, r)
        else:
            a.copy_(_fma32(x.float(), r, a))


def _allreduce_leaves_(g, group, r: torch.Tensor) -> None:
    """Each leaf of the gradient tree g <- its sum over the ranks times r,
    in place (a function, as `_accumulate_leaves_` is)."""
    for x in arena_mod.tree_flatten(g)[0]:
        collectives.all_reduce(x, group).mul_(r)


def make_dp_train_step(cfg: ModelConfig, opt: OptimizerConfig, group=None,
                       variant: str = "adama", *, remat=False,
                       lr_schedule=None, fault=None, tp_group=None):
    """Returns (step_fn, opt_init_fn), as make_train_step does. `group` is
    an initialised `torch.distributed` process group (None: the default
    one); every rank calls step_fn(params, opt_state, batch) with the same
    GLOBAL batch (GB, ...) and the same replicated params, and gets the
    same params back. `fault` (train/faults.py) may select a rank with
    `device=`. Params and state are updated in place."""
    _refuse(opt, variant, tp_group)
    m_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    loss_of = make_loss(cfg, remat=remat)
    n = opt.micro_batches
    b1, b2 = opt.beta1, opt.beta2
    zero1 = opt.zero_stage == 1
    wire = grad_wire_dtype(opt.grad_dtype)

    def local_micro(batch):
        gb = batch["tokens"].shape[0]
        if gb % m_dev:
            raise ValueError(f"global batch {gb} not divisible over "
                             f"{m_dev} ranks")
        b = gb // m_dev
        return _split_micro({k: x[rank * b:(rank + 1) * b]
                             for k, x in batch.items()}, n)

    def finish(params, state, lsum, dev):
        params, state = adama.finalize(
            params, state, lr=_lr(lr_schedule, opt, state["step"]),
            beta1=b1, beta2=b2, eps=opt.eps, weight_decay=opt.weight_decay)
        return params, state, {"loss": _pmean(lsum * inv_n(n, dev), group,
                                              m_dev)}

    def ga_step(params, opt_state, batch):
        leaves, paths = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        acc = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
               for x in leaves]
        r = inv_n(n, dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in local_micro(batch):
            loss, g = _grads(loss_of, params, leaves, mb)
            _accumulate_leaves_(acc, g, r)
            del g
            lsum = lsum + loss
        rm = inv_n(m_dev, dev)
        for a in acc:                       # ONE all-reduce of the grads
            collectives.all_reduce(a, group).mul_(rm)
        lr = _lr(lr_schedule, opt, opt_state["step"])
        params, opt_state = adam.update(
            arena_mod.tree_unflatten(paths, acc), opt_state, params, lr=lr,
            beta1=b1, beta2=b2, eps=opt.eps, weight_decay=opt.weight_decay)
        return params, opt_state, {"loss": _pmean(lsum * r, group, m_dev)}

    def naive_step(params, opt_state, batch):
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        rnm = inv_n(n * m_dev, dev)
        if opt.arena:
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(local_micro(batch)):
            loss, g = _grads(loss_of, params, leaves, mb)
            _allreduce_leaves_(g, group, rnm)       # every micro-batch
            if opt.arena:
                state = adama.accumulate(state, g, b1, b2,
                                         decay=_fold_decay(i, b1, b2))
            else:
                state = adama.accumulate(state, g, b1, b2)
            del g
            lsum = lsum + loss
        return finish(params, state, lsum, dev)

    def adama_step(params, opt_state, batch):
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        r = inv_n(n, dev)
        if opt.arena:
            state = dict(opt_state, step=opt_state["step"] + 1)
        else:
            state = adama.begin_minibatch(opt_state, b1, b2, m_devices=m_dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(local_micro(batch)):
            loss, g = _grads(loss_of, params, leaves, mb)
            if opt.arena:
                state = adama.accumulate(state, g, b1, b2, scale=1.0 / n,
                                         decay=_fold_decay(i, b1, b2, m_dev),
                                         grad_dtype=wire)
            else:
                state = adama.accumulate(state, scale_leaves(g, r), b1, b2)
            del g
            lsum = lsum + loss
        state = adama.allreduce_states(state, group, m_dev)   # Eqs. 7-8
        return finish(params, state, lsum, dev)

    guard = _Guard(opt, 1 if zero1 else m_dev)
    dyn = scaler_mod.is_dynamic(opt)
    gi = opt.scaler_growth_interval
    bucketed = _bucketed(opt, variant)
    plans = {}

    def plan_of(lay):
        """The bucket plan of the state's layout (None: the full pack)."""
        if not bucketed:
            return None
        if lay not in plans:
            plans[lay] = zero1_bucket_plan(lay, m_dev, opt.zero_bucket_rows)
        return plans[lay]

    def scatter_bucket(g, lay, bk):
        """A bucket's gradient slab packed and reduce-scattered: this
        rank's fully reduced slice (the slab dies here)."""
        return collectives.reduce_scatter(
            buckets.pack_bucket(g, lay, bk, dtype=wire), group)

    def guarded_step(params, opt_state, batch):
        """Guarded replicated adama, ZeRO-1 or the stream: per micro-batch
        the slab's (ZeRO-1: the received rows'; the stream: dx's, the
        head's and each received slice's) finite flag, agreed over the
        group, predicates the folds; `good` moves the decay to the first
        committed fold and the step counts only if one committed."""
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        st0 = opt_state["step"]
        state, sc = opt_state, opt_state["scaler"]
        lay = state["m"].layout
        plan = plan_of(lay)
        base = torch.tensor(np.float32(1.0 / (n * m_dev)) if zero1
                            else np.float32(1.0 / n), device=dev)
        rdv = torch.tensor([np.float32(b2 / m_dev), 1.0],
                           dtype=torch.float32, device=dev)
        good = torch.zeros((), dtype=torch.int32, device=dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(local_micro(batch)):
            decay = guard.fold_decay(good)
            rdecay = ((decay[0], torch.where(good == 0, rdv[0], rdv[1]))
                      if zero1 else None)
            skip = fault_mod.apply_skip(fault, True, micro=i, step=st0)
            if variant == "adama_layerwise":
                # the scale S seeds the backward (a nan/inf fault lands on
                # the seed), the folds divide it out; the loss is the ce
                seed = fault_mod.corrupt_loss(fault, base * sc["scale"],
                                              micro=i, step=st0, device=rank)
                vec = guard.vector(decay, skip, guard.one(dev) / sc["scale"])
                loss, state, _ = layerwise_loss_and_fold(
                    cfg, params, mb, state, beta1=b1, beta2=b2, scale=seed,
                    grad_dtype=wire, guard=vec,
                    zero=ZeroStream(plan, group, rdecay))
            else:
                loss, g = _grads(loss_of, params, leaves, mb, sc)
                fault_mod.corrupt_tree(fault, g, micro=i, step=st0,
                                       device=rank)
                vec = guard.vector(decay, skip,
                                   scaler_mod.scale_into_fold(base, sc))
                if plan is None:
                    slab = arena_mod.pack(g, lay, dtype=wire)
                    del g
                    if zero1:
                        slab = collectives.reduce_scatter(slab, group)
                    fused_step.finite_and(slab, vec[2:3])
                    collectives.agree(vec[2:3], group)
                    state, _ = state_store.fold_state(
                        state, slab, beta1=b1, beta2=b2,
                        replicated_decay=rdecay, guard=vec)
                    del slab
                else:
                    # every bucket scattered and checked before the one
                    # agreement: folding first would commit a micro-batch
                    # whose later bucket turns out bad
                    owns = []
                    for bk in plan.grad_buckets():
                        owns.append(scatter_bucket(g, lay, bk))
                        fused_step.finite_and(owns[-1], vec[2:3])
                    del g
                    collectives.agree(vec[2:3], group)
                    state_store.begin_micro_state(state, rdecay,
                                                  guard=vec[2:3])
                    for bk, own in zip(plan.grad_buckets(), owns):
                        state_store.fold_slice_state(
                            state, own, bk.own_offset, beta1=b1, beta2=b2,
                            block=bk.fold_block, guard=vec)
                    del owns
                loss = loss / sc["scale"]
            ok = vec[2] != 0
            lsum = lsum + torch.where(ok, loss, 0.0)
            sc = scaler_mod.scaler_update(sc, ok, dynamic=dyn,
                                          growth_interval=gi)
            good = good + ok.to(torch.int32)
        applied = (good > 0).float().reshape(1)
        state = dict(state, step=st0 + 1)
        lr = _lr(lr_schedule, opt, st0 + 1)
        if zero1:
            zero1_apply(params, state, lr, plan, applied)
        else:
            state = adama.allreduce_states(state, group, m_dev, applied)
            params, _ = adama.finalize(
                params, state, lr=lr, beta1=b1, beta2=b2, eps=opt.eps,
                weight_decay=opt.weight_decay, guard=applied)
        loss = _pmean(lsum / torch.clamp(good, min=1).float(), group, m_dev)
        good, metrics = guard.read_back(good, sc, loss)
        return params, dict(state, step=st0 + (good > 0), scaler=sc), metrics

    def zero1_apply(params, state, lr, plan, applied=None):
        """psum the shared columns, apply on the owned param rows, gather
        them and copy them into the leaves (in place). Bucketed: the owned
        rows are packed bucket by bucket and the gathered partition-order
        rows unpermuted into the leaves bucket by bucket, so no arena of
        the params is built beside them. With the master region the
        params are not packed at all: the master form updates the owned
        master rows in place and emits their bf16 working rows, which the
        all-gather moves (half the bytes) into the leaves."""
        state_store.psum_replicated_state(state, group)
        lay = state["m"].layout
        bc1, bc2 = adama.bias_corrections(state["step"], b1, b2)
        kw = dict(lr=lr, bc1=bc1, bc2=bc2, eps=opt.eps,
                  weight_decay=opt.weight_decay, guard=applied)
        with torch.no_grad():
            if state_store.has_master(state):
                work, _ = state_store.apply_master_state(state, **kw)
                p_full = collectives.all_gather(work, group)
                del work
                if plan is not None:
                    buckets.unpermute_into_(params, p_full, plan)
                else:
                    adama._copy_leaves(params, p_full, lay, p_full.dtype)
                return
            if plan is not None:
                p_own = buckets.pack_owned_rows(params, plan, rank)
                state_store.apply_state(p_own, state, **kw)
                p_full = collectives.all_gather(p_own, group)
                del p_own
                buckets.unpermute_into_(params, p_full, plan)
                return
            own = shard_rows(lay, m_dev)[rank]
            p_arena = arena_mod.pack(params, lay)
            p_own = state_store.apply_state(p_arena[own.start:own.stop],
                                            state, **kw)
            p_full = collectives.all_gather(p_own, group)
            del p_arena, p_own
            adama._copy_leaves(params, p_full, lay)

    @torch.no_grad()
    def owned_params(params, lay, plan):
        """This rank's rows of the packed params, the master's initial
        value: its slice of every bucket in partition order (packed one
        bucket at a time, as the reference pre-permutes its master), or
        its contiguous row range under the full pack."""
        if plan is not None:
            return buckets.pack_owned_rows(params, plan, rank)
        own = shard_rows(lay, m_dev)[rank]
        p = arena_mod.pack(params, lay)
        return p if m_dev == 1 else p[own.start:own.stop].clone()

    def zero1_step(params, opt_state, batch):
        """ZeRO-1 (full pack or bucketed) and the stream, unguarded."""
        leaves, _ = arena_mod.tree_flatten(params)
        dev = leaves[0].device
        lay = opt_state["m"].layout
        plan = plan_of(lay)
        state = dict(opt_state, step=opt_state["step"] + 1)
        scale = 1.0 / (n * m_dev)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i, mb in enumerate(local_micro(batch)):
            decay = _fold_decay(i, b1, b2)
            rdecay = (decay[0], b2 / m_dev if i == 0 else 1.0)
            if variant == "adama_layerwise":
                loss, state = layerwise_loss_and_fold(
                    cfg, params, mb, state, beta1=b1, beta2=b2, scale=scale,
                    decay=decay, grad_dtype=wire,
                    zero=ZeroStream(plan, group, rdecay))
            elif plan is None:
                loss, g = _grads(loss_of, params, leaves, mb)
                slab = arena_mod.pack(g, lay, dtype=wire)
                del g
                g_own = collectives.reduce_scatter(slab, group)
                del slab
                state = state_store.fold_state(
                    state, g_own, beta1=b1, beta2=b2, scale=scale,
                    decay=decay, replicated_decay=rdecay)
                del g_own
            else:
                loss, g = _grads(loss_of, params, leaves, mb)
                state_store.begin_micro_state(state, rdecay)
                for bk in plan.grad_buckets():
                    state_store.fold_slice_state(
                        state, scatter_bucket(g, lay, bk), bk.own_offset,
                        beta1=b1, beta2=b2, block=bk.fold_block, scale=scale,
                        decay=decay)
                del g
            lsum = lsum + loss
        zero1_apply(params, state, _lr(lr_schedule, opt, state["step"]),
                    plan)
        return params, state, {"loss": _pmean(lsum * inv_n(n, dev), group,
                                              m_dev)}

    if variant == "ga":
        step_fn = ga_step
    elif variant == "naive":
        step_fn = naive_step
    elif opt.finite_guard:
        step_fn = guarded_step
    else:
        step_fn = zero1_step if zero1 else adama_step

    def init(params) -> Dict[str, Any]:
        """ga: plain Adam's per-leaf state. Otherwise the engines' arena or
        per-leaf state; ZeRO-1 lays the arena out for M row ranges and
        keeps this rank's rows of every row-indexed column (rows / M),
        the shared columns and the step whole."""
        if variant == "ga":
            return adam.init(params)
        if not opt.arena:
            return adama.init(params)
        if zero1:
            rows = arena_mod.build_layout(params, n_shards=m_dev).rows
            state = adama.init_arena(params, codec=opt.state_codec,
                                     m_codec=opt.m_codec, n_shards=m_dev,
                                     rows=rows // m_dev)
            if opt.master_params:
                lay = state["m"].layout
                state["p"] = arena_mod.Arena(
                    owned_params(params, lay, plan_of(lay)), lay)
        else:
            state = adama.init_arena(params, codec=opt.state_codec,
                                     m_codec=opt.m_codec,
                                     master_params=opt.master_params)
        if opt.finite_guard:
            state["scaler"] = scaler_mod.init_scaler(
                opt, arena_mod.tree_flatten(params)[0][0].device)
        return state

    return step_fn, init
