"""Runs of the port's engines for the data-parallel tests, on one process
or on M gloo ranks. `start_ranks` spawns the ranks (a `file://` rendezvous
under the test's tmp_path, so no TCP port can clash between pytest
workers); each runs `run_cases` and saves its results, which the parent
loads (`collect`). This module imports no JAX: the ranks import it fresh."""
import dataclasses
import hashlib
import multiprocessing as mp
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core import collectives
from repro_torch.core.accumulation import make_train_step
from repro_torch.core.dp_shardmap import make_dp_train_step
from repro_torch.data import make_data
from repro_torch.kernels import adam_apply, adama_accum, fused_step
from repro_torch.models import model as tmodel
from repro_torch.optim import schedule as tsched
from repro_torch.train.faults import parse_fault

ARCH = "bert_large"
SEQ, LR = 16, 1e-3
# the bf16 wire and master params (name, OptimizerConfig fields), and
# both guarded with dynamic loss scaling
WIRES = (("bf16", dict(grad_dtype="bf16")),
         ("master", dict(master_params=True)),
         ("bf16-master", dict(grad_dtype="bf16", master_params=True)))
GUARDED_BF16_MASTER = dict(grad_dtype="bf16", master_params=True,
                           finite_guard=True, loss_scale="dynamic")
WRAPPERS = (fused_step.arena_fold, fused_step.arena_apply,
            fused_step.finite_and, adama_accum.adama_accum_2d,
            adam_apply.adam_apply_2d)


def model_config(arch=ARCH):
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")


def init_tree(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return tmodel.Model(cfg, tmodel.init_params(cfg, gen)).tree()


def batches(cfg, gb, steps, reorder=None):
    """Each step's global batch as tensors; `reorder=(M, N)` puts micro-
    batch i of every rank side by side (rank 0's, rank 1's, ...), so that
    one device's micro-batch i holds what ZeRO-1 reduce-scatters at fold
    i (the reference's tests/test_distributed.py reorder)."""
    data = make_data(cfg, SEQ, gb, seed=5)
    out = []
    for s in range(steps):
        b = data.batch(s)
        if reorder:
            m, n = reorder
            r = gb // (m * n)
            idx = np.array([k * (gb // m) + i * r + j for i in range(n)
                            for k in range(m) for j in range(r)])
            b = {k: v[idx] for k, v in b.items()}
        out.append({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()})
    return out


def _numpy_state(state):
    out = {"step": state["step"]}
    for k in ("m", "v"):
        x = state[k]
        if isinstance(x, tarena.Arena):
            out[k] = [x.data.numpy().copy()]
        elif hasattr(x, "parts"):
            out[k] = [p.numpy().copy() for p in x.parts]
        else:
            out[k] = [t.numpy().copy() for t in tarena.tree_flatten(x)[0]]
    if "p" in state:
        out["p"] = state["p"].data.numpy().copy()
    if "scaler" in state:
        out["scaler"] = {k: float(v) for k, v in state["scaler"].items()}
    return out


def run(opt_kw, variant=None, *, steps=2, gb=8, reorder=None, warmup=False,
        fault=None, arch=ARCH, group=None, state_shards=1):
    """One run from the seed-0 params: the single-device engine
    (variant None; its arena laid out for `state_shards` row ranges) or
    make_dp_train_step's `variant` over `group` (the default group when
    one is initialised). Returns numpy results."""
    cfg = model_config(arch)
    opt = OptimizerConfig(**opt_kw)
    sched = tsched.warmup_cosine(LR, 1, steps + 1) if warmup else None
    kw = dict(lr_schedule=sched, fault=parse_fault(fault))
    if variant is None:
        step, init = make_train_step(cfg, opt, state_shards=state_shards,
                                     **kw)
    else:
        step, init = make_dp_train_step(cfg, opt, group, variant, **kw)
    tree = init_tree(cfg)
    state = init(tree)
    collectives.reset_counts()
    for fn in WRAPPERS:
        fn.launches = 0
    losses, metrics = [], []
    for b in batches(cfg, gb, steps, reorder):
        tree, state, m = step(tree, state, b)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    with torch.no_grad():
        params = tarena.pack(tree, tarena.build_layout(tree)).numpy()
    rows = None
    if "m" in state and hasattr(state["m"], "layout"):
        rows = state["m"].layout.rows
    work = (_leaves_are_bf16_master(tree, state, opt, variant, group)
            if "p" in state else None)
    from repro_torch.core import state_store
    arena_state = state_store.is_arena_backed(state["m"])
    # a rank but the first keeps only the digest of the params, which
    # every rank holds alike
    digest = hashlib.sha256(params.tobytes()).hexdigest()
    if dist.is_initialized() and dist.get_rank(group) > 0:
        params = None
    return dict(params=params, params_digest=digest, losses=losses,
                metrics=metrics, layout_rows=rows,
                work_is_bf16_master=work, **_numpy_state(state),
                state_bytes=(state_store.optimizer_state_bytes(state)
                             if arena_state else None),
                mask=(state_store.row_indexed_mask(state) if arena_state
                      else None),
                collectives={fn.__name__: (fn.calls, fn.bytes)
                             for fn in collectives.COLLECTIVES},
                launches={fn.__name__: fn.launches for fn in WRAPPERS},
                param_bytes=sum(x.numel() * 4 for x in
                                tarena.tree_flatten(tree)[0]))


def run_checkpointed(opt_kw, variant, ckpt_dir, *, steps=2, gb=8,
                     arch=ARCH, group=None):
    """train() over `group` with a checkpoint a step, twice: a clean run in
    `ckpt_dir`/clean, and one crashed by `crash@step=1` (after step 2's
    update, before its save) and resumed from step 1 in `ckpt_dir`/crash.
    Returns both runs' numpy results (params packed, the state's
    columns)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.faults import InjectedCrash
    from repro_torch.train.loop import train
    cfg = model_config(arch)
    opt = OptimizerConfig(accumulation=variant, **opt_kw)

    def go(sub, fault=None):
        return train(RunConfig(model=cfg, optimizer=opt, seq_len=SEQ,
                               global_batch=gb, steps=steps,
                               checkpoint_dir=f"{ckpt_dir}/{sub}",
                               checkpoint_every=1, inject_fault=fault),
                     device="cpu", group=group or dist.group.WORLD,
                     log_fn=lambda _: None)

    def result(out):
        tree = out["params"]
        with torch.no_grad():
            params = tarena.pack(tree, tarena.build_layout(tree)).numpy()
        digest = hashlib.sha256(params.tobytes()).hexdigest()
        return dict(params=params if dist.get_rank(group) == 0 else None,
                    params_digest=digest, losses=out["losses"],
                    **_numpy_state(out["opt_state"]))
    clean = result(go("clean"))
    try:
        go("crash", "crash@step=1")
        crashed = False
    except InjectedCrash:
        crashed = True
    return dict(clean=clean, resumed=result(go("crash")), crashed=crashed,
                dir=str(ckpt_dir))


def run_other_m_restore(opt_kw, variant, ckpt_dir, *, arch=ARCH,
                        n_shards=4, group=None):
    """Rank 0 saves the canonical state of a layout padded for `n_shards`
    ranks; every rank then restores it into its own share of a state laid
    out for the group's size. Returns the exception's type and text (None
    if it restored)."""
    from repro_torch.core import adama
    from repro_torch.core.dp_shardmap import state_plan
    from repro_torch.train import checkpoint as ckpt
    cfg = model_config(arch)
    opt = OptimizerConfig(accumulation=variant, **opt_kw)
    tree = init_tree(cfg)
    if dist.get_rank(group) == 0:
        ckpt.save(ckpt_dir, 1, {"params": tree, "opt": adama.init_arena(
            tree, n_shards=n_shards)})
    dist.barrier(group)
    state = make_dp_train_step(cfg, opt, group, variant)[1](tree)
    try:
        ckpt.restore(ckpt_dir, 1, {"params": tree, "opt": state},
                     group=group, bucket_plan=state_plan(opt, variant, state,
                                                         group))
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))
    return None


def run_rank0_files(opt_kw, variant, ckpt_dir, *, gb=8, arch=ARCH,
                    group=None):
    """One step, then a save and a restore over the group in which only
    rank 0 is given `ckpt_dir` (each other rank a path that does not
    exist, as on a node that cannot see rank 0's disk): the restore goes
    into a fresh init's state and params. Returns whether it restored the
    saved params and state exactly, latest_step on the rank, what a
    restore of a step not on disk raised, and the collective counters
    after it all."""
    from repro_torch.core.dp_shardmap import state_plan
    from repro_torch.train import checkpoint as ckpt
    group = group or dist.group.WORLD
    cfg = model_config(arch)
    opt = OptimizerConfig(accumulation=variant, **opt_kw)
    step, init = make_dp_train_step(cfg, opt, group, variant)
    tree = init_tree(cfg)
    tree, state, _ = step(tree, init(tree), batches(cfg, gb, 1)[0])
    rank = dist.get_rank(group)
    d = ckpt_dir if rank == 0 else f"{ckpt_dir}-absent-{rank}"
    plan = state_plan(opt, variant, state, group)
    collectives.reset_counts()
    ckpt.save(d, 1, {"params": tree, "opt": state}, group=group,
              bucket_plan=plan)
    last = ckpt.latest_step(d, group=group)
    fresh = init_tree(cfg)
    got = ckpt.restore(d, last, {"params": fresh, "opt": init(fresh)},
                       group=group, bucket_plan=plan)
    try:
        ckpt.restore(d, 7, {"params": fresh, "opt": init(fresh)},
                     group=group, bucket_plan=plan)
        missing = None
    except Exception as e:
        missing = type(e).__name__
    a, b = _numpy_state(state), _numpy_state(got["opt"])
    same = all(np.array_equal(x, y) for k in ("m", "v")
               for x, y in zip(a[k], b[k]))
    same &= np.array_equal(a.get("p"), b.get("p")) and a["step"] == b["step"]
    same &= all(torch.equal(x, y) for x, y in zip(
        tarena.tree_flatten(tree)[0], tarena.tree_flatten(got["params"])[0]))
    return dict(same=same, last=last, missing=missing,
                dir_exists=Path(d).exists(),
                collectives={fn.__name__: (fn.calls, fn.bytes)
                             for fn in collectives.COLLECTIVES})


KINDS = {"run": run, "checkpointed": run_checkpointed,
         "other_m_restore": run_other_m_restore,
         "rank0_files": run_rank0_files}


@torch.no_grad()
def _leaves_are_bf16_master(tree, state, opt, variant, group):
    """Whether the param leaves are exactly bf16 of the master: the whole
    master (every rank's rows, gathered, in arena order) against the
    leaves packed in its layout."""
    from repro_torch.core import buckets
    from repro_torch.core.dp_shardmap import state_plan
    p, lay = state["p"].data, state["p"].layout
    if p.shape[0] != lay.rows:
        whole = p.new_empty((lay.rows,) + tuple(p.shape[1:]))
        dist.all_gather_into_tensor(whole, p, group=group)
        plan = state_plan(opt, variant, state, group)
        p = whole if plan is None else buckets.unpermute_rows(whole, plan)
    return torch.equal(tarena.pack(tree, lay),
                       p.to(torch.bfloat16).float())


def run_cases(cases):
    """{name: KINDS[kind](**kw)} for each (name, kw) of `cases`, kind
    kw.pop("kind", "run")."""
    out = {}
    for name, kw in cases:
        kw = dict(kw)
        out[name] = KINDS[kw.pop("kind", "run")](**kw)
    return out


def _rank_main(rank, world, d, tag, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/{tag}.rdv",
                            rank=rank, world_size=world)
    try:
        torch.save(run_cases(cases), f"{d}/{tag}-{rank}.pt")
    except BaseException:
        Path(f"{d}/{tag}-{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(world, tmpdir, tag, cases):
    """Spawn `world` gloo ranks, each running run_cases(cases); returns
    the handle `collect` takes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmpdir), tag, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, str(tmpdir), tag


def collect(handle, timeout=180):
    """Each rank's results of a `start_ranks` handle, in rank order."""
    procs, tmpdir, tag = handle
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [Path(f"{tmpdir}/{tag}-{r}.err") for r in range(len(procs))]
    msg = "\n".join(e.read_text() for e in errs if e.exists())
    assert all(p.exitcode == 0 for p in procs), \
        f"{tag}: exit codes {[p.exitcode for p in procs]}\n{msg}"
    out = []
    for r in range(len(procs)):     # each file dropped once read
        path = Path(f"{tmpdir}/{tag}-{r}.pt")
        out.append(torch.load(path, weights_only=False))
        path.unlink()
    return out
