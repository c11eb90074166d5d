"""Runs of the port's engines for the data-parallel tests, on one process
or on M gloo ranks. `start_ranks` spawns the ranks (a `file://` rendezvous
under the test's tmp_path, so no TCP port can clash between pytest
workers); each runs `run_cases` and saves its results, which the parent
loads (`collect`). This module imports no JAX: the ranks import it fresh."""
import dataclasses
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
    from repro_torch.core import state_store
    arena_state = state_store.is_arena_backed(state["m"])
    return dict(params=params, losses=losses, metrics=metrics,
                layout_rows=rows, **_numpy_state(state),
                state_bytes=(state_store.optimizer_state_bytes(state)
                             if arena_state else None),
                mask=(state_store.row_indexed_mask(state) if arena_state
                      else None),
                collectives={fn.__name__: (fn.calls, fn.bytes)
                             for fn in collectives.COLLECTIVES},
                launches={fn.__name__: fn.launches for fn in WRAPPERS},
                param_bytes=sum(x.numel() * 4 for x in
                                tarena.tree_flatten(tree)[0]))


def run_cases(cases):
    """{name: run(**kw)} for each (name, kw) of `cases`."""
    return {name: run(**kw) for name, kw in cases}


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
    return [torch.load(f"{tmpdir}/{tag}-{r}.pt", weights_only=False)
            for r in range(len(procs))]
