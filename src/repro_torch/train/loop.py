"""Training loop (`repro/train/loop.py`, without a mesh): init, data,
the engine's step, per-step loss and time, checkpoints and auto-resume.
`run.remat` checkpoints each layer's activations (the engines' `remat`);
like the reference, nothing of it goes into a checkpoint, so a resumed run
takes it from its own RunConfig.

With `run.checkpoint_dir` the loop resumes from the newest step saved
there (train/checkpoint.py): the params and the optimizer state are
restored in place into the fresh ones, and the loop continues from that
step. It saves every `run.checkpoint_every` steps (0: max(log_every * 5,
50)), keeping `run.keep_last_n`, and once more at `run.steps`.

`run.inject_fault` (train/faults.py's grammar) threads a FaultSpec into the
step (nan/inf/zero/skip) or raises InjectedCrash after a `crash@step=N`
step's update and before its save: the worst-case kill the resume must
survive. With `finite_guard=True` the loop logs the loss scale and the
skipped micro-batches, and raises once `scaler_abort_after` (> 0)
consecutive micro-batches were skipped: a run that only skips is not
training.

With a `torch.distributed` process group (`train(..., group=...)`) the
step is the data-parallel engine's (core/dp_shardmap.py; its variant is
`run.optimizer.accumulation`, so adama_layerwise with zero_stage=1 runs
Algorithm 2's ZeRO-1 stream): every rank runs this loop on the same
global batches and params, and takes its own rows of each batch.
Checkpoints of such a run are refused (train/checkpoint.py ITEM_10)."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.accumulation import make_train_step
from repro_torch.core.dp_shardmap import make_dp_train_step
from repro_torch.data import make_data
from repro_torch.models.model import Model, init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import faults as faults_mod


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller asks for the CPU. A run
    asked to use CUDA (the default) on a machine without it raises instead
    of carrying on on the CPU. On CUDA, float32 matmuls and convolutions
    stay full float32 (TF32 off)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(run: RunConfig, *, lr_schedule=None, log_fn=print, params=None,
          data=None, device=None, step_context=None,
          group=None) -> Dict[str, Any]:
    """Train up to step `run.steps`, from the newest checkpoint in
    `run.checkpoint_dir` if there is one. `params` (a tree on `device`)
    defaults to `init_params` from a generator seeded with `run.seed`.
    Returns the model, its param tree, the optimizer state, the losses and
    wall-clock seconds of the steps this call ran (each step ends in a
    device synchronize), and the last step's metrics ({} if it ran none).
    `step_context(i)`, if given, returns a context manager entered around
    step i's timed region (e.g. a profiler). `group`, an initialised
    process group, runs the data-parallel engine over it."""
    device = resolve_device(device)
    if group is not None and run.checkpoint_dir:
        raise NotImplementedError(f"checkpoints of a data-parallel run "
                                  f"{ckpt.ITEM_10}")
    cfg = run.model
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(run.seed)
        params = init_params(cfg, gen)
    model = Model(cfg, params)
    tree = model.tree()
    opt = run.optimizer
    fault = faults_mod.parse_fault(run.inject_fault)
    kw = dict(remat=run.remat, lr_schedule=lr_schedule, fault=fault)
    if group is None:
        step_fn, opt_init = make_train_step(cfg, opt, **kw)
    else:
        step_fn, opt_init = make_dp_train_step(cfg, opt, group,
                                               opt.accumulation, **kw)
    opt_state = opt_init(tree)
    start = 0
    if run.checkpoint_dir:
        last = ckpt.latest_step(run.checkpoint_dir)
        if last is not None:
            # no name keeps the restored tree: the step replaces the
            # scaler's tensors, and the old ones would stay allocated
            opt_state = ckpt.restore(run.checkpoint_dir, last,
                                     {"params": tree, "opt": opt_state})["opt"]
            start = last
            log_fn(f"[train] restored step {last}")
    if data is None:
        data = make_data(cfg, run.seq_len, run.global_batch, seed=run.seed)
    every = run.checkpoint_every or max(run.log_every * 5, 50)
    losses, step_s, metrics = [], [], {}
    for i in range(start, run.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        _sync(device)
        with (step_context(i) if step_context else contextlib.nullcontext()):
            t0 = time.perf_counter()
            tree, opt_state, metrics = step_fn(tree, opt_state, batch)
            losses.append(float(metrics["loss"]))
            _sync(device)
            step_s.append(time.perf_counter() - t0)
        consec = int(metrics.get("consec_skips", 0))
        if opt.scaler_abort_after and consec >= opt.scaler_abort_after:
            raise RuntimeError(
                f"aborting at step {i + 1}: {consec} consecutive "
                f"micro-batches skipped non-finite (>= scaler_abort_"
                f"after={opt.scaler_abort_after}); loss_scale="
                f"{float(metrics.get('loss_scale', 1.0)):g} — the run "
                f"is diverging, not merely overflowing")
        if (i + 1) % run.log_every == 0:
            extra = ""
            if "loss_scale" in metrics:
                extra = (f" scale={float(metrics['loss_scale']):g} skipped="
                         f"{int(metrics['skipped_micro_batches'])}")
            log_fn(f"[train] step {i + 1}/{run.steps} loss={losses[-1]:.4f}"
                   f"{extra} ({step_s[-1]:.3f}s/step)")
        if faults_mod.crash_due(fault, i):
            # the update committed, the save did not: the resume above
            # must replay from the last saved step bit for bit
            raise faults_mod.InjectedCrash(
                f"injected crash after step {i + 1}'s update, before its "
                f"save")
        if run.checkpoint_dir and (i + 1) % every == 0:
            ckpt.save(run.checkpoint_dir, i + 1,
                      {"params": tree, "opt": opt_state},
                      keep=run.keep_last_n)
    if run.checkpoint_dir:
        ckpt.save(run.checkpoint_dir, run.steps,
                  {"params": tree, "opt": opt_state}, keep=run.keep_last_n)
    return {"model": model, "params": tree, "opt_state": opt_state,
            "losses": losses, "step_seconds": step_s,
            "metrics": {k: float(x) for k, x in metrics.items()}}
