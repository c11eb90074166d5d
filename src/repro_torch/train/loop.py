"""Training loop (`repro/train/loop.py`, without checkpoints, faults or a
mesh): init, data, the engine's step, per-step loss and time."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.models.model import Model, init_params


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
          data=None, device=None, step_context=None) -> Dict[str, Any]:
    """Train `run.steps` steps. `params` (a tree on `device`) defaults to
    `init_params` from a generator seeded with `run.seed`. Returns the
    model, its param tree, the optimizer state, and per-step losses and
    wall-clock seconds (each step ends in a device synchronize).
    `step_context(i)`, if given, returns a context manager entered around
    step i's timed region (e.g. a profiler)."""
    device = resolve_device(device)
    cfg = run.model
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(run.seed)
        params = init_params(cfg, gen)
    model = Model(cfg, params)
    tree = model.tree()
    step_fn, opt_init = make_train_step(cfg, run.optimizer,
                                        lr_schedule=lr_schedule)
    opt_state = opt_init(tree)
    if data is None:
        data = make_data(cfg, run.seq_len, run.global_batch, seed=run.seed)
    losses, step_s = [], []
    for i in range(run.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        _sync(device)
        with (step_context(i) if step_context else contextlib.nullcontext()):
            t0 = time.perf_counter()
            tree, opt_state, metrics = step_fn(tree, opt_state, batch)
            losses.append(float(metrics["loss"]))
            _sync(device)
            step_s.append(time.perf_counter() - t0)
        if (i + 1) % run.log_every == 0:
            log_fn(f"[train] step {i + 1}/{run.steps} loss={losses[-1]:.4f} "
                   f"({step_s[-1]:.3f}s/step)")
    return {"model": model, "params": tree, "opt_state": opt_state,
            "losses": losses, "step_seconds": step_s}
