"""Losses of a few training steps at several constant learning rates, from
the same seed, params and data: shows whether a loss spike follows the
learning rate. Prints one JSON object per learning rate (losses, step
seconds) and the device's name. Runs on CUDA unless `--device cpu` is
given.

`--num-layers` cuts the depth, as chip_smoke.py does for rwkv6-7b:

  PYTHONPATH=src python -m repro_torch.launch.lr_sweep --arch rwkv6-7b \
      --num-layers 4 --seq-len 4096 --global-batch 16 --micro-batches 8 \
      --steps 5 --lrs 1e-3 1e-4
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs.base import (ACCUM_ENGINES, OptimizerConfig,
                                      RunConfig, get_config)
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale variant of the arch family")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--lrs", type=float, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--micro-batches", type=int, default=8)
    ap.add_argument("--accumulation", default="adama",
                    choices=list(ACCUM_ENGINES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "kernel versions on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    for lr in args.lrs:
        run = RunConfig(model=cfg,
                        optimizer=OptimizerConfig(
                            accumulation=args.accumulation,
                            micro_batches=args.micro_batches, lr=lr),
                        seq_len=args.seq_len, global_batch=args.global_batch,
                        seed=args.seed, steps=args.steps,
                        log_every=10**9)
        out = train(run, device=args.device, log_fn=lambda s: None)
        print(json.dumps({"arch": cfg.name, "num_layers": cfg.num_layers,
                          "accumulation": args.accumulation, "lr": lr,
                          "losses": out["losses"],
                          "step_seconds": out["step_seconds"]}), flush=True)
        device = out["params"]["embed"].device
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(device)}))


if __name__ == "__main__":
    main()
