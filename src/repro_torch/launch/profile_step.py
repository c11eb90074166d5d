"""Profile one training step of the port on the GPU with torch.profiler.

Runs `train()` for two steps (the first one warms up) and profiles the
second. Prints one JSON object: the step's wall-clock seconds, the summed
device time of its kernels, the device's idle share over the step
(1 - device time / wall time; negative if kernels overlapped on several
streams), and the kernels with the most device time (name, launches,
milliseconds).

  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch bert-large \
      --seq-len 128 --global-batch 256 --micro-batches 8 --accumulation adama

`--num-layers` cuts the depth (rwkv6-7b's 32 layers do not fit one 80 GB
card with their fp32 params, m and v; chip_smoke.py trains it at 4):

  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch rwkv6-7b \
      --num-layers 4 --seq-len 4096 --global-batch 16 --micro-batches 8
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch mistral-nemo-12b --num-layers 4 --seq-len 8192 \
      --global-batch 8 --micro-batches 8 --remat
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch minicpm3-4b --num-layers 24 --seq-len 1024 --global-batch 16 \
      --micro-batches 8

`--remat` profiles the step under RunConfig(remat=True): ga and adama
checkpoint each layer (adama_layerwise already recomputes every layer).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import (ACCUM_ENGINES, OptimizerConfig,
                                      RunConfig, get_config)
from repro_torch.launch.train import add_codec_args
from repro_torch.train.loop import train


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--micro-batches", type=int, default=8)
    ap.add_argument("--accumulation", default="adama",
                    choices=list(ACCUM_ENGINES))
    ap.add_argument("--per-leaf", action="store_true",
                    help="per-leaf optimizer state (arena=False): adama and "
                         "adama_layerwise fold and apply leaf by leaf")
    add_codec_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer (RunConfig.remat)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    run = RunConfig(model=cfg,
                    optimizer=OptimizerConfig(accumulation=args.accumulation,
                                              micro_batches=args.micro_batches,
                                              arena=not args.per_leaf,
                                              state_codec=args.state_codec,
                                              m_codec=args.m_codec),
                    seq_len=args.seq_len, global_batch=args.global_batch,
                    seed=args.seed, steps=2, log_every=1,
                    remat=args.remat)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    out = train(run, device="cuda",
                step_context=lambda i: (prof if i == 1
                                        else contextlib.nullcontext()))
    wall = out["step_seconds"][1]
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    print(json.dumps({
        "arch": cfg.name, "num_layers": cfg.num_layers,
        "accumulation": args.accumulation,
        "per_leaf": args.per_leaf, "remat": args.remat,
        "m_codec": args.m_codec, "state_codec": args.state_codec,
        "seq_len": args.seq_len, "global_batch": args.global_batch,
        "micro_batches": args.micro_batches,
        "device": torch.cuda.get_device_name(0),
        "step_seconds": wall, "kernel_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:120], "launches": e.count,
                         "ms": _device_us(e) / 1e3}
                        for e in kernels[:args.top]]}))


if __name__ == "__main__":
    main()
