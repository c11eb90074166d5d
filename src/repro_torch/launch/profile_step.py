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
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch hymba-1.5b --num-layers 8 --seq-len 2048 --global-batch 8 \
      --micro-batches 8 --remat
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch whisper-base --seq-len 448 --global-batch 16 --micro-batches 8
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch internvl2-26b --num-layers 4 --seq-len 1024 --global-batch 8 \
      --micro-batches 8 --remat

`--remat` profiles the step under RunConfig(remat=True): ga and adama
checkpoint each layer (adama_layerwise already recomputes every layer).

The profile also records each operator's input shapes and splits the
device time the operators launched (their self device time, forward and
backward) into classes: "ssm" (any input of the Mamba heads' fp32 (...,
d_inner, d_state) shape or its broadcast (..., d_inner, 1) and (..., 1,
d_state) operands: the discretization, the selective scan and its
readout), "attention" (any input of shape (..., heads, S, x): the fp32
scores, softmax and products of the blockwise attention, and the
(micro-batch x heads, S, x) operands of their batched products; S any
length the
model's attention runs at: an enc-dec model's decoder and encoder lengths,
so its cross-attention counts too, and a vlm's patches and text together),
"gemm" (the other matrix products) and "other"; "unattributed" is device time no
operator launched (the port's own CUDA kernels).
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


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def shape_class(name, shapes, cfg, seq_len, micro_batch=1):
    """The class of an operator with these input shapes (`micro_batch`:
    the einsums' batched products run over micro-batch x heads)."""
    shapes = [tuple(x) for x in shapes if isinstance(x, (list, tuple))]
    if cfg.arch_type == "hybrid":
        di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
        # (di, N) and the broadcast (..., di, 1) and (..., 1, N) operands
        if any(x[-2:] == (di, n) or (len(x) >= 3 and x[-2:] in ((di, 1),
                                                                (1, n)))
               for x in shapes if len(x) >= 2):
            return "ssm"
    heads = {cfg.n_heads, cfg.n_kv_heads}
    # the batched products' (micro-batch x heads, S, x) operands
    flat = {h * micro_batch for h in heads}
    lengths = {seq_len}
    if cfg.arch_type == "audio":
        lengths.add(cfg.encoder_seq_len)
    if cfg.arch_type == "vlm":
        lengths = {seq_len + cfg.n_patch_tokens}
    if any(x[-2] in lengths and x[-3] in (heads if len(x) >= 4 else flat)
           for x in shapes if len(x) >= 3):
        return "attention"
    return "gemm" if name in GEMM_OPS else "other"


def by_shape(prof, cfg, seq_len, micro_batch=1):
    """Self device ms of the profiled operators by `shape_class`."""
    out = {}
    for e in prof.key_averages(group_by_input_shape=True):
        us = _device_us(e)
        if us <= 0 or str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        cls = shape_class(e.key, e.input_shapes or [], cfg, seq_len,
                          micro_batch)
        out[cls] = out.get(cls, 0.0) + us / 1e3
    return out


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
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    out = train(run, device="cuda",
                step_context=lambda i: (prof if i == 1
                                        else contextlib.nullcontext()))
    wall = out["step_seconds"][1]
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    split = by_shape(prof, cfg, args.seq_len,
                     args.global_batch // args.micro_batches)
    split["unattributed"] = busy_us / 1e3 - sum(split.values())
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
                        for e in kernels[:args.top]],
        "by_shape_ms": split}))


if __name__ == "__main__":
    main()
