"""Training launcher for the PyTorch port. Runs on CUDA unless
`--device cpu` is given, and fails on a machine without CUDA otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \
      --steps 5 --global-batch 256 --micro-batches 8 --accumulation adama

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 4 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --log-every 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \
      --reduced --steps 2 --global-batch 4 --micro-batches 2 --seq-len 16 \
      --accumulation adama_layerwise --per-leaf --log-every 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 4 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --m-codec int8 --state-codec int8 --log-every 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 3 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --finite-guard --inject-fault nan@micro=1,step=1 --log-every 1 \
      --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 3 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --grad-dtype bf16 --loss-scale dynamic \
      --inject-fault nan@micro=1,step=1 --log-every 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 3 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --master-params --work-param-cache --log-every 1 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 3 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --grad-dtype fp8_e4m3 --loss-scale dynamic \
      --inject-fault nan@micro=1,step=1 --log-every 1 --device cpu

  # the swa and mla families; --num-layers cuts the depth (mistral-nemo-12b
  # at 4 of its 40 layers, minicpm3-4b at 24 of its 62, fit one 80 GB card)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \
      --reduced --steps 2 --global-batch 4 --micro-batches 2 --seq-len 96 \
      --log-every 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \
      --num-layers 24 --steps 3 --global-batch 16 --micro-batches 8 \
      --seq-len 1024 --accumulation ga

  # the MoE family: deepseek-v2-lite-16b at 4 of its 27 layers (the dense
  # prefix layer and 3 MoE layers, all 64 experts) fits one 80 GB card
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch deepseek-v2-lite-16b --num-layers 4 --steps 3 \
      --global-batch 16 --micro-batches 8 --seq-len 1024 \
      --accumulation adama_layerwise

  # the hybrid family: hymba-1.5b (attention and Mamba heads side by side)
  # at 8 of its 32 layers, at seq 2048 (past its 1024-token window)
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --num-layers 8 --steps 2 --global-batch 8 --micro-batches 8 \
      --seq-len 2048 --accumulation adama_layerwise

  # the enc-dec family: whisper-base at full size (6 + 6 layers, 1500
  # stub frames, its decoder context of 448 tokens); --num-layers sets the
  # decoder's depth
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
      --steps 3 --global-batch 16 --micro-batches 8 --seq-len 448 \
      --accumulation adama_layerwise
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
      --reduced --steps 2 --global-batch 4 --micro-batches 2 --seq-len 16 \
      --log-every 1 --device cpu

  # the vlm family: internvl2-26b at full width, 4 of its 48 layers, 1024
  # text tokens after its 256 stub patches (ga + remat peaks at 64.9 GB)
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-26b \
      --num-layers 4 --steps 2 --global-batch 8 --micro-batches 8 \
      --seq-len 1024 --accumulation adama_layerwise

  # data parallel over torch.distributed (core/dp_shardmap.py): under
  # torchrun, which sets WORLD_SIZE, the CLI opens the process group (NCCL
  # on CUDA, gloo with --device cpu) and runs the DP engine; rank 0 logs.
  # ZeRO-1 runs the bucketed schedule (--zero-bucket-rows caps the rest
  # region's buckets), or the full pack with --zero-full-pack;
  # --accumulation adama_layerwise --zero-stage 1 is Algorithm 2's stream
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch stablelm-1.6b --reduced --steps 2 --global-batch 8 \
      --micro-batches 2 --seq-len 32 --zero-stage 1 --log-every 1 \
      --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch stablelm-1.6b --reduced --steps 2 --global-batch 8 \
      --micro-batches 2 --seq-len 32 --zero-stage 1 \
      --accumulation adama_layerwise --log-every 1 --device cpu
  # the bf16 gradient wire and fp32 master params under ZeRO-1, with
  # checkpoints of the sharded state (rank 0 writes the canonical state;
  # run again with more --steps to resume at the same rank count)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch stablelm-1.6b --reduced --steps 2 --global-batch 8 \
      --micro-batches 2 --seq-len 32 --zero-stage 1 --grad-dtype bf16 \
      --master-params --checkpoint-dir /tmp/ckpt-dp --checkpoint-every 1 \
      --log-every 1 --device cpu

  # saves every step; run again with more --steps to resume
  # ("[train] restored step 2")
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --reduced --steps 2 --global-batch 8 --micro-batches 2 --seq-len 32 \
      --checkpoint-dir /tmp/ckpt --checkpoint-every 1 --log-every 1 \
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ACCUM_ENGINES, GRAD_DTYPES, M_CODECS,
                                      STATE_CODECS, OptimizerConfig,
                                      RunConfig, get_config)
from repro_torch.optim import schedule as sched
from repro_torch.train.loop import train


def add_codec_args(ap: argparse.ArgumentParser) -> None:
    """The reference CLI's codec flags."""
    ap.add_argument("--state-codec", default="fp32",
                    choices=list(STATE_CODECS),
                    help="second-moment codec over the arena "
                         "(core/state_store.py)")
    ap.add_argument("--m-codec", default="fp32", choices=list(M_CODECS),
                    help="first-moment codec over the arena "
                         "(core/state_store.py)")


def _quiet(_msg) -> None:
    pass


def _open_group(device):
    """(group, device, log) of this process. Under torchrun (WORLD_SIZE
    set) it opens the default process group from torchrun's environment:
    gloo for a run asked onto the CPU, NCCL otherwise, on the card of
    LOCAL_RANK; only rank 0 logs. Otherwise (None, device, print)."""
    if "WORLD_SIZE" not in os.environ:
        return None, device, print
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl")
    return (dist.group.WORLD, device,
            print if dist.get_rank() == 0 else _quiet)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale variant of the arch family")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--micro-batches", type=int, default=4)
    ap.add_argument("--accumulation", default="adama",
                    choices=list(ACCUM_ENGINES))
    ap.add_argument("--per-leaf", action="store_true",
                    help="per-leaf optimizer state (arena=False): adama and "
                         "adama_layerwise fold and apply leaf by leaf")
    add_codec_args(ap)
    ap.add_argument("--zero-stage", type=int, default=0, choices=[0, 1],
                    help="ZeRO-1 optimizer-state sharding by arena row range "
                         "(the data-parallel engine, under torchrun; a "
                         "single-process run has one shard)")
    ap.add_argument("--zero-full-pack", action="store_true",
                    help="the full-arena pack + one reduce-scatter a "
                         "micro-batch ZeRO-1 schedule, in place of the "
                         "default bucketed one (a reduce-scatter a layer "
                         "and a rest-region bucket); adama_layerwise "
                         "streams its buckets whatever this flag says")
    ap.add_argument("--zero-bucket-rows", type=int, default=0,
                    help="rest-region bucket cap in arena rows of the "
                         "bucketed ZeRO-1 schedule (0 = default cap, 4096)")
    ap.add_argument("--zero-async", action="store_true",
                    help="the reference's double-buffered bucket pipeline "
                         "(ROADMAP item 10.3); requires --zero-stage 1")
    ap.add_argument("--grad-dtype", default="fp32",
                    choices=list(GRAD_DTYPES),
                    help="gradient wire dtype of the arena folds (bf16 "
                         "halves the packed gradient slab; fp8_e4m3 packs "
                         "1-byte codes + per-row scale columns and recovers "
                         "accuracy with an error-feedback residual, "
                         "requires --finite-guard; the fold kernels "
                         "decode/upcast in-kernel); requires arena state, "
                         "not 'ga'")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="ablate the fp8 error-feedback residual "
                         "(state['ef']) — convergence degrades to raw fp8 "
                         "rounding; only meaningful with --grad-dtype "
                         "fp8_e4m3")
    ap.add_argument("--master-params", action="store_true",
                    help="fp32 master params packed in the arena; the fused "
                         "apply emits bf16 working params (AMP contract); "
                         "requires arena state (not --per-leaf)")
    ap.add_argument("--work-param-cache", action="store_true",
                    help="bf16 working-param cache in the arena "
                         "(state['wp']): the engines source step params "
                         "from it, skipping the per-step pack of the "
                         "params; requires --master-params")
    ap.add_argument("--finite-guard", action="store_true",
                    help="fused finite guards: skip non-finite micro-batches "
                         "bitwise (arena state)")
    ap.add_argument("--loss-scale", default="off",
                    help="'off', 'dynamic', or a positive float: loss "
                         "scaling undone in the fold kernels; implies "
                         "--finite-guard, requires --grad-dtype bf16 or "
                         "fp8_e4m3 and a non-'ga' accumulation")
    ap.add_argument("--scaler-abort-after", type=int, default=0,
                    help="abort after this many consecutive skipped "
                         "micro-batches (0 = never)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save checkpoints here (train/checkpoint.py) and "
                         "resume from the newest one found")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N steps (0 = max(5 * log-every, 50))")
    ap.add_argument("--keep-last-n", type=int, default=3,
                    help="checkpoint retention: keep only the newest N steps")
    ap.add_argument("--inject-fault", default=None,
                    help="fault injection (train/faults.py grammar), e.g. "
                         "nan@micro=1, skip@micro=0,step=2, crash@step=3")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "kernel versions on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    run = RunConfig(
        model=cfg,
        optimizer=OptimizerConfig(accumulation=args.accumulation,
                                  micro_batches=args.micro_batches,
                                  lr=args.lr, arena=not args.per_leaf,
                                  state_codec=args.state_codec,
                                  m_codec=args.m_codec,
                                  zero_stage=args.zero_stage,
                                  zero_bucketed=not args.zero_full_pack,
                                  zero_bucket_rows=args.zero_bucket_rows,
                                  zero_async=args.zero_async,
                                  grad_dtype=args.grad_dtype,
                                  error_feedback=not args.no_error_feedback,
                                  master_params=args.master_params,
                                  work_param_cache=args.work_param_cache,
                                  finite_guard=(args.finite_guard
                                                or args.loss_scale != "off"),
                                  loss_scale=args.loss_scale,
                                  scaler_abort_after=args.scaler_abort_after),
        seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed,
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        keep_last_n=args.keep_last_n, inject_fault=args.inject_fault)
    lr_fn = sched.warmup_cosine(args.lr, args.warmup, args.steps)
    group, device, log = _open_group(args.device)
    try:
        out = train(run, lr_schedule=lr_fn, device=device, log_fn=log,
                    group=group)
    finally:
        if group is not None:
            dist.destroy_process_group()
    if log is not print:
        return
    peak = ""
    if out["params"]["embed"].is_cuda:
        peak = (f"; peak device memory {torch.cuda.max_memory_allocated()} B "
                f"on {torch.cuda.get_device_name(0)}")
    scaler = ""
    if "loss_scale" in out["metrics"]:
        m = out["metrics"]
        scaler = (f"; loss_scale {m['loss_scale']:g}, skipped "
                  f"{int(m['skipped_micro_batches'])} micro-batches")
    if not out["losses"]:
        print(f"[train] done; no step left to run (step {args.steps} "
              f"restored){peak}")
        return
    print(f"[train] done; final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}){scaler}{peak}")


if __name__ == "__main__":
    main()
