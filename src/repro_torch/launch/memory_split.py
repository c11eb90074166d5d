"""Split the memory Algorithm 2 saves into what its recompute saves and
what folding each layer's gradient at once saves, on the GPU.

With the params and the (m, v) state resident as in training (in the
codecs `--m-codec` and `--state-codec` name), one
micro-batch's gradient work is run three ways, and each one's peak of
`torch.cuda.max_memory_allocated` above the resident bytes is printed:

  full       Algorithm 1's schedule (core/accumulation.py `adama`): forward
             with autograd, `torch.autograd.grad` over every leaf, pack the
             gradient tree into a slab;
  ckpt       the same with every layer under torch.utils.checkpoint
             (`loss_fn(..., remat=True)`): the forward keeps only layer
             inputs and the backward recomputes each layer, but the whole
             gradient tree is still built;
  layerwise  Algorithm 2 (`core/layerwise.layerwise_loss_and_fold`):
             recompute AND fold each layer's gradient as it appears.

full - ckpt is the recompute's saving; ckpt - layerwise is the saving of
never holding the whole gradient tree. Prints one JSON object
(`memory_split` returns it). `--runs` picks some of the three (a full run
of stablelm-1.6b at seq 4096 keeps every layer's attention scores and
does not fit the card). `--peak-sites N` also records the caching
allocator's history over each run and reports where in the run its peak
falls (the share of its allocator events before it) and the N source lines
with the most bytes live at the peak (the innermost frame in this package;
what the autograd engine allocates in a backward has no Python frame).

  PYTHONPATH=src python -m repro_torch.launch.memory_split --arch bert-large \
      --seq-len 128 --micro-batch 32

`--num-layers` cuts the depth (rwkv6-7b's 32 layers with their fp32 params,
m and v do not fit one 80 GB card):

  PYTHONPATH=src python -m repro_torch.launch.memory_split --arch rwkv6-7b \
      --num-layers 4 --seq-len 4096 --micro-batch 2
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch stablelm-1.6b --seq-len 4096 --micro-batch 2 \
      --runs ckpt layerwise --peak-sites 8
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch mistral-nemo-12b --num-layers 4 --seq-len 8192 \
      --micro-batch 1 --runs ckpt layerwise
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch minicpm3-4b --num-layers 24 --seq-len 1024 --micro-batch 2
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch hymba-1.5b --num-layers 8 --seq-len 2048 --micro-batch 1
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch whisper-base --seq-len 448 --micro-batch 8
  PYTHONPATH=src python -m repro_torch.launch.memory_split \
      --arch internvl2-26b --num-layers 4 --seq-len 1024 --micro-batch 1 \
      --runs ckpt layerwise
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import adama, state_store
from repro_torch.core import arena as arena_mod
from repro_torch.core.layerwise import layerwise_loss_and_fold
from repro_torch.data import make_data
from repro_torch.launch.train import add_codec_args
from repro_torch.models.model import Model, init_params, loss_fn
from repro_torch.train.loop import resolve_device


RUNS = ("full", "ckpt", "layerwise")
HISTORY_ENTRIES = 4_000_000
NO_FRAME = "autograd engine (no Python frame)"


def _site(frames) -> str:
    """An allocation's innermost frame in this package, as file:line."""
    for f in frames:
        if "repro_torch" in f["filename"]:
            return (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
                    f"({f['name']})")
    return NO_FRAME


def peak_sites(run, top: int):
    """Run `run` under the allocator's history: (the share of the run's
    allocator events before its peak, the `top` sites by bytes live at the
    peak, among the blocks the run allocated)."""
    torch.cuda.memory._record_memory_history(max_entries=HISTORY_ENTRIES,
                                             stacks="python")
    try:
        run()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at, at_peak = {}, 0, 0, 0, {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, at, at_peak = cur, i, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    sites = collections.Counter()
    for e in at_peak.values():
        sites[_site(e.get("frames", ()))] += e["size"]
    return {"peak_at_event_share": at / max(len(trace), 1),
            "live_at_peak_bytes": peak,
            "sites": [[k, n] for k, n in sites.most_common(top)]}


def memory_split(arch="bert-large", *, seq_len=128, micro_batch=32,
                 num_layers=None, seed=0, m_codec="fp32", state_codec="fp32",
                 runs=RUNS, peak_sites_top=0):
    """The peaks above the resident bytes of the `runs` named, and the
    differences of those present, as a dict (see the module docstring)."""
    device = resolve_device("cuda")
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Model(cfg, init_params(cfg, gen))
    tree = model.tree()
    leaves, paths = arena_mod.tree_flatten(tree)
    state = adama.init_arena(tree, codec=state_codec, m_codec=m_codec)
    layout = state["m"].layout
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             make_data(cfg, seq_len, micro_batch, seed=seed).batch(0).items()}

    def whole_tree(remat):
        def run():
            grads = torch.autograd.grad(
                loss_fn(cfg, tree, batch, remat=remat), leaves)
            arena_mod.pack(arena_mod.tree_unflatten(paths, list(grads)),
                           layout)
        return run

    def layerwise():
        layerwise_loss_and_fold(cfg, tree, batch, state, beta1=0.9,
                                beta2=0.999, scale=1.0)

    fns = {"full": whole_tree(False), "ckpt": whole_tree(True),
           "layerwise": layerwise}
    for name in runs:            # warm up: library workspaces stay allocated
        fns[name]()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    peaks, sites = {}, {}
    for name in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if peak_sites_top:
            sites[name] = peak_sites(fns[name], peak_sites_top)
        else:
            fns[name]()
            torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - resident
        if torch.cuda.memory_allocated() != resident:
            raise RuntimeError(f"{name}: {torch.cuda.memory_allocated()} B "
                               f"allocated after the run, {resident} B "
                               f"before")
    return {
        "arch": cfg.name, "num_layers": cfg.num_layers, "seq_len": seq_len,
        "micro_batch": micro_batch,
        "m_codec": m_codec, "state_codec": state_codec,
        "state_bytes": state_store.optimizer_state_bytes(state),
        "device": torch.cuda.get_device_name(0),
        "resident_bytes": resident,
        "gradient_tree_bytes": sum(x.numel() * 4 for x in leaves),
        "arena_bytes": layout.rows * arena_mod.LANES * 4,
        "peak_over_resident_bytes": peaks,
        "recompute_saving_bytes": (peaks["full"] - peaks["ckpt"]
                                   if {"full", "ckpt"} <= peaks.keys()
                                   else None),
        "per_layer_fold_saving_bytes": (
            peaks["ckpt"] - peaks["layerwise"]
            if {"ckpt", "layerwise"} <= peaks.keys() else None),
        **({"peak_sites": sites} if sites else {})}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--micro-batch", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    ap.add_argument("--peak-sites", type=int, default=0,
                    help="report the N sites with the most bytes live at "
                         "each run's peak (the allocator's history)")
    add_codec_args(ap)
    args = ap.parse_args(argv)
    print(json.dumps(memory_split(
        args.arch, seq_len=args.seq_len, micro_batch=args.micro_batch,
        num_layers=args.num_layers, seed=args.seed, m_codec=args.m_codec,
        state_codec=args.state_codec, runs=args.runs,
        peak_sites_top=args.peak_sites)))


if __name__ == "__main__":
    main()
