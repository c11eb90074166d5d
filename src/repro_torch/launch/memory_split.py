"""Split the memory Algorithm 2 saves into what its recompute saves and
what folding each layer's gradient at once saves, on the GPU.

With the params and the (m, v) state resident as in training (in the
codecs `--m-codec` and `--state-codec` name), one
micro-batch's gradient work is run three ways, and each one's peak of
`torch.cuda.max_memory_allocated` above the resident bytes is printed:

  full       Algorithm 1's schedule (core/accumulation.py `adama`): forward
             with autograd, `torch.autograd.grad` over every leaf, pack the
             gradient tree into a slab;
  ckpt       the same with every layer under `torch.utils.checkpoint`: the
             forward keeps only layer inputs and the backward recomputes
             each layer, but the whole gradient tree is still built;
  layerwise  Algorithm 2 (`core/layerwise.layerwise_loss_and_fold`):
             recompute AND fold each layer's gradient as it appears.

full - ckpt is the recompute's saving; ckpt - layerwise is the saving of
never holding the whole gradient tree. Prints one JSON object.

  PYTHONPATH=src python -m repro_torch.launch.memory_split --arch bert-large \
      --seq-len 128 --micro-batch 32
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import get_config
from repro_torch.core import adama, state_store
from repro_torch.core import arena as arena_mod
from repro_torch.core.layerwise import layerwise_loss_and_fold
from repro_torch.data import make_data
from repro_torch.launch.train import add_codec_args
from repro_torch.models import modules as md
from repro_torch.models.model import (Model, apply_block, cross_entropy,
                                      embed_tokens, init_params, loss_fn)
from repro_torch.train.loop import resolve_device


def checkpointed_loss(cfg, params, batch):
    """`models.model.loss_fn` with each layer under torch.utils.checkpoint."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    causal = cfg.arch_type != "encoder"
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    stack = params["blocks"]
    keys = sorted(stack)

    def block(x, *layer):
        return apply_block(cfg, dict(zip(keys, layer)), x, positions,
                           causal=causal)
    x = embed_tokens(cfg, params, tokens, positions)
    for layer in zip(*(torch.unbind(stack[k], 0) for k in keys)):
        x = checkpoint(block, x, *layer, use_reentrant=False)
    x = md.apply_norm(cfg, params, x, "final_norm_")
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return cross_entropy(logits, batch["labels"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--micro-batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    add_codec_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = Model(cfg, init_params(cfg, gen))
    tree = model.tree()
    leaves, paths = arena_mod.tree_flatten(tree)
    state = adama.init_arena(tree, codec=args.state_codec,
                             m_codec=args.m_codec)
    layout = state["m"].layout
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             make_data(cfg, args.seq_len, args.micro_batch,
                       seed=args.seed).batch(0).items()}

    def whole_tree(loss_of):
        def run():
            grads = torch.autograd.grad(loss_of(cfg, tree, batch), leaves)
            arena_mod.pack(arena_mod.tree_unflatten(paths, list(grads)),
                           layout)
        return run

    def layerwise():
        layerwise_loss_and_fold(cfg, tree, batch, state, beta1=0.9,
                                beta2=0.999, scale=1.0)

    runs = (("full", whole_tree(loss_fn)),
            ("ckpt", whole_tree(checkpointed_loss)),
            ("layerwise", layerwise))
    for _, run in runs:          # warm up: library workspaces stay allocated
        run()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    peaks = {}
    for name, run in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - resident
        if torch.cuda.memory_allocated() != resident:
            raise RuntimeError(f"{name}: {torch.cuda.memory_allocated()} B "
                               f"allocated after the run, {resident} B "
                               f"before")
    print(json.dumps({
        "arch": cfg.name, "seq_len": args.seq_len,
        "micro_batch": args.micro_batch,
        "m_codec": args.m_codec, "state_codec": args.state_codec,
        "state_bytes": state_store.optimizer_state_bytes(state),
        "device": torch.cuda.get_device_name(0),
        "resident_bytes": resident,
        "gradient_tree_bytes": sum(x.numel() * 4 for x in leaves),
        "arena_bytes": layout.rows * arena_mod.LANES * 4,
        "peak_over_resident_bytes": peaks,
        "recompute_saving_bytes": peaks["full"] - peaks["ckpt"],
        "per_layer_fold_saving_bytes": peaks["ckpt"] - peaks["layerwise"]}))


if __name__ == "__main__":
    main()
