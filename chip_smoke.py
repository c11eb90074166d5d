#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. torch / CUDA versions and the card's name and power limit.
2. Build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
   (one nvcc per source, started together).
3. Each kernel against its plain PyTorch version on the card, bit for bit,
   at the full bert-large arena (357,888 x 1024) and at a ragged 8-row
   arena; the median time of each over CUDA-event-timed runs, beside the
   least time the card could take for the same work.
4. A small-input check: reduced bert-large trained 2 steps on the card
   (kernels) and on the CPU (plain versions) from the same params agree.
5. The main path: bert-large at full width and depth, bf16 compute, fp32
   params and state, seq 128, global batch 256, 8 micro-batches, 5 steps of
   the `adama` engine and 5 of the `ga` baseline, with per-step loss, step
   time and peak device memory. Every fold and apply must have gone
   through the kernels (launch counts).

The last two lines are a JSON object with every kernel's numbers and the
JSON result line `{"ok": true, "device": {...}}`; the line before them is
the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, non-tensor fp32
FULL_ROWS = 357_888              # bert-large arena rows
SMALL_ROWS = 8
TIMED_RUNS = 25
MAIN = dict(arch="bert_large", seq_len=128, global_batch=256,
            micro_batches=8, steps=5, seed=0)


def log(msg) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, runs=TIMED_RUNS, warmup=2):
    """Median milliseconds of `fn()` over `runs` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, fused_step, dev="cuda", sizes=(SMALL_ROWS, FULL_ROWS)):
    """Phase 3: each kernel bitwise against its plain version; times."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lanes = fused_step.LANES
    result = {}
    for rows in sizes:
        def rand(scale, positive=False):
            x = torch.randn((rows, lanes), generator=gen, device=dev) * scale
            return x.abs() if positive else x
        m, v, g, p = rand(1e-3), rand(1e-6, True), rand(1.0), rand(0.02)
        n = rows * lanes
        err = {"arena_fold": 0.0, "arena_apply": 0.0}
        for decay, scale in (((0.9, 0.999), 1.0 / 8), (None, 1.0 / 8)):
            kw = dict(beta1=0.9, beta2=0.999, scale=scale, decay=decay)
            mk, vk, mr, vr = m.clone(), v.clone(), m.clone(), v.clone()
            fused_step.arena_fold(mk, vk, g, **kw)
            fused_step.arena_fold_ref(mr, vr, g, **kw)
            for a, b in ((mk, mr), (vk, vr)):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"arena_fold rows={rows} decay={decay}: kernel != "
                        f"plain at {int((a != b).sum())} elements, max |d| "
                        f"{float((a - b).abs().max())}")
                err["arena_fold"] = max(err["arena_fold"],
                                        float((a - b).abs().max()))
            del mk, vk, mr, vr
        for wd in (0.0, 0.01):
            kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8, weight_decay=wd)
            pk, pr = p.clone(), p.clone()
            fused_step.arena_apply(pk, m, v, **kw)
            fused_step.arena_apply_ref(pr, m, v, **kw)
            if not torch.equal(pk, pr):
                raise AssertionError(
                    f"arena_apply rows={rows} wd={wd}: kernel != plain at "
                    f"{int((pk != pr).sum())} elements, max |d| "
                    f"{float((pk - pr).abs().max())}")
            err["arena_apply"] = max(err["arena_apply"],
                                     float((pk - pr).abs().max()))
            del pk, pr
        fold_kw = dict(beta1=0.9, beta2=0.999, scale=1.0 / 8, decay=None)
        apply_kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, eps=1e-8)
        timings = {
            "arena_fold": (
                timed_ms(torch, lambda: fused_step.arena_fold(m, v, g,
                                                              **fold_kw)),
                timed_ms(torch, lambda: fused_step.arena_fold_ref(
                    m, v, g, **fold_kw)),
                # m, v, g read once, m, v written once; 8 fp32 ops each
                bound_ms(5 * 4 * n, 8 * n)),
            "arena_apply": (
                timed_ms(torch, lambda: fused_step.arena_apply(p, m, v,
                                                               **apply_kw)),
                timed_ms(torch, lambda: fused_step.arena_apply_ref(
                    p, m, v, **apply_kw)),
                # p, m, v read once, p written once; 7 fp32 ops each
                bound_ms(4 * 4 * n, 7 * n)),
        }
        for name, (ms, plain_ms, (bnd, by)) in timings.items():
            log(json.dumps({"phase": "kernel", "name": name, "rows": rows,
                            "max_abs_err": err[name], "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bnd,
                            "bound_by": by, "library_call": "none"}))
            if rows == sizes[-1]:
                result[name] = dict(max_abs_err=err[name], ms=ms,
                                    plain_ms=plain_ms, bound_ms=bnd,
                                    bound_by=by, library_ms=None)
        for x in (m, v, p):
            if not torch.isfinite(x).all():
                raise AssertionError(f"rows={rows}: non-finite state after "
                                     f"the timed runs")
        del m, v, g, p
        torch.cuda.empty_cache()
    return result


def check_small_input(torch):
    """Phase 4: the CUDA path agrees with the CPU path (plain versions) on
    a reduced bert-large run from identical params and data."""
    import dataclasses

    from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.loop import train

    cfg = dataclasses.replace(get_config("bert_large").reduced(),
                              compute_dtype="float32")
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(micro_batches=2),
                    seq_len=32, global_batch=4, steps=2, log_every=10**9)
    gen = torch.Generator()
    gen.manual_seed(0)
    base = init_params(cfg, gen)

    def copy_to(tree, device):
        return {k: copy_to(x, device) if isinstance(x, dict)
                else x.clone().to(device) for k, x in tree.items()}

    outs = {dev: train(run, params=copy_to(base, dev), device=dev,
                       log_fn=lambda s: None) for dev in ("cuda", "cpu")}
    lc, lg = outs["cpu"]["losses"], outs["cuda"]["losses"]
    for a, b in zip(lc, lg):
        if not (math.isfinite(b) and abs(a - b) <= 1e-5 * abs(a)):
            raise AssertionError(f"small-input losses differ: cpu {lc} "
                                 f"cuda {lg}")
    worst = 0.0
    pc = dict(outs["cpu"]["model"].named_parameters())
    for name, x in outs["cuda"]["model"].named_parameters():
        worst = max(worst, float((x.detach().cpu() - pc[name].detach())
                                 .abs().max()))
    log(json.dumps({"phase": "small_input", "losses_cpu": lc,
                    "losses_cuda": lg, "max_param_abs_diff": worst}))
    if worst > 2e-5:
        raise AssertionError(f"small-input params differ by {worst}")


def run_main_path(torch, fused_step):
    """Phase 5: bert-large, full width, both engines; returns the launch
    counts of the adama run (the main path) and of the ga run."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
    from repro_torch.train.loop import train

    cfg = get_config(MAIN["arch"])
    ln_v = math.log(cfg.padded_vocab())
    counts = {}
    for engine in ("adama", "ga"):
        run = RunConfig(model=cfg,
                        optimizer=OptimizerConfig(
                            accumulation=engine,
                            micro_batches=MAIN["micro_batches"]),
                        seq_len=MAIN["seq_len"],
                        global_batch=MAIN["global_batch"],
                        seed=MAIN["seed"], steps=MAIN["steps"], log_every=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_step.arena_fold.launches = 0
        fused_step.arena_apply.launches = 0
        out = train(run, device="cuda", log_fn=log)
        counts[engine] = {"arena_fold": fused_step.arena_fold.launches,
                          "arena_apply": fused_step.arena_apply.launches}
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(x.numel() for x in out["model"].parameters())
        rows = out["opt_state"]["m"].layout.rows
        log(json.dumps({"phase": "main_path", "engine": engine,
                        "arch": cfg.name, "params": n_params,
                        "arena_rows": rows, "losses": out["losses"],
                        "step_seconds": out["step_seconds"],
                        "max_memory_allocated_bytes": peak,
                        "launches": counts[engine], **MAIN}))
        losses = out["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{engine}: non-finite loss {losses}")
        if abs(losses[0] - ln_v) > 0.1 * ln_v:
            raise AssertionError(f"{engine}: step-1 loss {losses[0]} is not "
                                 f"within 10% of ln(V)={ln_v:.4f}")
        want_folds = MAIN["steps"] * (MAIN["micro_batches"]
                                      if engine == "adama" else 1)
        want = {"arena_fold": want_folds, "arena_apply": MAIN["steps"]}
        if counts[engine] != want:
            raise AssertionError(f"{engine}: kernel launches "
                                 f"{counts[engine]} != {want}")
        if rows != FULL_ROWS:
            raise AssertionError(f"arena rows {rows} != {FULL_ROWS}")
        del out
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, fused_step
    from repro_torch.train.loop import resolve_device

    t_start = time.perf_counter()
    resolve_device("cuda")           # TF32 off for fp32 matmuls
    smi = gpu_name_and_power()
    log(json.dumps({"phase": "versions", "python": sys.version.split()[0],
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": smi,
                    "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32]}))

    t0 = time.perf_counter()
    outputs = build.build_all()
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "sources": sorted(outputs)}))
    for name, text in outputs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    kernels = check_kernels(torch, fused_step)
    check_small_input(torch)
    counts = run_main_path(torch, fused_step)

    replaces = {"arena_fold": "src/repro/kernels/fused_step.py:406",
                "arena_apply": "src/repro/kernels/fused_step.py:552"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_step.cu",
         "replaces": replaces[name],
         "launches": counts["adama"][name],
         "launches_by_path": {e: c[name] for e, c in counts.items()},
         **kernels[name]} for name in ("arena_fold", "arena_apply")],
        "seconds": time.perf_counter() - t_start}
    print(json.dumps(line))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
