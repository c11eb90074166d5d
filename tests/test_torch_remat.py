"""Activation checkpointing (`remat`) in the port, on the CPU at reduced
bert-large, stablelm-1.6b and rwkv6-7b (2 layers, seq 32):

  - `loss_fn(remat=True)` gives `loss_fn(remat=False)`'s loss and every
    leaf's gradient bit for bit: the recompute repeats the forward's
    operations on the same inputs;
  - each engine with `remat=True` equals itself with `remat=False` bit for
    bit over 2 steps (losses, params, m, v and every other state tensor):
    ga, adama and adama_layerwise on arena state on each arch, per-leaf
    adama, guarded adama with a NaN at micro-batch 1, the bf16 wire, and
    the fp8 wire with master params and the working-param cache;
  - kernel wrapper calls: folds and applies are unchanged; the rwkv6 scan,
    driven through its CUDA path's autograd.Function (its wrappers run
    their plain versions on CPU tensors), runs its forward twice per layer
    (forward and recompute) and its backward once, and the backward reads
    the chunk states the recompute wrote;
  - `train()` with RunConfig(remat=True), crashed by crash@step=1 and
    resumed, ends on the run that never stopped bit for bit;
  - RunConfig.remat defaults to False, as the reference's does;
  - launch/memory_split.py: its allocator-history replay (`--peak-sites`)
    and a subset of its runs (`--runs`), with the CUDA calls stubbed.

The port's remat engines against the reference's remat engines are
tests/test_torch_engines.py's and tests/test_torch_layerwise.py's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
from repro_torch.core import arena as tarena
from repro_torch.core.accumulation import make_train_step
from repro_torch.data import make_data
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import rwkv6_chunk as rc
from repro_torch.models import model as tmodel
from repro_torch.models import modules as md
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import faults as tfaults
from repro_torch.train.loop import train

torch.set_num_threads(1)

ARCHS = ("bert_large", "stablelm_1_6b", "rwkv6_7b")
N_MICRO, GLOBAL_BATCH, SEQ, STEPS = 2, 4, 32, 2
FP8_MASTER_CACHE = dict(m_codec="int8", state_codec="rowcol",
                        grad_dtype="fp8_e4m3", finite_guard=True,
                        loss_scale="dynamic", master_params=True,
                        work_param_cache=True)
# name -> (arch, engine, OptimizerConfig fields, fault)
ENGINE_CASES = {
    **{f"{e}-{a}": (a, e, {}, None) for a in ARCHS
       for e in ("ga", "adama", "adama_layerwise")},
    "adama-per-leaf": ("stablelm_1_6b", "adama", dict(arena=False), None),
    "adama-guarded-nan": ("stablelm_1_6b", "adama",
                          dict(finite_guard=True), "nan@micro=1"),
    "adama-bf16-wire": ("stablelm_1_6b", "adama", dict(grad_dtype="bf16"),
                        None),
    "adama-fp8-master-cache": ("stablelm_1_6b", "adama", FP8_MASTER_CACHE,
                               None),
}


def _cfg(arch):
    return get_config(arch).reduced()


def _tree(cfg):
    gen = torch.Generator()
    gen.manual_seed(0)
    return tmodel.Model(cfg, tmodel.init_params(cfg, gen)).tree()


def _batches(cfg, n=STEPS, size=GLOBAL_BATCH):
    data = make_data(cfg, SEQ, size, seed=5)
    return [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(n)]


def _bytes(x):
    if isinstance(x, int):
        return np.int64(x).tobytes()
    x = x.detach()
    if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int8)
    return x.contiguous().numpy().tobytes()


def _assert_bitwise(a, b):
    la, lb = tckpt.tree_leaves(a), tckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert _bytes(x) == _bytes(y), i


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_remat_equals_plain_bit_for_bit(arch):
    cfg = _cfg(arch)
    tree = _tree(cfg)
    leaves, _ = tarena.tree_flatten(tree)
    batch = _batches(cfg, 1, 2)[0]
    out = []
    for remat in (False, True):
        loss = tmodel.loss_fn(cfg, tree, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.isfinite(l0) and _bytes(l0) == _bytes(l1)
    assert len(g0) == len(g1) == len(leaves)
    for x, a, b in zip(leaves, g0, g1):
        assert a.shape == x.shape and _bytes(a) == _bytes(b)
    assert any(bool(a.abs().max() > 0) for a in g0[1:])


def _engine_run(case, remat):
    arch, engine, kw, fault = ENGINE_CASES[case]
    cfg = _cfg(arch)
    step, init = make_train_step(
        cfg, OptimizerConfig(accumulation=engine, micro_batches=N_MICRO,
                             **kw),
        remat=remat, fault=tfaults.parse_fault(fault))
    tree = _tree(cfg)
    state = init(tree)
    losses, metrics = [], []
    for batch in _batches(cfg):
        tree, state, mx = step(tree, state, batch)
        losses.append(float(mx["loss"]))
        metrics.append({k: float(x) for k, x in mx.items()})
    return losses, metrics, {"params": tree, "opt": state}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_remat_equals_plain_bit_for_bit(case):
    l0, m0, s0 = _engine_run(case, False)
    l1, m1, s1 = _engine_run(case, True)
    assert all(np.isfinite(l0)) and l0 == l1 and m0 == m1
    assert s0["opt"]["step"] == s1["opt"]["step"]
    _assert_bitwise(s0, s1)
    if ENGINE_CASES[case][3]:                 # the NaN was caught
        assert m1[0]["skipped_micro_batches"] == 1


def _count(monkeypatch, calls, mod, name):
    def wrapper(*a, _fn=getattr(mod, name), **kw):
        calls[name] = calls.get(name, 0) + 1
        return _fn(*a, **kw)
    monkeypatch.setattr(mod, name, wrapper)


def _scan_on_its_cuda_path(monkeypatch, calls, states):
    """The time-mix runs the scan through `_Scan`, the autograd.Function of
    the card (whose wrappers take the plain versions on CPU tensors), and
    the forward's and backward's wrapper calls are counted; `states` holds
    every saved-states tensor the forward wrote and the backward read."""
    fwd, bwd = rc.scan_forward, rc.rwkv6_chunk_scan_bwd

    def scan(r, k, v, logw, u, s0, *, chunk=rc.CHUNK):
        save = torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, s0))
        return rc._Scan.apply(r, k, v, logw, u, s0, chunk, save)

    def forward(*a, **kw):
        calls["rwkv6_chunk_scan"] = calls.get("rwkv6_chunk_scan", 0) + 1
        out = fwd(*a, **kw)
        states["written"].append(out[2])
        return out

    def backward(r, k, v, logw, u, st, *a, **kw):
        calls["rwkv6_chunk_scan_bwd"] = calls.get(
            "rwkv6_chunk_scan_bwd", 0) + 1
        states["read"].append(st)
        return bwd(r, k, v, logw, u, st, *a, **kw)
    monkeypatch.setattr(md, "rwkv6_chunk_scan", scan)
    monkeypatch.setattr(rc, "scan_forward", forward)
    monkeypatch.setattr(rc, "rwkv6_chunk_scan_bwd", backward)


@pytest.mark.parametrize("engine", ["ga", "adama"])
def test_wrapper_calls_under_remat(engine, monkeypatch):
    """Per step: N folds (ga: 1) and one apply with or without remat; the
    scan's forward L x N times without remat and 2 L x N with it (the
    recompute), its backward L x N times either way; every states tensor
    the backward reads under remat is one a recompute wrote (the second
    forward call of its layer's pair), and the trajectories are equal bit
    for bit."""
    calls, out = {}, {}
    for name in ("arena_fold", "arena_apply"):
        _count(monkeypatch, calls, tfs, name)
    for remat in (False, True):
        calls.clear()
        states = {"written": [], "read": []}
        with monkeypatch.context() as mp:
            _scan_on_its_cuda_path(mp, calls, states)
            cfg = _cfg("rwkv6_7b")
            step, init = make_train_step(
                cfg, OptimizerConfig(accumulation=engine,
                                     micro_batches=N_MICRO), remat=remat)
            tree = _tree(cfg)
            state = init(tree)
            losses = []
            for batch in _batches(cfg):
                tree, state, mx = step(tree, state, batch)
                losses.append(float(mx["loss"]))
        n, L = N_MICRO * STEPS, cfg.num_layers
        assert calls == {"arena_fold": (n if engine == "adama" else STEPS),
                         "arena_apply": STEPS,
                         "rwkv6_chunk_scan": (2 if remat else 1) * n * L,
                         "rwkv6_chunk_scan_bwd": n * L}
        written = [x.data_ptr() for x in states["written"]]
        read = [x.data_ptr() for x in states["read"]]
        if remat:
            # per micro-batch: L forward calls, then per layer (last first)
            # its recompute, then its backward
            for j, ptr in enumerate(read):
                mb, back = divmod(j, L)
                assert ptr == written[mb * 2 * L + L + back]
        else:
            assert sorted(read) == sorted(written)
        out[remat] = (losses, {"params": tree, "opt": state})
    assert out[False][0] == out[True][0]
    _assert_bitwise(out[False][1], out[True][1])


def _run(steps, fault=None, **kw):
    cfg = _cfg("stablelm_1_6b")
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(
        accumulation="adama", micro_batches=N_MICRO), seq_len=SEQ,
        global_batch=GLOBAL_BATCH, seed=0, steps=steps, log_every=1,
        remat=True, inject_fault=fault, **kw)
    logs = []
    return train(run, device="cpu", log_fn=logs.append), logs


def test_train_with_remat_resumes_after_a_crash_bit_for_bit(tmp_path):
    """crash@step=1 ends the remat run after step 2's update and before its
    save; the resumed run (remat from its own RunConfig: no checkpoint
    holds it) ends on the clean remat run bit for bit, which is the plain
    run's."""
    clean, _ = _run(3)
    ckpt = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                keep_last_n=1)
    with pytest.raises(tfaults.InjectedCrash):
        _run(3, "crash@step=1", **ckpt)
    assert tckpt.latest_step(tmp_path / "ck") == 1
    out, logs = _run(3, **ckpt)
    assert logs[0] == "[train] restored step 1"
    assert out["losses"] == clean["losses"][1:]
    assert out["opt_state"]["step"] == clean["opt_state"]["step"] == 3
    _assert_bitwise({"params": out["params"], "opt": out["opt_state"]},
                    {"params": clean["params"], "opt": clean["opt_state"]})
    plain = train(RunConfig(
        model=_cfg("stablelm_1_6b"), optimizer=OptimizerConfig(
            accumulation="adama", micro_batches=N_MICRO), seq_len=SEQ,
        global_batch=GLOBAL_BATCH, seed=0, steps=3, log_every=1),
        device="cpu", log_fn=lambda _: None)
    assert plain["losses"] == clean["losses"]
    _assert_bitwise({"params": plain["params"], "opt": plain["opt_state"]},
                    {"params": clean["params"], "opt": clean["opt_state"]})


def test_run_config_remat_defaults_to_false_like_the_reference():
    field = {f.name: f for f in dataclasses.fields(RunConfig)}["remat"]
    ref = {f.name: f for f in dataclasses.fields(JaxRunConfig)}["remat"]
    assert field.default is ref.default is False
    assert RunConfig(model=_cfg("bert_large")).remat is False


def _frames(line):
    return [{"filename": "/x/torch/nn/functional.py", "line": 1,
             "name": "f"},
            {"filename": "/x/src/repro_torch/models/modules.py",
             "line": line, "name": "g"}]


def test_memory_split_peak_sites_replay_the_allocator_history(monkeypatch):
    """peak_sites replays the allocator's events: the peak is the most
    bytes live at once, its sites are the innermost frames of this package
    (or the autograd engine's, without frames), and the share is the
    position of the peak's event."""
    from repro_torch.launch import memory_split as ms
    trace = [
        {"action": "alloc", "addr": 1, "size": 100, "frames": _frames(7)},
        {"action": "alloc", "addr": 2, "size": 50, "frames": _frames(9)},
        {"action": "free_requested", "addr": 1, "size": 100},
        {"action": "free_completed", "addr": 1, "size": 100},
        {"action": "alloc", "addr": 3, "size": 70, "frames": []},
        {"action": "alloc", "addr": 4, "size": 40, "frames": _frames(9)},
        {"action": "free_completed", "addr": 4, "size": 40},
        {"action": "alloc", "addr": 5, "size": 30, "frames": _frames(7)},
    ]
    recorded, ran = [], []
    monkeypatch.setattr(torch.cuda.memory, "_record_memory_history",
                        lambda *a, **kw: recorded.append(kw))
    monkeypatch.setattr(torch.cuda.memory, "_snapshot",
                        lambda: {"device_traces": [trace]})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out = ms.peak_sites(lambda: ran.append(1), top=2)
    assert ran == [1] and recorded[-1] == {"enabled": None}
    # live: 150 after event 1, 50 + 70 + 40 = 160 at event 5
    assert out["live_at_peak_bytes"] == 160
    assert out["peak_at_event_share"] == 5 / len(trace)
    assert out["sites"] == [["models/modules.py:9 (g)", 90],
                            [ms.NO_FRAME, 70]]


def test_memory_split_runs_a_subset(monkeypatch):
    """--runs picks some of the three runs; a difference needs both of its
    runs. The CUDA calls are stubbed, the runs themselves execute."""
    from repro_torch.launch import memory_split as ms
    monkeypatch.setattr(ms, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(ms, "get_config",
                        lambda a: get_config(a).reduced())
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 5)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    out = ms.memory_split("stablelm-1.6b", seq_len=16, micro_batch=2,
                          num_layers=1, runs=("ckpt", "layerwise"))
    assert out["num_layers"] == 1
    assert out["peak_over_resident_bytes"] == {"ckpt": 5, "layerwise": 5}
    assert out["recompute_saving_bytes"] is None
    assert out["per_layer_fold_saving_bytes"] == 0
