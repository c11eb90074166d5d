"""The port stands alone: no file of repro_torch (nor chip_smoke.py) imports
jax or the reference package, importing it loads neither, and its entry
points refuse to fall back to the CPU when CUDA is missing."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import OptimizerConfig, RunConfig, get_config
from repro_torch.train import loop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10 and PORT / "train" / "checkpoint.py" in files
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    return env


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_train_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = RunConfig(model=get_config("bert_large").reduced(),
                    optimizer=OptimizerConfig(micro_batches=2), seq_len=8,
                    global_batch=2, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(run, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(run, device="cuda")
    out = loop.train(run, device="cpu", log_fn=lambda s: None)
    assert len(out["losses"]) == 1


def test_cli_and_chip_smoke_exit_nonzero_without_cuda(tmp_path):
    """The train CLI without --device cpu, chip_smoke.py, and chip_smoke.py
    alone in a directory without the package all fail on a CUDA-less
    machine and print no result line."""
    env = _env(CUDA_VISIBLE_DEVICES="")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "bert-large", "--reduced", "--steps", "1", "--global-batch", "2",
         "--micro-batches", "1", "--seq-len", "8"],
        env=env, capture_output=True, text=True, timeout=120)
    assert cli.returncode != 0 and "CUDA is not available" in cli.stderr
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (alone, alone / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=dict(env, PYTHONPATH=""),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_cli_trains_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-1.6b", "--reduced", "--steps", "2", "--global-batch", "4",
         "--micro-batches", "2", "--seq-len", "16", "--log-every", "1",
         "--accumulation", "ga", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] step") == 2


def test_step_context_wraps_each_timed_step():
    """The profiler hook enters once per step, around that step's work."""
    import contextlib

    run = RunConfig(model=get_config("bert_large").reduced(),
                    optimizer=OptimizerConfig(micro_batches=2), seq_len=8,
                    global_batch=2, steps=2, log_every=10)
    seen = []

    @contextlib.contextmanager
    def ctx(i):
        seen.append(("enter", i))
        yield
        seen.append(("exit", i))

    out = loop.train(run, device="cpu", log_fn=lambda s: None,
                     step_context=ctx)
    assert seen == [("enter", 0), ("exit", 0), ("enter", 1), ("exit", 1)]
    assert len(out["step_seconds"]) == 2
