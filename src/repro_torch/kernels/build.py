"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface, loaded with ctypes. Nothing is built when a module is
imported: `load(name)` builds at first use, `build_all()` starts one nvcc
per source, all at once. Builds land in `build/repro_torch_kernels/` at the
root of the checkout (listed in .gitignore), keyed on a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused within a checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# no --use_fast_math: division and sqrt stay IEEE-rounded, and
# --fmad=false keeps nvcc from contracting mul+add pairs the plain PyTorch
# versions round separately
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA kernels need the CUDA "
                       "toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is built; returns
    (target, tmp, process) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)      # atomic: no process loads a half-written file
    return out


def sources() -> Iterable[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each). Returns the
    compiler's output per source ("" where the library was already built)."""
    names = list(sources())
    started = {n: _start(n) for n in names}
    return {n: _finish(n, started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def bind(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The library of csrc/<name>.cu with each launcher's C signature set
    (`signatures`: launcher name -> argtypes; every launcher returns the
    CUDA error code as an int)."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _bound[name] = lib
    return lib


def launch(fn: str, launcher, lead: torch.Tensor, *args) -> None:
    """Call a launcher on the current stream of `lead`'s device; raise if
    the launch was refused."""
    with torch.cuda.device(lead.device):
        err = launcher(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{err}")
