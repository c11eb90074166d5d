"""PyTorch/CUDA port of the AdamA training system.

Module names mirror the JAX reference package (`repro_torch/core/arena.py`
is the counterpart of `repro/core/arena.py`). The port imports torch, numpy
and the standard library only; the fused optimizer kernels are CUDA C++
sources under `kernels/csrc/`, built with nvcc at first use.
"""
