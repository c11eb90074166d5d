"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head decoder: each block runs attention heads and Mamba (SSM) heads
in parallel on the same input and fuses them (the mean of the two paths,
each rms-normed). 32L d_model=1600 25H (GQA kv=5) head_dim=64 d_ff=5504
vocab=32001, ssm state 16, conv width 4, expansion 2 (d_inner 3200).
Attention is sliding-window (window 1024) in every layer, as the reference
configures it.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="swa",
    window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    max_seq_len=8192,
)
