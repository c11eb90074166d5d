"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder, 40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336
vocab=131072, 128k context, rope theta 1e6. The released model uses full
attention; the reference exposes a sliding-window variant (window=4096,
Mistral-7B-v0.1-style), which is the one copied here.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    num_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    attention="swa",
    window=4096,
    rope_theta=1e6,
    max_seq_len=131072,
)
