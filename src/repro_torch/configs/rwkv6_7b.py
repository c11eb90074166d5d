"""RWKV-6 "Finch" 7B [arXiv:2404.05892].

Attention-free SSM: 32L d_model=4096 d_ff=14336 vocab=65536, data-dependent
decay, matrix-valued state per head (head_dim=64 -> 64 heads).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    n_heads=64,             # d_model / head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    ssm=SSMConfig(head_dim=64),
    max_seq_len=1 << 20,
)
