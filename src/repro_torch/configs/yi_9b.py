"""Yi-9B [arXiv:2403.04652].

Llama-architecture dense decoder: 48L d_model=4096 32H (GQA kv=4,
head_dim 128) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    attention="gqa",
    max_seq_len=4096,
)
