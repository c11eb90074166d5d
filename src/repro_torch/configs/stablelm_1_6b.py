"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b].

Dense decoder, 24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    attention="gqa",
    norm="layernorm",
    act="silu",
    max_seq_len=4096,
)
