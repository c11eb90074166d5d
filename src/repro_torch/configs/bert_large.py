"""BERT-Large (the paper's own workload, Devlin et al. 2018).

Encoder-only: 24L d_model=1024 16H d_ff=4096 vocab=30522 (padded to 30592).
Trained here with an MLM-style cross-entropy on synthetic data.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    arch_type="encoder",
    source="paper §4.1 / arXiv:1810.04805",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    attention="gqa",
    norm="layernorm",
    act="gelu",
    pos_emb="sinusoidal",
    max_seq_len=512,
)
