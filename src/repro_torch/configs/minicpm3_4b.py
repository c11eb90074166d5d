"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B].

Dense decoder with MLA, 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA ranks from the model card: q_lora_rank=768, kv_lora_rank=256,
qk_nope/rope head dims 64/32, v_head_dim=64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    head_dim=64,
    max_seq_len=32768,
)
