"""DeepSeek-V2-Lite 16B [arXiv:2405.04434].

MoE decoder with MLA: 27L d_model=2048 16H, per-expert d_ff=1408,
vocab=102400; 2 shared + 64 routed, top-6; kv_lora_rank=512, no q-lora,
qk nope/rope 128/64, v_head_dim=128. First block dense (d_ff 10944).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,              # dense-prefix FFN
    vocab_size=102400,
    attention="mla",
    q_lora_rank=None,        # lite variant projects q directly
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=128,
    moe=MoEConfig(
        n_experts=64,
        n_shared=2,
        top_k=6,
        d_expert=1408,
        dense_prefix=1,
    ),
    max_seq_len=32768,
)
