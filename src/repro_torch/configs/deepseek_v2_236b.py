"""DeepSeek-V2 236B [arXiv:2405.04434].

MoE decoder with mla: 60L d_model=5120 128H, the dense prefix block's
d_ff=12288, routed experts of d_ff 1536, vocab=102400; 2 shared + 160
routed experts, top-6; kv_lora_rank=512, q_lora_rank=1536, q/k heads of
128 + 64 (nope + rope), v heads of 128. The first block is dense.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # the dense prefix block's FFN
    vocab_size=102400,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=128,
    moe=MoEConfig(n_experts=160, n_shared=2, top_k=6, d_expert=1536,
                  dense_prefix=1),
    max_seq_len=32768,
)
