"""InternVL2-26B [arXiv:2404.16821].

VLM: the InternViT-6B vision encoder is a stub, as in the reference (the
data pipeline provides projected patch embeddings), in front of the
InternLM2-20B language backbone: 48L d_model=6144 48H (GQA kv=8, head_dim
128) d_ff=16384 vocab=92553 (92672 padded). The backbone consumes
[patches; text] and the loss is taken on the text tail.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attention="gqa",
    n_patch_tokens=256,      # one 448x448 tile / 14 patch, pixel-shuffled
    max_seq_len=32768,
)
