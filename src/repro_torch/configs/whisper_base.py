"""Whisper-base [arXiv:2212.04356].

Encoder-decoder audio model: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 (51968 padded). The mel-spectrogram and conv frontend is a
stub, as in the reference: the data pipeline provides the frame embeddings
(batch, 1500, 512). The decoder's context is 448 tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq_len=1500,    # 30 s of audio after the conv stub
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    attention="gqa",
    norm="layernorm",
    act="gelu",
    pos_emb="sinusoidal",
    max_seq_len=448,
)
