"""Deterministic synthetic data pipeline, a numpy-only copy of the
reference's `repro/data/pipeline.py`: batch i is a pure function of
(seed, i) and is bit-identical to the reference's batch i.

A hidden-state Markov generator (power-law unigram mix + per-state boosted
tokens) so cross-entropy actually decreases during training. Encoder
configs get MLM-style masking: 15% of positions are replaced by token
`vocab_size - 1` and carry labels; every other label is -1. The stub
frontends draw from the same generator after the tokens: an audio (enc-dec)
config's "frames" (batch, encoder_seq_len, d_model) and a vlm config's
"patches" (batch, n_patch_tokens, d_model), float32 standard normals times
0.02.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # hidden Markov states
    arch_type: str = "dense"
    d_model: int = 0            # for the stub frontends (audio, vlm)
    encoder_seq_len: int = 0
    n_patch_tokens: int = 0


class SyntheticLM:
    """Hidden-Markov token source: state-dependent unigram mixtures with a
    Zipfian base, fixed per seed."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, k = cfg.vocab_size, cfg.n_states
        zipf = 1.0 / np.arange(1, v + 1) ** 1.1
        self.base = zipf / zipf.sum()
        # per-state sparse boosts
        self.boost_idx = rng.integers(0, v, size=(k, 32))

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        b, s = cfg.global_batch, cfg.seq_len
        # per-row state fixed over segments of 64 tokens
        seg = 64
        nseg = -(-s // seg)
        states = rng.integers(0, cfg.n_states, size=(b, nseg))
        # with p=0.3 a boosted token of the segment state, else Zipf base
        base_draw = rng.choice(cfg.vocab_size, p=self.base, size=(b, nseg, seg))
        boost_col = rng.integers(0, 32, size=(b, nseg, seg))
        boosted = self.boost_idx[states[..., None], boost_col]
        use_boost = rng.random((b, nseg, seg)) < 0.3
        toks = np.where(use_boost, boosted, base_draw).reshape(b, nseg * seg)
        toks = toks[:, :s].astype(np.int32)
        out = {"tokens": toks,
               "labels": np.concatenate([toks[:, 1:],
                                         np.full((b, 1), -1, np.int32)], 1)}
        if cfg.arch_type == "audio":
            out["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32) * 0.02
        if cfg.arch_type == "vlm":
            out["patches"] = rng.standard_normal(
                (b, cfg.n_patch_tokens, cfg.d_model)).astype(
                    np.float32) * 0.02
        if cfg.arch_type == "encoder":
            mask = rng.random((b, s)) < 0.15
            labels = np.where(mask, toks, -1).astype(np.int32)
            tokens = np.where(mask, cfg.vocab_size - 1, toks).astype(np.int32)
            return {"tokens": tokens, "labels": labels}
        return out

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        i = start
        while True:
            yield self.batch(i)
            i += 1


def make_data(model_cfg, seq_len: int, global_batch: int,
              seed: int = 0) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed, arch_type=model_cfg.arch_type,
        d_model=model_cfg.d_model,
        encoder_seq_len=model_cfg.encoder_seq_len,
        n_patch_tokens=model_cfg.n_patch_tokens))
