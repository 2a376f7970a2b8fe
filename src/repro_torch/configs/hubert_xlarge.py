"""hubert-xlarge — 48L d1280 16H ff5120 v504; encoder-only (same arch as
wav2vec2); the conv waveform frontend is a STUB — input_specs() supplies
precomputed frame embeddings per the assignment. [arXiv:2106.07447]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, kv_heads=16, d_ff=5120, vocab=504,
    rope="none", ffn_act="gelu", causal=False, frontend="audio")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
    vocab=64, remat="none")
