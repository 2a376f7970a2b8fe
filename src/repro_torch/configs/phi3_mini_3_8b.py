"""phi3-mini-3.8b — 32L d3072 32H (MHA kv=32) ff8192 v32064; RoPE SwiGLU.
[arXiv:2404.14219; unverified]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, kv_heads=32, d_ff=8192, vocab=32064,
    rope="rope", ffn_act="swiglu")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
    vocab=256, remat="none")
