"""phi3-medium-14b — 40L d5120 40H (GQA kv=10) ff17920 v100352; RoPE
SwiGLU GQA. [arXiv:2404.14219; unverified]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, kv_heads=10, d_ff=17920, vocab=100352,
    rope="rope", ffn_act="swiglu")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=256, remat="none")
