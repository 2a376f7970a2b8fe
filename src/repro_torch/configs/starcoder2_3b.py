"""starcoder2-3b — 30L d3072 24H (GQA kv=2) ff12288 v49152; GQA + RoPE,
GELU MLP. [arXiv:2402.19173; hf]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, kv_heads=2, d_ff=12288, vocab=49152,
    rope="rope", ffn_act="gelu")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=256, remat="none")
