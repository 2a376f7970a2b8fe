"""grok-1-314b — 64L d6144 48H (GQA kv=8) ff32768 v131072, MoE 8e top-2.
[hf:xai-org/grok-1; unverified]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, kv_heads=8, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, rope="rope", ffn_act="swiglu")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=256, n_experts=4, top_k=2, remat="none")
