"""jamba-v0.1-52b — 32L d4096 32H (GQA kv=8) ff14336 v65536, MoE 16e
top-2; Mamba+attention 1:7 interleave (attention 1 per 8 layers), MoE
every other layer; Mamba d_state=16 per the Jamba paper.
[arXiv:2403.19887; hf]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, kv_heads=8, d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    ssm_state=16, ssm_headdim=64, ssm_expand=2,
    rope="rope", ffn_act="swiglu", sub_quadratic=True)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
    vocab=256, n_experts=4, top_k=2, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, remat="none")
