"""qwen2-vl-2b — 28L d1536 12H (GQA kv=2) ff8960 v151936; M-RoPE (3D
positions), dynamic resolution.  The vision tower is a STUB — the
backbone consumes token ids + (t,h,w) positions per the assignment.
[arXiv:2409.12191; hf]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, kv_heads=2, d_ff=8960, vocab=151936,
    rope="mrope", rope_theta=1e6, mrope_sections=(16, 24, 24),
    ffn_act="swiglu")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=4, kv_heads=2, d_ff=128,
    vocab=256, mrope_sections=(4, 4, 4), remat="none")
