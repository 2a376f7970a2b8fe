"""olmo-1b — 16L d2048 16H (MHA kv=16) ff8192 v50304; non-parametric LN.
[arXiv:2402.00838; hf]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, kv_heads=16, d_ff=8192, vocab=50304,
    rope="rope", ffn_act="swiglu", ln_kind="nonparametric")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
    vocab=256, remat="none")
