"""mamba2-370m — 48L d1024 attn-free, ssm_state=128, v50280; SSD
(state-space duality). [arXiv:2405.21060; unverified]"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    rope="none", sub_quadratic=True)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
    vocab=256, ssm_chunk=16, remat="none")
