"""Model configuration shared by all architecture families."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000

    # MoE
    n_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_every: int = 1            # jamba: MoE FFN every k-th layer

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0           # jamba: attention layer every k-th layer

    # misc
    rope: str = "rope"            # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    ffn_act: str = "swiglu"       # swiglu | gelu
    ln_kind: str = "rms"          # rms | nonparametric
    causal: bool = True           # False for encoder-only (hubert)
    frontend: str = "none"        # none | audio | vision (stubbed)
    sub_quadratic: bool = False   # True → long_500k decodable

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    kv_cache_dtype: object = None     # e.g. torch.float8_e4m3fn (decode opt)

    # remat: 'none' | 'full' | 'dots_with_no_batch_dims'
    remat: str = "full"
    scan_layers: bool = True
    # attention impl: 'naive' (materializes S×S) | 'chunked' (streaming
    # softmax over KV blocks)
    attn_impl: str = "naive"
    attn_chunk: int = 2048

    # explicit head_dim (0 → d_model/n_heads)
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline bookkeeping)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        n_attn = self.n_layers
        n_ssm = 0
        if self.family == "ssm":
            n_attn, n_ssm = 0, self.n_layers
        elif self.family == "hybrid":
            n_attn = self.n_layers // max(1, self.attn_every)
            n_ssm = self.n_layers - n_attn
        total = 0
        if n_attn:
            hd = self.head_dim
            attn = d * self.n_heads * hd * 2 + d * self.kv_heads * hd * 2
            total += n_attn * attn
        if n_ssm:
            di, st, h = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * st + h) + di * d + 4 * (di + 2 * st) \
                + 2 * h + di
            total += n_ssm * ssm
        # FFN: dense layers vs MoE layers
        if self.d_ff:
            n_moe = (self.n_layers // max(1, self.moe_every)
                     if self.n_experts > 1 else 0)
            n_dense = self.n_layers - n_moe
            mult = 3 if self.ffn_act == "swiglu" else 2
            total += n_dense * mult * d * ff
            total += n_moe * (self.n_experts * 3 * d * ff
                              + d * self.n_experts)
        total += 2 * v * d          # embed + unembed
        total += self.n_layers * 2 * d + d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.n_experts <= 1:
            return self.param_count()
        full = self.param_count()
        n_moe = self.n_layers // max(1, self.moe_every)
        moe_all = n_moe * self.n_experts * 3 * self.d_model * self.d_ff
        moe_active = n_moe * self.top_k * 3 * self.d_model * self.d_ff
        return full - moe_all + moe_active
