"""Unified model configuration covering all 10 assigned architectures.

One dataclass, no code forks: family differences (GQA vs MLA attention,
dense vs MoE FFN, attention vs SSD mixing, decoder-only vs encoder-decoder,
modality frontends) are expressed as config fields consumed by
models/transformer.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // num_heads

    # -- attention flavour --------------------------------------------------
    attention: str = "gqa"                   # gqa | mla | none
    qk_norm: bool = False                    # qwen3-style per-head RMS on q,k
    qkv_bias: bool = False                   # qwen2-style bias on qkv proj
    causal: bool = True
    rope_theta: float = 10000.0
    rope_style: str = "standard"             # standard | mrope | none
    mrope_sections: tuple = (16, 24, 24)     # qwen2-vl t/h/w rotary split

    # -- MLA (multi-head latent attention; minicpm3/deepseek-v2 style) ------
    mla_q_lora_rank: int = 0
    mla_kv_lora_rank: int = 0
    mla_qk_nope_dim: int = 0
    mla_qk_rope_dim: int = 0
    mla_v_head_dim: int = 0

    # -- MoE -----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                        # per-expert hidden (default d_ff)
    moe_shared_expert: bool = False          # llama4-style always-on expert
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # -- SSM / Mamba2 (SSD) ---------------------------------------------------
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_expand: int = 2

    # -- hybrid (zamba2): shared attention block every N blocks ---------------
    hybrid_attn_every: int = 0

    # -- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    encoder_seq_len: int = 1500              # whisper 30s of audio frames
    frontend: str = "none"                   # none | audio_stub | vision_stub

    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # Fully unroll layer scans (dry-run calibration only: XLA cost_analysis
    # counts rolled loop bodies once, so calibration compiles small
    # unrolled variants to recover true per-layer costs).
    scan_unroll: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived -------------------------------------------------------------

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM / hybrid only (DESIGN.md)."""
        return self.family in ("ssm", "hybrid")

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.attention == "mla":
            r_q, r_kv = self.mla_q_lora_rank, self.mla_kv_lora_rank
            qk = self.mla_qk_nope_dim + self.mla_qk_rope_dim
            return (d * r_q + r_q * self.num_heads * qk
                    + d * (r_kv + self.mla_qk_rope_dim)
                    + r_kv * self.num_heads * (self.mla_qk_nope_dim
                                               + self.mla_v_head_dim)
                    + self.num_heads * self.mla_v_head_dim * d)
        n = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
             + self.num_heads * hd * d)
        if self.qkv_bias:
            n += (self.num_heads + 2 * self.num_kv_heads) * hd
        return n

    def _ssm_params(self) -> int:
        d = self.d_model
        dn = self.ssm_expand * d
        H = self.ssm_num_heads or max(1, dn // self.ssm_head_dim)
        N = self.ssm_state_dim
        return (d * (2 * dn + 2 * N + H) + dn * d
                + self.ssm_conv_width * (dn + 2 * N))

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe_num_experts:
            n = d * self.moe_num_experts  # router
            n += self.moe_num_experts * 3 * d * self.moe_d_ff
            if self.moe_shared_expert:
                n += 3 * d * self.d_ff
            return n
        return 3 * d * self.d_ff

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + norms)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        n = V * d                                      # embedding
        if not self.tie_embeddings:
            n += V * d

        if self.family == "ssm":
            n += L * (self._ssm_params() + d)
            return n
        if self.family == "hybrid":
            every = max(self.hybrid_attn_every, 1)
            groups = L // every
            mamba_layers = L - groups
            n += mamba_layers * (self._ssm_params() + d)
            # ONE shared attention+MLP block (applied `groups` times)
            n += self._attn_params() + self._ffn_params() + 2 * d
            return n

        per_layer = self._attn_params() + self._ffn_params() + 2 * d
        n += L * per_layer
        if self.is_encdec:
            enc = self.encoder_layers * (4 * d * self.num_heads * hd
                                         + 3 * d * f + 2 * d)
            xattn = self.num_layers * (4 * d * self.num_heads * hd + d)
            n += enc + xattn
        return n

    def active_params(self) -> int:
        """Activated parameters per token (MoE top-k instead of all experts)."""
        if not self.moe_num_experts:
            return self.num_params()
        total = self.num_params()
        inactive = (self.moe_num_experts - self.moe_top_k)
        per_expert = 3 * self.d_model * self.moe_d_ff
        return total - self.num_layers * inactive * per_expert
