"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Backbone only: the vision tower is a STUB -- input_specs() provides
precomputed patch embeddings; M-RoPE consumes (t, h, w) position ids
(all equal for text-only cells)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064,
        attention="gqa", qkv_bias=True,
        rope_style="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        frontend="vision_stub", tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="gqa", qkv_bias=True,
        rope_style="mrope", mrope_sections=(2, 3, 3),
        frontend="vision_stub", tie_embeddings=False,
        param_dtype="float32", compute_dtype="float32",
    )
