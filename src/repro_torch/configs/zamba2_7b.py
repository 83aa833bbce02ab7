"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 -- Mamba2 blocks + SHARED attention block
(same parameters applied at every 6th position; the per-site LoRA
specialization of the released model is omitted -- noted in DESIGN.md).
[arXiv:2411.15242; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        attention="gqa", rope_theta=10000.0,
        ssm_state_dim=64, ssm_num_heads=56, ssm_head_dim=128,
        ssm_conv_width=4, ssm_chunk=128, ssm_expand=2,
        hybrid_attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="gqa",
        ssm_state_dim=16, ssm_num_heads=4, ssm_head_dim=32,
        ssm_conv_width=4, ssm_chunk=16, ssm_expand=2,
        hybrid_attn_every=3,
        param_dtype="float32", compute_dtype="float32",
    )
