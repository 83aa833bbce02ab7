"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=24, num_kv_heads=24,
        d_ff=0, vocab_size=50280,
        attention="none", rope_style="none",
        ssm_state_dim=128, ssm_num_heads=24, ssm_head_dim=64,
        ssm_conv_width=4, ssm_chunk=128, ssm_expand=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256,
        attention="none", rope_style="none",
        ssm_state_dim=16, ssm_num_heads=4, ssm_head_dim=32,
        ssm_conv_width=4, ssm_chunk=16, ssm_expand=2,
        param_dtype="float32", compute_dtype="float32",
    )
