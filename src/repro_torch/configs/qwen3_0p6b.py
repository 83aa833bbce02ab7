"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 -- qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=3072, vocab_size=151936, head_dim=128,
        attention="gqa", qk_norm=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="gqa", qk_norm=True,
        param_dtype="float32", compute_dtype="float32",
    )
