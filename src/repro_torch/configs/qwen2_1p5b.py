"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 -- GQA, QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936,
        attention="gqa", qkv_bias=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        attention="gqa", qkv_bias=True,
        param_dtype="float32", compute_dtype="float32",
    )
