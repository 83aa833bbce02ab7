"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16e top-4 -- fine-grained.  [hf:databricks/dbrx-base;
unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        attention="gqa", rope_theta=5e5,
        moe_num_experts=16, moe_top_k=4, moe_d_ff=10752,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        attention="gqa",
        moe_num_experts=4, moe_top_k=2, moe_d_ff=96,
        tie_embeddings=False,
        param_dtype="float32", compute_dtype="float32",
    )
