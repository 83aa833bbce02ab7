"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 -- MoE, early fusion (modality
fusion is upstream of the backbone; text backbone modeled here).
[hf:meta-llama/Llama-4 family; unverified]

Shared always-on expert per llama4; dry-run pairs this config with
Adafactor + full remat (see configs in launch/dryrun.py) to fit HBM.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128,
        attention="gqa", rope_theta=5e5,
        moe_num_experts=128, moe_top_k=1, moe_d_ff=8192,
        moe_shared_expert=True, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attention="gqa",
        moe_num_experts=8, moe_top_k=1, moe_d_ff=128,
        moe_shared_expert=True, tie_embeddings=False,
        param_dtype="float32", compute_dtype="float32",
    )
