"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 -- MLA
(multi-head latent attention).  [hf:openbmb/MiniCPM3-4B; hf]

MLA ranks follow the published MiniCPM3 config: q_lora_rank=768,
kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448, head_dim=96,
        attention="mla",
        mla_q_lora_rank=768, mla_kv_lora_rank=256,
        mla_qk_nope_dim=64, mla_qk_rope_dim=32, mla_v_head_dim=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=24,
        attention="mla",
        mla_q_lora_rank=32, mla_kv_lora_rank=16,
        mla_qk_nope_dim=16, mla_qk_rope_dim=8, mla_v_head_dim=16,
        param_dtype="float32", compute_dtype="float32",
    )
