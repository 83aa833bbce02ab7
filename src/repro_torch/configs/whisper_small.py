"""whisper-small [audio]: 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 -- encoder-decoder, conv frontend (STUB: input_specs()
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        attention="gqa", rope_style="none",       # whisper uses learned/sinusoidal pos
        encoder_layers=12, encoder_seq_len=1500,
        frontend="audio_stub", norm_eps=1e-5, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        attention="gqa", rope_style="none",
        encoder_layers=2, encoder_seq_len=32,
        frontend="audio_stub", norm_eps=1e-5,
        param_dtype="float32", compute_dtype="float32",
    )
