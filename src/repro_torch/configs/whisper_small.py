"""whisper-small: enc-dec, 12L each, d_model=768 12H (kv=12) d_ff=3072
vocab=51865; conv frontend is a stub (input_specs provides precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, encoder_layers=12,
        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=51865, norm="layernorm", n_frames=1500,
        max_target_len=448,
        citation="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="audio",
        n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, norm="layernorm", n_frames=32,
        max_target_len=16,
        attn_q_chunk=16, attn_k_chunk=16,
    )
