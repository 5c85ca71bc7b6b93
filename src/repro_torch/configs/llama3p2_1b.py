"""llama3.2-1b: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab=128256, tie_embeddings=True, rope_theta=500000.0,
        citation="hf:meta-llama/Llama-3.2-1B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab=512, tie_embeddings=True,
        attn_q_chunk=16, attn_k_chunk=16,
    )
