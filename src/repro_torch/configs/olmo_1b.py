"""olmo-1b: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab=50304, norm="nonparametric_ln",
        tie_embeddings=True, attn_skip_masked_blocks=True,
        citation="arXiv:2402.00838",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, norm="nonparametric_ln", tie_embeddings=True,
        attn_q_chunk=16, attn_k_chunk=16,
    )
