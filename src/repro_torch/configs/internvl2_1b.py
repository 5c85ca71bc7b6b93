"""internvl2-1b: LM backbone 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT frontend is a stub (input_specs provides patch
embeddings). [arXiv:2404.16821; hf]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151655, qkv_bias=True, n_patches=256,
        rope_theta=1000000.0,
        citation="arXiv:2404.16821",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, qkv_bias=True, n_patches=8,
        attn_q_chunk=16, attn_k_chunk=16,
    )
