"""smollm-135m: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab=49152, tie_embeddings=True,
        citation="hf:HuggingFaceTB/SmolLM-135M",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, tie_embeddings=True,
        attn_q_chunk=16, attn_k_chunk=16,
    )
