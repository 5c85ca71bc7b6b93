"""qwen2-7b: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
QKV bias. [arXiv:2407.10671; hf]"""
from . import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1000000.0,
        layer_loop="paper_while", save_policy="carry_offload",
        citation="arXiv:2407.10671",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, qkv_bias=True,
        attn_q_chunk=16, attn_k_chunk=16,
    )
