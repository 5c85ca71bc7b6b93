"""zamba2-1.2b: 38 mamba2 layers d_model=2048 + one shared attention
block (32H kv=32, d_ff=8192) applied periodically; ssm_state=64;
vocab=32000. [arXiv:2411.15242; hf]"""
from . import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                      head_dim=64),
        shared_attn_every=6,
        citation="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                      head_dim=16, chunk=8),
        shared_attn_every=2,
        attn_q_chunk=16, attn_k_chunk=16,
    )
