"""qwen2-moe-a2.7b: 24L d_model=2048 16H (kv=16) d_ff=1408/expert,
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from . import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=151936, qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                      n_shared_experts=4, d_ff_shared=5632),
        citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=48, vocab=512, qkv_bias=True,
        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=48,
                      n_shared_experts=2, d_ff_shared=96),
        attn_q_chunk=16, attn_k_chunk=16,
    )
