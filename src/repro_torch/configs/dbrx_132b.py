"""dbrx-132b: 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert,
vocab=100352, MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]"""
from . import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab=100352, rope_theta=500000.0,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
        layer_loop="paper_while", save_policy="carry_offload",
        grad_accum=8,
        citation="hf:databricks/dbrx-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
        attn_q_chunk=16, attn_k_chunk=16,
    )
