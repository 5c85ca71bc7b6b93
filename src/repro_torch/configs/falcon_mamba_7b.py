"""falcon-mamba-7b: 64L d_model=4096, attention-free mamba1,
ssm_state=16, vocab=65024. [arXiv:2410.05355; unverified]"""
from . import ModelConfig, SSMConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=65024,
        ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2,
                      scan_dtype="float32", scan_impl="assoc"),
        layer_loop="paper_while", save_policy="carry_offload",
        citation="arXiv:2410.05355",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=512,
        ssm=SSMConfig(kind="mamba1", d_state=8, d_conv=4, expand=2, chunk=8),
    )
