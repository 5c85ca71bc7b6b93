"""Architecture configs for the PyTorch port.

A copy of ``repro.configs`` (the JAX package's dataclasses, same fields
and defaults) so that this package imports nothing of ``repro``. Three
differences, all forced by the framework:

- ``ModelConfig.dtype`` returns ``torch`` dtypes;
- ``attn_impl`` names the port's paths: ``"gather"`` (the JAX
  ``"xla"`` path: attention over the dense K/V layout) and ``"cuda"``
  (the JAX ``"pallas"`` path: hand-written kernels reading K/V through
  the block table);
- ``SSMConfig.scan_impl`` likewise: ``"cuda"`` is the JAX ``"kernel"``
  path (the hand-written selective-scan kernel); ``"assoc"`` and
  ``"blocked"`` keep their names.

Ported so far: the dense family (smollm-135m, llama3.2-1b, olmo-1b,
qwen2-7b) and the pure-SSM mamba1 family (falcon-mamba-7b). The other
architectures wait for their families' slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    scan_dtype: str = "float32"
    scan_impl: str = "assoc"       # assoc|blocked|cuda (mamba1 scan)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm|layernorm|nonparametric_ln
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0
    encoder_layers: int = 0
    n_frames: int = 1500
    n_patches: int = 256
    max_target_len: int = 448
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    layer_loop: str = "scan"
    save_policy: str = "all"
    grad_accum: int = 1
    remat: str = "full"
    attn_impl: str = "gather"      # gather|cuda (cuda = block-table kernels)
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    attn_skip_masked_blocks: bool = False
    fuse_attn_mlp_allgather: bool = False
    early_exit: bool = False
    exit_threshold: float = float("inf")
    exit_min_layers: int = 1
    mod_capacity: float = 0.0
    mod_every: int = 2
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256, as the JAX package pads it, so that
        logits have the same width in both packages."""
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def dtype(self, which: str) -> torch.dtype:
        return getattr(torch, getattr(self, which + "_dtype"))


ARCH_IDS = ("olmo-1b", "smollm-135m", "qwen2-7b", "llama3.2-1b",
            "falcon-mamba-7b")

_MODULES = {
    "olmo-1b": "olmo_1b",
    "smollm-135m": "smollm_135m",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-1b": "llama3p2_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

_NOT_PORTED = ("dbrx-132b", "qwen2-moe-a2.7b", "zamba2-1.2b",
               "whisper-small", "internvl2-1b")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a config whose model family the port does not run:
    anything but dense and pure-SSM mamba1 (hybrid and mamba2 wait for
    the hybrid slice)."""
    if cfg.family == "dense":
        return
    if cfg.family == "ssm" and cfg.ssm is not None and \
            cfg.ssm.kind == "mamba1":
        return
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; see ROADMAP.md")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} belongs to a model family the PyTorch port has not "
            f"reached yet; see ROADMAP.md")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke_config() if smoke else mod.full_config()
