"""The port's flash attention and mode ``full`` against the JAX
package's, on the same numpy inputs and the same weights.

On the CPU, ``ops.flash_attention`` runs the kernel's plain version;
the JAX ``flash_attention`` runs its Pallas kernel in interpret mode,
as the JAX package's own tests run it. Tolerances: the two oracles
compute the same fp32 math, 1e-5; the kernel paths are held to the JAX
kernel test's own tolerances (fp32 2e-3, bf16 2e-2,
``tests/kernels/test_kernels.py``); the smoke model's logits to 1e-4 in
fp32 compute with identical greedy tokens, and to 5e-2 in bf16, as
``tests/models/test_kernel_paths.py`` holds the JAX kernel path to the
XLA one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ops import attention_ref as jax_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import model_zoo as jax_zoo
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention, model_zoo, transformer

SWEEP = [(1, 128, 4, 4, 32),     # MHA
         (2, 256, 8, 2, 64),     # GQA 4:1
         (1, 64, 6, 3, 128),     # GQA 2:1, wide head
         (2, 128, 2, 1, 16)]     # MQA
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(B, S, T, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32))


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,D", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(B, S, H, KV, D, causal):
    q, k, v = _qkv(B, S, S, H, KV, D)
    _close(attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         causal=causal),
           jax_ref(q, k, v, causal=causal), 1e-5)


@pytest.mark.parametrize("S,T", [(64, 96), (96, 64)])
def test_attention_ref_top_left_mask_when_lengths_differ(S, T):
    q, k, v = _qkv(1, S, T, 4, 2, 32, seed=3)
    _close(attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v)),
           jax_ref(q, k, v, causal=True), 1e-5)


@pytest.mark.parametrize("B,S,H,KV,D", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_matches_jax_kernel_interpret(B, S, H, KV, D, dtype, causal):
    q, k, v = _qkv(B, S, S, H, KV, D, seed=1)
    dt = getattr(torch, dtype)
    ours = fa_ops.flash_attention(torch.tensor(q).to(dt),
                                  torch.tensor(k).to(dt),
                                  torch.tensor(v).to(dt), causal=causal)
    assert ours.dtype == dt and ours.shape == (B, S, H, D)
    theirs = jax_flash(*(jnp.asarray(a, JNP[dtype]) for a in (q, k, v)),
                       causal=causal, blk_q=64, blk_k=64)
    _close(ours, theirs, TOL[dtype])


def test_both_paths_refuse_autograd():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 128, 128, 2, 1, 16))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match='attn_impl="gather"'):
        fa_ops.flash_attention(q, k, v)
    # the kernel wrapper checks the device first, then the same refusal
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v)     # forward only: allowed


def _count_flash(monkeypatch):
    calls = []
    real = fa_ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("S,path", [(128, "torch-plain-flash:cpu"),
                                    (96, "chunked")])
def test_mode_full_routing(monkeypatch, S, path):
    """attn_impl="cuda" takes the flash path when S (and T) are
    multiples of 128, chunked otherwise; "gather" always chunked."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              attn_impl="cuda", compute_dtype="float32")
    assert transformer.resolved_full_attn_impl(cfg, S, "cpu") == path
    assert transformer.resolved_full_attn_impl(
        dataclasses.replace(cfg, attn_impl="gather"), S, "cpu") == "chunked"
    calls = _count_flash(monkeypatch)
    chunked = []
    real_chunked = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **kw: chunked.append(1) or
                        real_chunked(*a, **kw))
    params = bridge.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, S),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model_zoo.forward(params, cfg, {"tokens": toks})
    flash = path != "chunked"
    assert len(calls) == (cfg.n_layers if flash else 0)
    assert len(chunked) == (0 if flash else cfg.n_layers)


def _jax_forward_and_ours(dtype, S=128):
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", smoke=True),
                               attn_impl="pallas", compute_dtype=dtype)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              attn_impl="cuda", compute_dtype=dtype)
    jparams = jax_zoo.init_params(jcfg, jax.random.PRNGKey(5))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)
    theirs, _ = jax_zoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    params = bridge.from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    with torch.no_grad():
        ours, aux = model_zoo.forward(params, cfg,
                                      {"tokens": torch.tensor(toks)})
    assert aux == {}
    return ours, np.asarray(theirs, np.float32)


def test_forward_on_flash_path_matches_jax_pallas_fp32():
    ours, theirs = _jax_forward_and_ours("float32")
    _close(ours, theirs, 1e-4)
    np.testing.assert_array_equal(ours.argmax(-1).numpy(),
                                  theirs.argmax(-1))


def test_forward_on_flash_path_matches_jax_pallas_bf16():
    ours, theirs = _jax_forward_and_ours("bfloat16")
    _close(ours, theirs, 5e-2)
