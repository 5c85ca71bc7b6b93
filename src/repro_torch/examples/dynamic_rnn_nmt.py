"""NMT-style encoder-decoder LSTM on variable-length sequences, the
paper's flagship ``dynamic_rnn`` application (§2.2), as the JAX
package's ``examples/dynamic_rnn_nmt.py``: encoder and decoder are
``core.while_loop``s over TensorArrays, per-example lengths freeze the
state past each sentence's end, and the loss is differentiated end to
end through both loops, trained here on a toy rot-7 "translation".

    PYTHONPATH=src python -m repro_torch.examples.dynamic_rnn_nmt
    PYTHONPATH=src python -m repro_torch.examples.dynamic_rnn_nmt --device cpu

It runs on the card unless ``--device cpu`` is given, and checks the
reference's bar: masked NLL below 0.5 after 250 steps.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from .. import resolve_device
from ..models import rnn
from ..optim import adamw

VOCAB, EMB, HID, MAXLEN = 32, 24, 48, 12
BATCH, STEPS, LR = 32, 250, 5e-3
LOSS_BAR = 0.5


def init(gen: torch.Generator) -> Dict:
    dev = gen.device
    return {
        "embed": torch.randn(VOCAB, EMB, generator=gen, device=dev) * 0.3,
        "enc": rnn.lstm_init(gen, EMB, HID),
        "dec": rnn.lstm_init(gen, EMB + HID, HID),
        "out": torch.randn(HID, VOCAB, generator=gen, device=dev) * 0.3,
    }


def model_loss(params, src, src_len, tgt, save_policy: str = "all"):
    """Alignment-known toy translation: tgt[i] = rot(src[i]).

    The decoder consumes the source embedding stream plus the encoder's
    final state; both RNNs are ``dynamic_rnn``s with per-example
    lengths, differentiated end to end."""
    emb = params["embed"][src]                          # (B, S, E)
    _, (c, h) = rnn.dynamic_rnn(params["enc"], emb, src_len, hidden=HID,
                                save_policy=save_policy)
    dec_in = torch.cat([emb, h[:, None].expand(-1, tgt.shape[1], -1)],
                       dim=-1)
    outs, _ = rnn.dynamic_rnn(params["dec"], dec_in, src_len, hidden=HID,
                              save_policy=save_policy)
    logp = torch.log_softmax(outs @ params["out"], dim=-1)
    mask = (torch.arange(tgt.shape[1], device=tgt.device)[None]
            < src_len[:, None]).to(logp.dtype)
    nll = -logp.gather(-1, tgt[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum()


def batch(gen: torch.Generator):
    dev = gen.device
    lens = torch.randint(3, MAXLEN + 1, (BATCH,), generator=gen, device=dev)
    toks = torch.randint(1, VOCAB, (BATCH, MAXLEN), generator=gen,
                         device=dev)
    mask = torch.arange(MAXLEN, device=dev)[None] < lens[:, None]
    src = torch.where(mask, toks, 0)
    tgt = torch.where(mask, (toks + 7) % VOCAB, 0)     # rot-7
    return src, lens, tgt


def train_step(cfg: adamw.AdamWConfig, params, opt, src, lens, tgt,
               save_policy: str = "all"):
    """One step: loss and gradients through both loops, then AdamW.
    Returns (params, opt, loss)."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = model_loss(pytree.tree_unflatten(leaves, spec), src, lens, tgt,
                      save_policy)
    grads = torch.autograd.grad(loss, leaves)
    params, opt, _ = adamw.apply(cfg, pytree.tree_unflatten(
        [p.detach() for p in leaves], spec),
        pytree.tree_unflatten(list(grads), spec), opt)
    return params, opt, loss.detach()


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init(gen)
    cfg = adamw.AdamWConfig(lr=LR, weight_decay=0.0)
    opt = adamw.init(params)
    loss = None
    for i in range(args.steps):
        src, lens, tgt = batch(gen)
        params, opt, loss = train_step(cfg, params, opt, src, lens, tgt)
        if i % 50 == 0:
            print(f"step {i:4d}  masked-NLL {float(loss):.4f}")
    final = float(loss)
    print(f"final loss {final:.4f} after {args.steps} steps on {device} "
          "- variable-length NMT loop trained through core.while_loop")
    if args.steps >= STEPS and not final < LOSS_BAR:
        raise RuntimeError(f"toy translation should be mostly learned: "
                           f"loss {final:.4f} >= {LOSS_BAR}")
    return final


if __name__ == "__main__":
    main()
