"""Reference executor: cond/while compiled to the five primitives (§4.2).

This module performs, eagerly and observably, the graph construction the
paper describes — one ``Switch`` per captured input of a conditional
branch, one ``Merge`` per output, and the
``Enter → Merge → [Gpred → Switch → Gbody → NextIteration]* → Exit``
cycle of Fig. 4 for while-loops — over ``TaggedValue``s obeying the
Fig. 5 evaluation rules, including deadness propagation through untaken
branches.

It is the *semantic oracle*: the tests assert that the production
lowerings (``core.cond`` / ``core.while_loop``) agree with it on
randomized programs (hypothesis).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from .frames import TaggedValue
from .primitives import apply_op, enter, exit_, merge, next_iteration, switch


def dataflow_cond(pred, true_fn: Callable, false_fn: Callable,
                  *operands) -> Any:
    """§4.2: cond via Switch (one per captured input) + Merge (per output)."""
    p = TaggedValue(torch.as_tensor(pred))
    ops = [TaggedValue(torch.as_tensor(o)) for o in operands]
    # One Switch per external tensor "to maximize parallelism" (§4.2).
    switched = [switch(o, p) for o in ops]  # [(false_port, true_port)]
    t_in = [s[1] for s in switched]
    f_in = [s[0] for s in switched]
    # Branch subgraphs execute under deadness propagation: if the branch
    # is untaken, apply_op skips the computation entirely (Fig. 5).
    if t_in:
        t_out = apply_op(lambda *xs: true_fn(*xs), *t_in)
        f_out = apply_op(lambda *xs: false_fn(*xs), *f_in)
    else:  # zero-operand cond still needs the predicate's frame
        t_out = apply_op(lambda _: true_fn(), p) if not p.is_dead else p.dead()
        f_out = apply_op(lambda _: false_fn(), p) if not p.is_dead else p.dead()
        t_out = t_out if bool(p.value) else t_out.dead()
        f_out = f_out.dead() if bool(p.value) else f_out
    # One Merge per output enables downstream work "as soon as possible".
    out = merge(t_out, f_out)
    if out.is_dead:
        raise RuntimeError("both cond branches dead — dead predicate?")
    return out.value


def dataflow_while(cond_fn: Callable, body_fn: Callable,
                   inits: Sequence, name: str = "while") -> Tuple:
    """Fig. 4 graph for a while-loop, executed eagerly.

    Per the paper: a separate set of Enter/Merge/Switch/NextIteration/
    Exit nodes per loop variable (so iterations could run in parallel);
    the predicate subgraph reads the Merge outputs; Switch routes either
    to Exit (false) or to the body and NextIteration (true).
    """
    inits = [TaggedValue(torch.as_tensor(x)) for x in inits]
    # Enter: one per loop variable, all into the same child frame.
    loop_vars = [enter(v, name) for v in inits]

    while True:
        # Gpred on the merged loop variables.
        p = apply_op(lambda *xs: torch.as_tensor(cond_fn(*xs)), *loop_vars)
        # One Switch per loop variable.
        switched = [switch(v, p) for v in loop_vars]
        exits = [exit_(f_port) for f_port, _ in switched]
        body_in = [t_port for _, t_port in switched]
        # Gbody under deadness: if p was false, body inputs are dead and
        # apply_op propagates deadness without computing (Fig. 5).
        body_out = apply_op(lambda *xs: tuple(body_fn(*xs)), *body_in)
        if not p.is_dead and not bool(p.value):
            # Loop terminated: Exit values are live; return them.
            if any(e.is_dead for e in exits):
                raise RuntimeError("dead Exit value at loop termination")
            return tuple(e.value for e in exits)
        # NextIteration: forward body outputs to iteration n+1.
        nexts = [next_iteration(body_out.with_value(body_out.value[i]))
                 for i in range(len(loop_vars))]
        # Merge(Enter, NextIteration): in the dataflow graph the same
        # Merge node receives both; operationally the alive one wins.
        loop_vars = [merge(nx, e0) for nx, e0 in zip(nexts, inits)]
        if any(v.is_dead for v in loop_vars):
            raise RuntimeError("dead loop variable escaped termination")
