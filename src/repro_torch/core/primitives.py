"""The five control-flow primitives (paper §4.1) over tagged values.

These implement the evaluation rules of Fig. 5 *exactly*, as an eager
reference semantics over tensors. The production path runs the same
high-level constructs as eager loops and branches
(`repro_torch.core.while_loop` / `repro_torch.core.cond`); the test
suite asserts the two agree.

Rules reproduced (Fig. 5):

    Eval(Switch(p, d), c)        = (r1, r2)
        r1 = (value(d),  p || is_dead(d), tag(d))     # false output
        r2 = (value(d), !p || is_dead(d), tag(d))     # true output
    Eval(Merge(d1, d2), c)       = if is_dead(d1) then d2 else d1
    Eval(Enter(d, name), c)      = (value(d), is_dead(d), tag(d)/name/0)
    Eval(Exit(d), c)             = (value(d), is_dead(d), c.parent.tag)
    Eval(NextIteration(d), c)    = (value(d), is_dead(d), tag1/name/(n+1))
    Eval(Op(d1..dm), c)          = value = Op(values) if all alive;
                                   is_dead = OR(is_dead(di)); tag = tag(d1)
"""

from __future__ import annotations

from typing import Callable, Tuple

from .frames import (
    TaggedValue,
    enter_tag,
    exit_tag,
    next_iteration_tag,
    same_frame,
)


class DeadnessError(RuntimeError):
    """Raised when the payload of a dead value would be observed."""


def switch(d: TaggedValue, p: TaggedValue) -> Tuple[TaggedValue, TaggedValue]:
    """Forward `d` to the (false, true) output per predicate `p`.

    Fig. 3/5: output 1 is the *false* port (dead when p is true), output 2
    is the *true* port (dead when p is false). A dead predicate kills both.
    """
    if not same_frame(d, p):
        raise DeadnessError(
            f"Switch inputs in different frames: {d.tag} vs {p.tag}")
    p_dead = p.is_dead
    pv = bool(p.value) if not p_dead else False
    d_false = TaggedValue(d.value, pv or d.is_dead or p_dead, d.tag)
    d_true = TaggedValue(d.value, (not pv) or d.is_dead or p_dead, d.tag)
    return d_false, d_true


def merge(d1: TaggedValue, d2: TaggedValue) -> TaggedValue:
    """Forward whichever input is alive (Fig. 5).

    Merge is the only primitive enabled by *any* input (§4.1). With both
    inputs present, the rule is `if is_dead(d1) then d2 else d1`; the
    result is dead only if both are dead.
    """
    return d2 if d1.is_dead else d1


def enter(d: TaggedValue, name: str) -> TaggedValue:
    """Make `d` available inside child frame `name`, iteration 0."""
    return TaggedValue(d.value, d.is_dead, enter_tag(d.tag, name))


def exit_(d: TaggedValue) -> TaggedValue:
    """Forward `d` to the parent frame."""
    return TaggedValue(d.value, d.is_dead, exit_tag(d.tag))


def next_iteration(d: TaggedValue) -> TaggedValue:
    """Forward `d` to the next iteration of its frame."""
    return TaggedValue(d.value, d.is_dead, next_iteration_tag(d.tag))


def apply_op(fn: Callable, *args: TaggedValue) -> TaggedValue:
    """Fig. 5 last rule: ordinary ops propagate deadness, skip compute.

    The actual computation is performed only when no input is dead; with
    a dead input we skip `fn` entirely and emit a dead value carrying the
    first input's payload (shape placeholder) — this is the deadness
    propagation that makes distributed untaken branches cheap (§4.4).
    """
    if not args:
        raise ValueError("apply_op needs at least one input")
    if not same_frame(*args):
        raise DeadnessError(
            f"Op inputs in different frames: {[a.tag for a in args]}")
    any_dead = any(a.is_dead for a in args)
    if any_dead:
        return TaggedValue(args[0].value, True, args[0].tag)
    out = fn(*[a.value for a in args])
    return TaggedValue(out, False, args[0].tag)
