"""Higher-order functionals defined via ``while_loop`` + ``TensorArray``.

The paper (§2.1, Fig. 2) keeps the primitive set small: ``map_fn``,
``foldl``, ``foldr`` and ``scan`` are *defined in terms of*
``while_loop`` and TensorArrays, and so inherit its reverse-mode AD and
save policies. ``backend="paper"`` reproduces that construction (the
unstack → loop → stack pattern of Fig. 2) on the port's ``while_loop``;
``backend="native"`` is a plain Python loop with the same results,
which the tests hold the paper construction against.

Loop counters are Python ints: the loop bound is the static leading
dimension, so no predicate is read from the device.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from .tensor_array import TensorArray
from .while_loop import while_loop


def _leading_dim(xs) -> int:
    sizes = {l.shape[0] for l in pytree.tree_leaves(xs)}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent leading dims: {sizes}")
    return sizes.pop()


def _is_ta(x) -> bool:
    return isinstance(x, TensorArray)


def _ta_map(fn, *trees):
    """tree_map over pytrees whose leaves are TensorArrays."""
    return pytree.tree_map(fn, *trees, is_leaf=_is_ta)


def _slice(xs, i: int):
    return pytree.tree_map(lambda l: l[i], xs)


def _stack(ys: list):
    return pytree.tree_map(lambda *ls: torch.stack(ls), *ys)


def scan(fn: Callable, elems: Any, init: Any, *,
         reverse: bool = False, backend: str = "paper",
         save_policy: str = "all", parallel_iterations: int = 1) -> Any:
    """Generalized prefix-sum (paper Fig. 2).

    ``fn(carry, x) -> carry``; returns the stacked per-step carries
    (``fn(init, e0), fn(fn(init, e0), e1), ...``; with ``reverse`` the
    walk starts at the last element and result i belongs to element i).
    """
    n = _leading_dim(elems)
    if backend == "native":
        ys = [None] * n
        c = init
        for i in (range(n - 1, -1, -1) if reverse else range(n)):
            c = fn(c, _slice(elems, i))
            ys[i] = c
        return _stack(ys)

    # Fig. 2: unstack elems into TensorArrays, loop with (i, acc,
    # result_ta), stack the results. The result arrays take their shapes
    # and dtypes from the first write.
    elem_ta = pytree.tree_map(TensorArray.unstack, elems)

    def body(state):
        i, a, ta = state
        ix = (n - 1 - i) if reverse else i
        a_out = fn(a, _ta_map(lambda t: t.read(ix), elem_ta))
        if ta is None:
            ta = pytree.tree_map(
                lambda v: TensorArray.create(n, v.shape, v.dtype, v.device),
                a_out)
        ta = _ta_map(lambda t, v: t.write(ix, v), ta, a_out)
        return (i + 1, a_out, ta)

    _, _, r = while_loop(lambda s: s[0] < n, body, (0, init, None),
                         max_iters=n, save_policy=save_policy,
                         parallel_iterations=parallel_iterations,
                         name="scan")
    return _ta_map(lambda t: t.stack(), r)


def map_fn(fn: Callable, elems: Any, *, backend: str = "paper",
           save_policy: str = "all") -> Any:
    """Apply ``fn`` to every leading-dim slice (paper §2.1): a scan whose
    carry is the per-element output."""
    return scan(lambda _, x: fn(x), elems, None, backend=backend,
                save_policy=save_policy)


def foldl(fn: Callable, elems: Any, init: Any, *, backend: str = "paper",
          save_policy: str = "all") -> Any:
    """Left fold; returns only the final accumulator."""
    return _fold(fn, elems, init, backend, save_policy, right=False)


def foldr(fn: Callable, elems: Any, init: Any, *, backend: str = "paper",
          save_policy: str = "all") -> Any:
    """Right fold; returns only the final accumulator."""
    return _fold(fn, elems, init, backend, save_policy, right=True)


def _fold(fn, elems, init, backend, save_policy, right):
    n = _leading_dim(elems)
    order = (lambda i: n - 1 - i) if right else (lambda i: i)
    if backend == "native":
        a = init
        for i in range(n):
            a = fn(a, _slice(elems, order(i)))
        return a

    elem_ta = pytree.tree_map(TensorArray.unstack, elems)

    def body(state):
        i, a = state
        x = _ta_map(lambda t: t.read(order(i)), elem_ta)
        return (i + 1, fn(a, x))

    _, out = while_loop(lambda s: s[0] < n, body, (0, init), max_iters=n,
                        save_policy=save_policy,
                        name="foldr" if right else "foldl")
    return out
