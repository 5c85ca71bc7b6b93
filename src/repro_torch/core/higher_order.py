"""Higher-order functionals defined via ``while_loop`` + ``TensorArray``.

The paper (§2.1, Fig. 2) keeps the primitive set small: ``map_fn``,
``foldl``, ``foldr`` and ``scan`` are *defined in terms of*
``while_loop`` and TensorArrays, and so inherit its reverse-mode AD and
save policies. ``backend="paper"`` reproduces that construction (the
unstack → loop → stack pattern of Fig. 2) on the port's ``while_loop``;
``backend="native"`` is a plain Python loop with the same results,
which the tests hold the paper construction against.

``impl`` is the loop's lowering. Under ``"host"`` (the default) the
loop counter is a Python int: the bound is the static leading
dimension, so no predicate is read from the device, and the result
arrays take their shapes from the first write. Under ``"graph"`` (CUDA
tensors, or the CPU under ``device_grad.plain_driver()``) the counter
is a 0-d device tensor, ``reverse``'s index is computed on the device,
the element and result arrays are ``DeviceTensorArray``s, and the
result arrays are made before the loop, their shapes from one call of
``fn`` on element 0 under ``torch.no_grad()`` (the JAX package's
``eval_shape``). The initial carry is copied, so the loop never writes
the caller's tensors. Every save policy runs under grad in both.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from .tensor_array import DeviceTensorArray, TensorArray
from .while_loop import while_loop


def _leading_dim(xs) -> int:
    sizes = {l.shape[0] for l in pytree.tree_leaves(xs)}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent leading dims: {sizes}")
    return sizes.pop()


def _is_ta(x) -> bool:
    return isinstance(x, (TensorArray, DeviceTensorArray))


def _ta_map(fn, *trees):
    """tree_map over pytrees whose leaves are TensorArrays."""
    return pytree.tree_map(fn, *trees, is_leaf=_is_ta)


def _slice(xs, i: int):
    return pytree.tree_map(lambda l: l[i], xs)


def _stack(ys: list):
    return pytree.tree_map(lambda *ls: torch.stack(ls), *ys)


def _start(elems, init, impl: str):
    """The element arrays, the counter and the initial carry of a
    ``"paper"`` loop under ``impl``."""
    if impl == "host":
        return pytree.tree_map(TensorArray.unstack, elems), 0, init
    if impl != "graph":
        raise ValueError(f"unknown impl {impl!r}")
    dev = pytree.tree_leaves(elems)[0].device
    return (pytree.tree_map(DeviceTensorArray.unstack, elems),
            torch.zeros((), dtype=torch.long, device=dev),
            pytree.tree_map(torch.clone, init))


def scan(fn: Callable, elems: Any, init: Any, *,
         reverse: bool = False, backend: str = "paper",
         save_policy: str = "all", parallel_iterations: int = 1,
         impl: str = "host") -> Any:
    """Generalized prefix-sum (paper Fig. 2).

    ``fn(carry, x) -> carry``; returns the stacked per-step carries
    (``fn(init, e0), fn(fn(init, e0), e1), ...``; with ``reverse`` the
    walk starts at the last element and result i belongs to element i).
    ``impl``: the loop's lowering (see the module docstring).
    """
    n = _leading_dim(elems)
    if backend == "native":
        ys = [None] * n
        c = init
        for i in (range(n - 1, -1, -1) if reverse else range(n)):
            c = fn(c, _slice(elems, i))
            ys[i] = c
        return _stack(ys)
    return _scan(fn, elems, init, n, reverse, save_policy,
                 parallel_iterations, impl)


def _scan(fn, elems, init, n, reverse, save_policy, parallel_iterations,
          impl, like=None):
    # Fig. 2: unstack elems into TensorArrays, loop with (i, acc,
    # result_ta), stack the results
    elem_ta, i0, init = _start(elems, init, impl)
    result_ta = None        # the host lowering's: made by the first write
    if impl == "graph":
        if like is None:
            with torch.no_grad():
                like = fn(init, _slice(elems, 0))
        result_ta = pytree.tree_map(
            lambda v: DeviceTensorArray.create(n, v.shape, v.dtype,
                                               v.device), like)

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

    _, _, r = while_loop(lambda s: s[0] < n, body, (i0, init, result_ta),
                         max_iters=n, save_policy=save_policy,
                         parallel_iterations=parallel_iterations,
                         name="scan", impl=impl)
    return _ta_map(lambda t: t.stack(), r)


def map_fn(fn: Callable, elems: Any, *, backend: str = "paper",
           save_policy: str = "all", impl: str = "host") -> Any:
    """Apply ``fn`` to every leading-dim slice (paper §2.1): a scan whose
    carry is the per-element output (under ``impl="graph"`` it starts
    as zeros shaped like ``fn`` of element 0, as in the JAX package)."""
    step = lambda _, x: fn(x)              # noqa: E731
    if backend == "native" or impl == "host":
        return scan(step, elems, None, backend=backend,
                    save_policy=save_policy, impl=impl)
    with torch.no_grad():
        like = fn(_slice(elems, 0))
    return _scan(step, elems, pytree.tree_map(torch.zeros_like, like),
                 _leading_dim(elems), False, save_policy, 1, impl, like)


def foldl(fn: Callable, elems: Any, init: Any, *, backend: str = "paper",
          save_policy: str = "all", impl: str = "host") -> Any:
    """Left fold; returns only the final accumulator."""
    return _fold(fn, elems, init, backend, save_policy, False, impl)


def foldr(fn: Callable, elems: Any, init: Any, *, backend: str = "paper",
          save_policy: str = "all", impl: str = "host") -> Any:
    """Right fold; returns only the final accumulator."""
    return _fold(fn, elems, init, backend, save_policy, True, impl)


def _fold(fn, elems, init, backend, save_policy, right, impl):
    n = _leading_dim(elems)
    if backend == "native":
        a = init
        for i in range(n):
            a = fn(a, _slice(elems, n - 1 - i if right else i))
        return a

    elem_ta, i0, init = _start(elems, init, impl)

    def body(state):
        i, a = state
        ix = (n - 1 - i) if right else i
        x = _ta_map(lambda t: t.read(ix), elem_ta)
        return (i + 1, fn(a, x))

    _, out = while_loop(lambda s: s[0] < n, body, (i0, init), max_iters=n,
                        save_policy=save_policy,
                        name="foldr" if right else "foldl", impl=impl)
    return out
