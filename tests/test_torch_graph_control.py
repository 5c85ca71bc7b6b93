"""§5.1's gradient of a conditional and of nested loops under the graph
lowering (``core.device_grad``), run through its step-by-step driver
(``device_grad.plain_driver``), which decides each cond on the host and
runs a nested loop step by step, with the same tapes, stacks, predicate
pushes and nested gradient loops that the card replays as IF and WHILE
nodes. Every case compares with ``jax.grad`` (or the forward) of the
same program built from ``repro.core.while_loop``, ``repro.core.cond``
and ``repro.models.rnn`` on the CPU, fp32, inputs from a numpy seed:

- ``test_cond_in_while_grad``'s program (``cond(i % 2 == 0, y * w,
  y + 1)``) under the four graph policies;
- an LSTM body run only where a flag is set (``cond(flags[t] != 0, LSTM
  step, carry through)``), B=4, D=H=8, S=12, rtol 1e-5;
- branches that save different tensors (``tanh(y @ W)`` against
  ``sigmoid(y) * y``), and a cond in a cond;
- ``test_nested_while_grad``'s program, a cond in the inner loop's
  body, an inner loop in a branch and a ``scan`` in the body, the outer
  loop under ``carry`` or ``carry_offload`` (the first under both) and
  the inner loop under each policy, rtol 1e-4 as the host test;
- a two-layer stacked LSTM as an outer graph loop over the layers whose
  body runs ``dynamic_rnn(impl="graph")``: forward within 1e-5 of the
  JAX layer loop, and its gradients under outer ``carry``;
- the refusals: an inner graph loop under grad in an outer
  ``all``/``offload`` body (the error names ``carry``), a branch that
  reaches a tensor computed before the cond.

    python -m pytest tests/test_torch_graph_control.py
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.models import rnn as jrnn
from repro_torch import bridge, core
from repro_torch.core import device_grad
from repro_torch.models import rnn

POLICIES = ["all", "offload", "carry", "carry_offload"]
OUTER = ["carry", "carry_offload"]


@pytest.fixture(autouse=True)
def _fresh_loops():
    device_grad.release()
    yield
    device_grad.release()


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(ours, theirs, rtol, atol=1e-6):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=rtol, atol=atol)


def _i0(m):
    return jnp.int32(0) if m is jcore else torch.zeros((), dtype=torch.long)


def _lib(m):
    return jnp if m is jcore else torch


def _port(fn, xs, policy):
    """Gradients of ``fn(core, *tensors, save_policy=, impl="graph")``
    under the plain driver."""
    ts = [torch.tensor(np.asarray(x, np.float32), requires_grad=True)
          for x in xs]
    with device_grad.plain_driver():
        out = fn(core, *ts, save_policy=policy, impl="graph")
        return torch.autograd.grad(out.sum(), ts)


def _jax(fn, xs, policy):
    return jax.grad(lambda *a: fn(jcore, *a, save_policy=policy).sum(),
                    argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x, jnp.float32) for x in xs])


def _cond(m, pred, t, f, *ops):
    kw = {"backend": "graph"} if m is core else {}
    return m.cond(pred, t, f, *ops, **kw)


def _loop(m, cond_fn, body, init, **kw):
    if m is jcore:
        kw.pop("impl", None)
    return m.while_loop(cond_fn, body, init, **kw)


# ------------------------------------------------------------------ cond

def _even_scale(m, w, x, **kw):
    """``test_cond_in_while_grad``: y * w on even steps, y + 1 on odd."""
    def b(c):
        i, y = c
        return (i + 1, _cond(m, i % 2 == 0, lambda v: v * w,
                             lambda v: v + 1.0, y))
    return _loop(m, lambda c: c[0] < 4, b, (_i0(m), x), max_iters=4,
                 **kw)[1]


W3 = (np.random.default_rng(1).standard_normal((3, 3)) * 0.5).astype(
    np.float32)
FLAGS = np.array([1, 0, 0, 1, 1, 0], np.int32)


def _other_saves(m, w, x, **kw):
    """Branches that save different tensors: tanh(y @ W) where a flag is
    set, sigmoid(y) * y where not."""
    lib = _lib(m)
    flags = lib.asarray(FLAGS)

    def b(c):
        i, y = c
        return (i + 1, _cond(m, flags[i] != 0, lambda v: lib.tanh(v @ w),
                             lambda v: (1 / (1 + lib.exp(-v))) * v, y))
    return _loop(m, lambda c: c[0] < 6, b, (_i0(m), x), max_iters=6,
                 **kw)[1]


def _cond_in_cond(m, w, x, **kw):
    """A cond in a cond: on even steps, y * w where i % 3 == 0 and
    tanh(y) + w elsewhere; y + 1 on odd steps."""
    lib = _lib(m)

    def b(c):
        i, y = c

        def even(v):
            return _cond(m, i % 3 == 0, lambda u: u * w,
                         lambda u: lib.tanh(u) + w, v)
        return (i + 1, _cond(m, i % 2 == 0, even, lambda v: v + 1.0, y))
    return _loop(m, lambda c: c[0] < 7, b, (_i0(m), x), max_iters=8,
                 **kw)[1]


COND_CASES = {
    "even_scale": (_even_scale, (1.5, 2.0)),
    "other_saves": (_other_saves,
                    (W3, np.array([0.3, -0.7, 1.1], np.float32))),
    "cond_in_cond": (_cond_in_cond, (0.8, np.array([0.4, -1.2],
                                                   np.float32))),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(COND_CASES))
def test_cond_in_graph_loop_grads_match_jax(case, policy):
    prog, xs = COND_CASES[case]
    ours = _port(prog, xs, policy)
    theirs = _jax(prog, xs, policy)
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-5)
    loop = core.while_loop.last_grad_loop
    stacks = loop.res.stacks if loop.res is not None else loop.stacks
    assert loop.policy == policy and stacks
    if policy in ("all", "offload"):     # the predicate is pushed
        assert any(st.dtype == torch.int32 and st.shape == ()
                   for st in loop.res.stacks)


# --------------------------------------------------- the flagged LSTM body

B, D, H, S = 4, 8, 8, 12


def _lstm_case(seed):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jrnn.lstm_init(jax.random.PRNGKey(seed),
                                                D, H))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    flags = (rng.random(S) < 0.5).astype(np.int32)
    return p, x, flags


def _flagged(m, p, x, flags, **kw):
    """The LSTM step where ``flags[t]`` is set, the state carried through
    where not; returns the final (c, h)."""
    if m is jcore:
        xs, fl = jnp.swapaxes(x, 0, 1), jnp.asarray(flags)
        cell = jrnn.lstm_cell
    else:
        xs = core.DeviceTensorArray.unstack(x.transpose(0, 1).contiguous())
        fl = core.DeviceTensorArray.unstack(torch.as_tensor(flags))
        cell = rnn.lstm_cell

    def step(c, h, xt):
        _, (c2, h2) = cell(p, xt, (c, h))
        return c2, h2

    def body(s):
        t, c, h = s
        if m is jcore:
            f, xt = fl[t], xs[t]
        else:
            f, xt = fl.read(t), xs.read(t)
        c, h = _cond(m, f != 0, step, lambda c, h, xt: (c, h), c, h, xt)
        return (t + 1, c, h)

    zeros = _lib(m).zeros((B, H), dtype=_lib(m).float32)
    _, c, h = _loop(m, lambda s: s[0] < S, body, (_i0(m), zeros, zeros),
                    max_iters=S, **kw)
    return c, h


def _flagged_loss(m, p, x, flags, **kw):
    c, h = _flagged(m, p, x, flags, **kw)
    return (h ** 2).sum() + (c * h).sum()


@functools.lru_cache(maxsize=None)
def _flagged_jax():
    """``jax.grad`` of the flagged body (the same for every policy)."""
    p, x, flags = _lstm_case(0)
    return jax.grad(lambda p, x: _flagged_loss(jcore, p, x, flags),
                    argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x))


@pytest.mark.parametrize("policy", POLICIES)
def test_flagged_lstm_body_grads_match_jax(policy):
    p, x, flags = _lstm_case(0)
    loss = functools.partial(_flagged_loss, flags=flags)
    jg = _flagged_jax()
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    for t in tp.values():
        t.requires_grad_()
    tx = torch.tensor(x, requires_grad=True)
    with device_grad.plain_driver():
        out = loss(core, tp, tx, save_policy=policy, impl="graph")
        gw, gb, gx = torch.autograd.grad(out, [tp["w"], tp["b"], tx])
    for ours, theirs in ((gw, jg[0]["w"]), (gb, jg[0]["b"]), (gx, jg[1])):
        _close(ours, theirs, 1e-5)
    # the rows of x at unset flags get no gradient
    assert torch.count_nonzero(gx[:, flags == 0]) == 0


# ------------------------------------------------------------ nested loops

def _inner_loop(m, y, body, inner, impl):
    return _loop(m, lambda t: t[0] < 3, body, (_i0(m), y), max_iters=4,
                 save_policy=inner, impl=impl)[1]


def _while_in_while(inner, m, w, x, **kw):
    """``test_nested_while_grad``: y * w three times, then + 1, twice."""
    def ob(s):
        i, y = s
        y2 = _inner_loop(m, y, lambda t: (t[0] + 1, t[1] * w), inner,
                         kw.get("impl"))
        return (i + 1, y2 + 1.0)
    return _loop(m, lambda s: s[0] < 2, ob, (_i0(m), x), max_iters=4,
                 **kw)[1]


def _cond_in_inner(inner, m, w, x, **kw):
    """The inner loop's body a cond: y * w on its even steps, y + 1 on
    its odd ones; then tanh, twice."""
    def ib(t):
        return (t[0] + 1, _cond(m, t[0] % 2 == 0, lambda u: u * w,
                                lambda u: u + 1.0, t[1]))

    def ob(s):
        i, y = s
        return (i + 1, _lib(m).tanh(_inner_loop(m, y, ib, inner,
                                                kw.get("impl"))))
    return _loop(m, lambda s: s[0] < 2, ob, (_i0(m), x), max_iters=4,
                 **kw)[1]


def _while_in_cond(inner, m, w, x, **kw):
    """An inner loop in a branch: on even outer steps y * w three times,
    on odd ones y + 1; four steps."""
    def ob(s):
        i, y = s
        return (i + 1, _cond(
            m, i % 2 == 0,
            lambda v: _inner_loop(m, v, lambda t: (t[0] + 1, t[1] * w),
                                  inner, kw.get("impl")),
            lambda v: v + 1.0, y))
    return _loop(m, lambda s: s[0] < 4, ob, (_i0(m), x), max_iters=4,
                 **kw)[1]


E5 = np.linspace(-0.5, 0.5, 5, dtype=np.float32)


def _scan_in_while(inner, m, w, x, **kw):
    """Fig. 2's ``scan`` in the body: tanh(c * w + e_k) over five
    elements, its last carry, twice."""
    lib = _lib(m)
    impl = {} if m is jcore else {"impl": kw.get("impl")}

    def ob(s):
        i, y = s
        ys = m.scan(lambda c, v: lib.tanh(c * w + v), lib.asarray(E5), y,
                    save_policy=inner, **impl)
        return (i + 1, ys[-1])
    return _loop(m, lambda s: s[0] < 2, ob, (_i0(m), x), max_iters=4,
                 **kw)[1]


NESTED = {"while_in_while": _while_in_while,
          "cond_in_inner": _cond_in_inner,
          "while_in_cond": _while_in_cond,
          "scan_in_while": _scan_in_while}


@pytest.mark.parametrize("inner", POLICIES)
@pytest.mark.parametrize("program, outer", [
    ("while_in_while", "carry"), ("while_in_while", "carry_offload"),
    ("cond_in_inner", "carry"), ("while_in_cond", "carry_offload"),
    ("scan_in_while", "carry")])
def test_nested_graph_loops_grads_match_jax(program, outer, inner):
    prog = (lambda m, *a, **kw:                          # noqa: E731
            NESTED[program](inner, m, *a, **kw))
    xs = (0.5, 0.3)
    ours = _port(prog, xs, outer)
    theirs = _jax(prog, xs, outer)
    for a, b in zip(ours, theirs):
        _close(a, b, 1e-4)
    outer_loop = core.while_loop.last_grad_loop
    (plan,) = outer_loop._inner.values()
    assert plan.nested and plan.policy == inner


L = 2


def _stacked_case(seed):
    rng = np.random.default_rng(seed)
    ps = jax.tree.map(np.asarray, jrnn.multilayer_lstm_params(
        jax.random.PRNGKey(seed), L, D, H))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return ps, x


def _stacked(w, b, x, outer="all", inner="all"):
    """An outer graph loop over the layers, weights (L, D+H, 4H) read at
    its counter, its body one ``dynamic_rnn(impl="graph")``."""
    def body(s):
        l, y = s
        p = {"w": w.index_select(0, l.reshape(1))[0],
             "b": b.index_select(0, l.reshape(1))[0]}
        out, _ = rnn.dynamic_rnn(p, y, hidden=H, save_policy=inner,
                                 impl="graph")
        return (l + 1, out)
    return core.while_loop(lambda s: s[0] < L, body,
                           (torch.zeros((), dtype=torch.long), x),
                           max_iters=L, save_policy=outer, impl="graph")[1]


def _stacked_tensors(ps, x):
    return (torch.tensor(np.stack([p["w"] for p in ps]), requires_grad=True),
            torch.tensor(np.stack([p["b"] for p in ps]), requires_grad=True),
            torch.tensor(x, requires_grad=True))


@functools.lru_cache(maxsize=None)
def _stacked_jax():
    """The JAX layer loop's forward and ``jax.grad`` (per layer)."""
    ps, x = _stacked_case(2)
    jps, jx = jax.tree.map(jnp.asarray, ps), jnp.asarray(x)

    def jloss(ps, x):
        return (jrnn.multilayer_dynamic_rnn(ps, x, hidden=H) ** 2).sum()

    return (jrnn.multilayer_dynamic_rnn(jps, jx, hidden=H),
            jax.grad(jloss, argnums=(0, 1))(jps, jx))


@pytest.mark.parametrize("inner", [None] + POLICIES)
def test_nested_stacked_lstm_matches_the_jax_layer_loop(inner):
    """``inner`` None: the forward alone (no grad); else the gradients
    with the outer loop under ``carry`` and the layers' loops under
    ``inner``."""
    ps, x = _stacked_case(2)
    jy, (jgp, jgx) = _stacked_jax()
    w, b, tx = _stacked_tensors(ps, x)
    with device_grad.plain_driver():
        if inner is None:
            with torch.no_grad():
                y = _stacked(w, b, tx)
            _close(y, jy, 1e-5, 1e-6)
            return
        y = _stacked(w, b, tx, outer="carry", inner=inner)
        gw, gb, gx = torch.autograd.grad((y ** 2).sum(), [w, b, tx])
    _close(gw, np.stack([g["w"] for g in jgp]), 1e-4)
    _close(gb, np.stack([g["b"] for g in jgp]), 1e-4)
    _close(gx, jgx, 1e-4)


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("outer", ["all", "offload"])
def test_inner_graph_loop_in_a_recorded_body_is_refused(outer):
    with pytest.raises(NotImplementedError, match="'carry'"):
        _port(lambda m, *a, **kw: _while_in_while("carry", m, *a, **kw),
              (0.5, 0.3), outer)


def test_branch_reaching_a_tensor_made_before_the_cond_is_refused():
    w = torch.tensor(0.7, requires_grad=True)

    def body(s):
        i, y = s
        a = y * w                              # not an operand
        return (i + 1, core.cond(i % 2 == 0, lambda v: v + a,
                                 lambda v: v * 2.0, y, backend="graph"))

    init = (torch.zeros((), dtype=torch.long), torch.tensor(0.3))
    with device_grad.plain_driver(), pytest.raises(
            ValueError, match="computed before the loop|reaches"):
        core.while_loop(lambda s: s[0] < 3, body, init, max_iters=3,
                        save_policy="carry", impl="graph")


def test_nested_loop_refuses_a_python_counter():
    """A nested graph loop's carry holds tensors, as on the card."""
    def body(s):
        i, y = s
        _, y2 = core.while_loop(lambda t: t[0] < 3,
                                lambda t: (t[0] + 1, t[1] * 0.5), (0, y),
                                max_iters=4, impl="graph")
        return (i + 1, y2)

    init = (torch.zeros((), dtype=torch.long), torch.tensor(0.3))
    with device_grad.plain_driver(), torch.no_grad(), pytest.raises(
            TypeError, match="Python number"):
        core.while_loop(lambda s: s[0] < 2, body, init, max_iters=2,
                        impl="graph")


def test_a_prologue_runs_without_grad_and_is_refused_under_grad():
    def restart(s):
        s[0].zero_()

    def loop(x):
        init = (torch.full((), 7, dtype=torch.long), x)
        return core.while_loop(lambda s: s[0] < 3,
                               lambda s: (s[0] + 1, s[1] * 2.0), init,
                               max_iters=4, impl="graph",
                               prologue=restart)[1]

    x = torch.tensor(0.5, requires_grad=True)
    with device_grad.plain_driver():
        with torch.no_grad():
            assert float(loop(x)) == 4.0
        with pytest.raises(NotImplementedError, match="prologue"):
            loop(x)
