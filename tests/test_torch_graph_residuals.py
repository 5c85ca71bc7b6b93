"""§5.1's residual stacks under the graph lowering: ``save_policy``
"all" and "offload" of ``while_loop(impl="graph")`` under grad
(``core.device_grad`` with ``core.stacks.ResidualStacks``), run through
the step-by-step driver (``device_grad.plain_driver``): the forward body
records under the residual hooks, the gradient loop differentiates the
recorded template from the popped residuals and never calls
``body_fn``.

- ``dynamic_rnn`` and ``multilayer_dynamic_rnn`` gradients, with and
  without lengths, against ``jax.grad`` of the JAX package's (rtol 1e-4,
  atol 1e-6) and the port's host lowering (rtol 1e-6, atol 1e-7);
- ``while_loop`` programs of ``test_torch_core.py`` (grad against
  unrolled, the summed constant gradient, the data-dependent trip
  count, the matrix carry) against ``repro.core.while_loop``;
- ``scan`` (and reverse), ``foldl``, ``foldr`` and ``map_fn`` with
  ``impl="graph"`` under all four policies against
  ``repro.core.higher_order`` (``backend="paper"``) and the host
  lowering;
- what is pushed: no call of ``body_fn`` in the gradient pass, no stack
  for a constant, ``residual_bytes`` and ``host_bytes`` against the
  distinct saved tensors, array indices popped per iteration, and the
  refusals (state kept on ``ctx``, a body whose iterations record
  differently, a host loop nested in a recorded body).
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

RESIDUAL = ["all", "offload"]
POLICIES = ["all", "offload", "carry", "carry_offload"]
B, S, D, H = 3, 9, 4, 8
LENS = np.array([4, 9, 6], np.int32)
RNG = np.random.default_rng(0)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(ours, theirs, rtol, atol):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=rtol,
                               atol=atol)


@pytest.fixture(autouse=True)
def _fresh_loops():
    device_grad.release()
    yield
    device_grad.release()


# ------------------------------------------------------------ dynamic_rnn

def _case(seed=0, layers=None):
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    p = (jrnn.lstm_init(key, D, H) if layers is None else
         jrnn.multilayer_lstm_params(key, layers, D, H))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return jax.tree.map(np.asarray, p), x


def _port_grads(p, x, lens, policy, impl, cell=rnn.lstm_cell):
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    for t in tp.values():
        t.requires_grad_()
    tx = torch.tensor(x, requires_grad=True)
    tl = None if lens is None else torch.tensor(lens)
    out, (c, h) = rnn.dynamic_rnn(tp, tx, tl, hidden=H, save_policy=policy,
                                  impl=impl, cell=cell)
    loss = (out ** 2).mean() + (c * h).sum()
    return (loss, out) + torch.autograd.grad(loss, [tp["w"], tp["b"], tx])


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("policy", RESIDUAL)
def test_dynamic_rnn_grads_match_jax(policy, with_lens):
    p, x = _case()
    lens = LENS if with_lens else None

    def jloss(p, x):
        out, (c, h) = jrnn.dynamic_rnn(
            p, x, None if lens is None else jnp.asarray(lens), hidden=H,
            save_policy=policy)
        return (out ** 2).mean() + (c * h).sum()

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    with device_grad.plain_driver():
        loss, _, gw, gb, gx = _port_grads(p, x, lens, policy, "graph")
    assert core.while_loop.last_grad_loop.residual_bytes > 0
    _close(loss, jl, 1e-5, 1e-6)
    for ours, theirs in ((gw, jgp["w"]), (gb, jgp["b"]), (gx, jgx)):
        _close(ours, theirs, 1e-4, 1e-6)


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("policy", RESIDUAL)
def test_dynamic_rnn_grads_match_the_host_lowering(policy, with_lens):
    p, x = _case(1)
    lens = LENS if with_lens else None
    ref = _port_grads(p, x, lens, policy, "host")
    with device_grad.plain_driver():
        ours = _port_grads(p, x, lens, policy, "graph")
    for a, b in zip(ours, ref):
        _close(a, b, 1e-6, 1e-7)
    if with_lens:
        assert torch.count_nonzero(ours[1][0, LENS[0]:]) == 0


@pytest.mark.parametrize("policy", RESIDUAL)
def test_multilayer_grads_match_jax_and_the_host_lowering(policy):
    p, x = _case(2, layers=2)

    def port(impl):
        tp = bridge.lstm_params_from_numpy(p, "cpu")
        leaves = [q[k].requires_grad_() for q in tp for k in ("w", "b")]
        tx = torch.tensor(x, requires_grad=True)
        y = rnn.multilayer_dynamic_rnn(tp, tx, hidden=H, save_policy=policy,
                                       impl=impl)
        return torch.autograd.grad((y ** 2).sum(), leaves + [tx])

    def jloss(p, x):
        y = jrnn.multilayer_dynamic_rnn(p, x, hidden=H, save_policy=policy)
        return (y ** 2).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    theirs = [g for q in jgp for g in (q["w"], q["b"])] + [jgx]
    ref = port("host")
    with device_grad.plain_driver():
        ours = port("graph")
    assert [len(v) for v in device_grad._CACHE.values()] == [1, 1]
    for a, b, c in zip(ours, ref, theirs):
        _close(a, b, 1e-6, 1e-7)
        _close(a, c, 1e-4, 1e-6)


# ------------------------------------------------------------- while_loop

def _i0(m):
    return jnp.int32(0) if m is jcore else torch.zeros((), dtype=torch.long)


def _lib(m):
    return jnp if m is jcore else torch


def _tanh_loop(m, w, x, **kw):
    _, y = m.while_loop(lambda c: c[0] < 6,
                        lambda c: (c[0] + 1, _lib(m).tanh(c[1] * w)),
                        (_i0(m), x), max_iters=8, **kw)
    return y ** 2


def _tanh_unrolled(w, x):
    y = x
    for _ in range(6):
        y = torch.tanh(y * w)
    return y ** 2


def _constant_loop(m, w, **kw):
    z = jnp.float32(0.0) if m is jcore else torch.zeros(())
    _, y = m.while_loop(lambda c: c[0] < 5, lambda c: (c[0] + 1, c[1] + w),
                        (_i0(m), z), max_iters=8, **kw)
    return y


def _doubling_loop(n, m, x, **kw):
    _, y = m.while_loop(lambda c: c[0] < n, lambda c: (c[0] + 1, c[1] * 2.0),
                        (_i0(m), x), max_iters=16, **kw)
    return y


def _matrix_loop(m, w, x, **kw):
    _, a = m.while_loop(lambda c: c[0] < 3, lambda c: (c[0] + 1, c[1] @ w),
                        (_i0(m), x), max_iters=3, **kw)
    return a


W10 = (RNG.standard_normal((10, 10)) * 0.1).astype(np.float32)
X10 = RNG.standard_normal((10, 10)).astype(np.float32)
WHILE_CASES = {
    # name: (program, inputs, the gradients it must give or None)
    "grad_vs_unrolled": (_tanh_loop, (1.3, 0.7), "unrolled"),
    "constant_summed": (_constant_loop, (2.0,), [5.0]),
    **{f"trip_count_{n}": (functools.partial(_doubling_loop, n), (1.0,),
                           [2.0 ** n]) for n in (0, 1, 3, 16)},
    "matrix_carry": (_matrix_loop, (W10, X10), None),
}


def _grads(fn, xs):
    ts = [torch.tensor(np.asarray(x, np.float32), requires_grad=True)
          for x in xs]
    return torch.autograd.grad(fn(*ts).sum(), ts)


@pytest.mark.parametrize("case", list(WHILE_CASES))
@pytest.mark.parametrize("policy", RESIDUAL)
def test_while_loop_grads_match_jax_and_the_host_lowering(policy, case):
    prog, xs, want = WHILE_CASES[case]
    with device_grad.plain_driver():
        ours = _grads(lambda *t: prog(core, *t, save_policy=policy,
                                      impl="graph"), xs)
    host = _grads(lambda *t: prog(core, *t, save_policy=policy), xs)
    theirs = jax.grad(lambda *a: prog(jcore, *a, save_policy=policy).sum(),
                      argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x, jnp.float32) for x in xs])
    if want == "unrolled":
        want = _grads(_tanh_unrolled, xs)
    for k, (a, b, c) in enumerate(zip(ours, host, theirs)):
        _close(a, b, 1e-6, 1e-7)
        _close(a, c, 1e-4, 1e-6)
        if want is not None:
            _close(a, want[k], 1e-6, 1e-7)


# ----------------------------------------------------------- higher-order

XS = (np.arange(1.0, 7.0, dtype=np.float32) * 0.3).reshape(6, 1) * \
    np.ones((1, 2), np.float32)


def _functional(m, kind, w, e, z, **kw):
    lib = _lib(m)
    if kind in ("scan", "scan_reverse"):
        return m.scan(lambda c, x: lib.tanh(c * w + x), e, z,
                      reverse=kind == "scan_reverse", **kw)
    if kind in ("foldl", "foldr"):
        return getattr(m, kind)(lambda a, x: a * x + w, e, z, **kw)
    return m.map_fn(lambda x: x ** 3 * w, e, **kw)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["scan", "scan_reverse", "foldl", "foldr",
                                  "map_fn"])
def test_functionals_match_jax_and_the_host_lowering(kind, policy):
    args = (0.8, XS, np.array([0.5, -0.2], np.float32))
    weights = np.arange(1.0, 13.0, dtype=np.float32)

    def loss(m, *a, **kw):
        y = _functional(m, kind, *a, save_policy=policy, **kw)
        n = int(np.prod(y.shape))
        return y, (y * _lib(m).asarray(weights[:n]).reshape(y.shape)).sum()

    def port(impl):
        ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
        y, l = loss(core, *ts, impl=impl)
        return [y] + list(torch.autograd.grad(l, ts, allow_unused=True))

    ref = port("host")
    with device_grad.plain_driver():
        ours = port("graph")
    jy = loss(jcore, *[jnp.asarray(a) for a in args])[0]
    jg = jax.grad(lambda *a: loss(jcore, *a)[1], argnums=(0, 1, 2))(
        *[jnp.asarray(a) for a in args])
    n = 3 if kind == "map_fn" else 4        # map_fn takes no initial carry
    for a, b, c in list(zip(ours, ref, [jy, *jg]))[:n]:
        _close(a, b, 1e-6, 1e-7)
        _close(a, c, 1e-4, 1e-6)
    assert core.while_loop.last_grad_loop.policy == policy


# ----------------------------------------------------------- what is pushed

class _Calls:
    def __init__(self):
        self.n = 0


@pytest.mark.parametrize("policy", POLICIES)
def test_gradient_pass_calls_the_body_only_under_carry(policy):
    """``all``/``offload`` differentiate the recorded body; ``carry``
    re-runs it once per iteration."""
    p, x = _case(3)
    calls = _Calls()

    def cell(params, xt, state):
        calls.n += 1
        return rnn.lstm_cell(params, xt, state)

    tp = bridge.lstm_params_from_numpy(p, "cpu")
    for t in tp.values():
        t.requires_grad_()
    with device_grad.plain_driver():
        for _ in range(2):                    # the second call reuses it
            out, _ = rnn.dynamic_rnn(tp, torch.tensor(x), hidden=H,
                                     save_policy=policy, impl="graph",
                                     cell=cell)
            before = calls.n
            torch.autograd.grad(out.sum(), [tp["w"]])
            in_backward = calls.n - before
    assert in_backward == (0 if policy in RESIDUAL else S)
    loop = core.while_loop.last_grad_loop
    assert (loop.residual_bytes > 0) == (policy in RESIDUAL)
    assert (loop.carry_bytes > 0) == (policy not in RESIDUAL)


def _saved_bytes_of_one_step(p):
    """The bytes of the distinct tensors one LSTM step saves, leaving
    out views of the weights (an independent probe of what the residual
    stacks must hold)."""
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    weights = {t.untyped_storage().data_ptr() for t in tp.values()}
    for t in tp.values():
        t.requires_grad_()
    seen = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in weights:
            seen[(ptr, t.storage_offset(), tuple(t.shape),
                  tuple(t.stride()))] = t.numel() * t.element_size()
        return t

    xt = torch.randn(B, D, requires_grad=True)
    c, h = (torch.zeros(B, H, requires_grad=True) for _ in range(2))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        rnn.lstm_cell(tp, xt, (c, h))
    return sum(seen.values())


@pytest.mark.parametrize("policy", RESIDUAL)
def test_residual_bytes_are_the_distinct_saved_tensors(policy):
    """No stack for the weights (constants are re-viewed), one per
    distinct saved tensor and one for the step index the body reads
    and writes the arrays at; ``offload`` holds max_iters x
    ``residual_bytes`` in host memory."""
    p, x = _case(4)
    with device_grad.plain_driver():
        _port_grads(p, x, None, policy, "graph")
    loop = core.while_loop.last_grad_loop
    shapes = [st.shape for st in loop.res.stacks]
    assert (D + H, 4 * H) not in shapes and (4 * H,) not in shapes
    want = _saved_bytes_of_one_step(p) + 8        # + the int64 index
    assert loop.residual_bytes == want
    assert loop.host_bytes == (S * want if policy == "offload" else 0)
    assert loop.carry_bytes == 0


@pytest.mark.parametrize("policy", RESIDUAL)
def test_captured_array_gradient_lands_on_the_rows_read(policy):
    """Reads at an index computed in the body (``order[t]``): the index
    is pushed and popped, so each row read gets its own cotangent."""
    src = torch.arange(12.0).reshape(6, 2).requires_grad_()
    w = torch.tensor([2.0, -1.0], requires_grad=True)
    ta = core.DeviceTensorArray.unstack(src * 1.0)
    order = torch.tensor([0, 3, 3, 5, 1])

    def body(s):
        t, acc = s
        return (t + 1, acc * 0.5 + ta.read(order[t]) * w)

    init = (torch.zeros((), dtype=torch.long), torch.zeros(2))
    with device_grad.plain_driver():
        _, acc = core.while_loop(lambda s: s[0] < 5, body, init,
                                 max_iters=6, save_policy=policy,
                                 impl="graph")
    g_src, g_w = torch.autograd.grad(acc.sum(), [src, w])
    scale = 0.5 ** torch.arange(4.0, -1.0, -1.0)      # of read k
    rows = torch.zeros(6)
    rows.index_add_(0, order, scale)
    assert torch.equal(g_src, rows[:, None] * w.detach())
    assert torch.equal(g_w, (rows[:, None] * src.detach()).sum(0))


@pytest.mark.parametrize("policy", RESIDUAL)
def test_carry_array_rows_written_give_their_cotangents(policy):
    base = torch.zeros(4, 2, requires_grad=True)
    ta = core.DeviceTensorArray(base * 1.0, torch.zeros(4, dtype=torch.int32),
                                torch.zeros((), dtype=torch.int32))
    x = torch.tensor([1.0, -2.0], requires_grad=True)

    def body(s):
        t, arr = s
        return (t + 1, arr.write(t, x * (t + 1)))

    init = (torch.zeros((), dtype=torch.long), ta)
    with device_grad.plain_driver():
        _, out = core.while_loop(lambda s: s[0] < 3, body, init,
                                 max_iters=4, save_policy=policy,
                                 impl="graph")
    weights = torch.arange(8.0).reshape(4, 2)
    g_base, g_x = torch.autograd.grad((out.stack() * weights).sum(),
                                      [base, x])
    assert torch.equal(g_base[:3], torch.zeros(3, 2))
    assert torch.equal(g_base[3], weights[3])
    assert torch.equal(g_x, (weights[:3] * torch.tensor([[1.0], [2], [3]])
                             ).sum(0))


class _KeepsOnCtx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.kept = a.detach().clone()          # outside save_for_backward
        return a * a

    @staticmethod
    def backward(ctx, g):
        return 2 * g * ctx.kept


def test_state_kept_on_ctx_is_refused_and_runs_under_carry():
    w = torch.tensor(0.9, requires_grad=True)

    def run(policy):
        init = (torch.zeros((), dtype=torch.long), torch.tensor(1.1))
        with device_grad.plain_driver():
            _, y = core.while_loop(
                lambda s: s[0] < 3,
                lambda s: (s[0] + 1, _KeepsOnCtx.apply(s[1]) * w), init,
                max_iters=3, save_policy=policy, impl="graph")
        return torch.autograd.grad(y, w)[0]

    with pytest.raises(ValueError, match="_KeepsOnCtxBackward keeps "
                                         "ctx.kept"):
        run("all")
    ref = torch.autograd.grad(
        core.while_loop(lambda s: s[0] < 3,
                        lambda s: (s[0] + 1, _KeepsOnCtx.apply(s[1]) * w),
                        (0, torch.tensor(1.1)), max_iters=3)[1], w)[0]
    assert torch.equal(run("carry"), ref)


@pytest.mark.parametrize("second", ["saves_other_tensors",
                                    "records_other_ops"])
def test_a_body_that_records_differently_is_refused(second):
    """The gradient loop replays the first recording, so a body whose
    iterations save other tensors, or record other ops that save alike
    (``sigmoid`` for ``tanh``), is refused, not replayed wrong."""
    w = torch.tensor(0.7, requires_grad=True)
    calls = _Calls()
    other = {"saves_other_tensors": lambda y: y + 1.0,
             "records_other_ops": torch.sigmoid}[second]

    def body(s):
        calls.n += 1
        y = s[1] * w
        return (s[0] + 1, torch.tanh(y) if calls.n % 2 else other(y))

    init = (torch.zeros((), dtype=torch.long), torch.tensor(0.3))
    with device_grad.plain_driver(), pytest.raises(
            RuntimeError, match="must (save the same tensors|record the "
                                "same ops)"):
        core.while_loop(lambda s: s[0] < 4, body, init, max_iters=4,
                        save_policy="all", impl="graph")


def test_a_host_loop_nested_in_a_recorded_body_is_refused():
    """An inner ``impl="host"`` loop saves through its own hooks, which
    the recording cannot replay: refused under ``all``."""
    w = torch.tensor(0.5, requires_grad=True)

    def inner(y):
        return core.while_loop(lambda t: t[0] < 3,
                               lambda t: (t[0] + 1, t[1] * w), (0, y),
                               max_iters=4)[1]

    init = (torch.zeros((), dtype=torch.long), torch.tensor(0.3))
    with device_grad.plain_driver(), pytest.raises(
            NotImplementedError, match=r"impl='host'\) saves tensors"):
        core.while_loop(lambda s: s[0] < 2,
                        lambda s: (s[0] + 1, inner(s[1]) + 1.0), init,
                        max_iters=4, save_policy="all", impl="graph")
