"""The port's control-flow core (``repro_torch.core``) against the JAX
package's (``repro.core``): the same programs, the same numpy inputs,
through both, mirroring ``tests/core/``: while_loop forward semantics
and stack-saving gradients under every save policy, the TensorArray and
its §5.2 gradient duals, cond, the higher-order functions, the Fig. 5
primitives, and hypothesis properties against the dataflow oracle.

Tolerances: fp32 values rtol 1e-5 (the same math in another order);
gradients rtol 1e-4, atol 1e-6, as ``tests/models/test_components.py``
holds the JAX policies to each other. Inside the port, every policy
gives the same gradients bit for bit (the same ops in the same order,
saved or recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core
from repro_torch.core import stacks
from repro_torch.core.primitives import DeadnessError

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

POLICIES = ["all", "offload", "carry", "carry_offload"]
FAST = settings(max_examples=20, deadline=None)
RNG = np.random.default_rng(0)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(ours, theirs, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32),
                               rtol=rtol, atol=atol)


def _tgrad(fn, *xs):
    """torch gradients of scalar fn at float32 copies of xs."""
    ts = [torch.tensor(np.asarray(x, np.float32), requires_grad=True)
          for x in xs]
    return torch.autograd.grad(fn(*ts), ts)


def _jgrad(fn, *xs):
    return jax.grad(fn, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x, jnp.float32) for x in xs])


# ----------------------------------------------------------------- forward

def test_dynamic_trip_count():
    body = (lambda c: (c[0] + 1, c[1] * 1.5 + 1.0))
    out = core.while_loop(lambda c: c[0] < 7, body,
                          (torch.tensor(0), torch.tensor(2.0)),
                          max_iters=100)
    ref = jcore.while_loop(lambda c: c[0] < 7, body,
                           (jnp.int32(0), jnp.float32(2.0)), max_iters=100)
    assert int(out[0]) == int(ref[0]) == 7
    _close(out[1], ref[1])


def test_zero_iterations():
    body = (lambda c: (c[0] + 1, c[1] + 1.0))
    out = core.while_loop(lambda c: c[0] < 0, body,
                          (torch.tensor(0), torch.tensor(5.0)), max_iters=4)
    ref = jcore.while_loop(lambda c: c[0] < 0, body,
                           (jnp.int32(0), jnp.float32(5.0)), max_iters=4)
    _close(out[1], ref[1])
    assert float(out[1]) == 5.0


def test_max_iters_clamps_forward_and_gradient():
    body = (lambda c: (c[0] + 1, c[1] * 2.0))
    out = core.while_loop(lambda c: c[0] < 100, body, (0, torch.tensor(1.0)),
                          max_iters=5)
    assert out[0] == 5 and float(out[1]) == 32.0
    g = _tgrad(lambda x: core.while_loop(
        lambda c: c[0] < 100, body, (0, x), max_iters=5)[1], 1.0)
    gr = _jgrad(lambda x: jcore.while_loop(
        lambda c: c[0] < 100, body, (jnp.int32(0), x), max_iters=5)[1], 1.0)
    _close(g[0], gr[0])


@pytest.mark.parametrize("unroll", [1, 2, 4, 10])
def test_counted_loop_parallel_iterations_no_effect(unroll):
    y = core.fori_loop(0, 10, lambda i, c: c + i, torch.tensor(0.0),
                       parallel_iterations=unroll)
    ref = jcore.fori_loop(0, 10, lambda i, c: c + jnp.float32(i),
                          jnp.float32(0.0), parallel_iterations=unroll)
    _close(y, ref)


def test_vector_predicate_means_any():
    """A per-row predicate keeps the loop alive while any row holds."""
    limits = np.array([2, 5, 3], np.int32)

    def run(mod, lim, i0, x0):
        def body(c):
            return (c[0] + 1, c[1] + (c[0] < lim) * 1.0)
        return mod.while_loop(lambda c: c[0] < lim, body, (i0, x0),
                              max_iters=10)

    out = run(core, torch.tensor(limits), torch.tensor(0), torch.zeros(3))
    ref = run(jcore, jnp.asarray(limits), jnp.int32(0), jnp.zeros(3))
    assert int(out[0]) == int(ref[0]) == 5
    _close(out[1], ref[1])


def test_host_reads_are_counted_only_for_tensor_predicates():
    before = core.while_loop.host_reads
    core.while_loop(lambda c: c < 4, lambda c: c + 1, 0, max_iters=8)
    assert core.while_loop.host_reads == before
    core.while_loop(lambda c: c < 4, lambda c: c + 1, torch.tensor(0),
                    max_iters=8)
    assert core.while_loop.host_reads == before + 5   # 4 true, 1 false


def test_refusals():
    with pytest.raises(ValueError, match="save_policy"):
        core.while_loop(None, lambda c: c, 0, max_iters=2, save_policy="x")
    with pytest.raises(ValueError, match="max_iters"):
        core.while_loop(None, lambda c: c, 0)
    for kw in ({"mesh": object()}, {"offload_shardings": object()}):
        with pytest.raises(NotImplementedError, match="dist"):
            core.while_loop(None, lambda c: c, 0, max_iters=2, **kw)
        with pytest.raises(NotImplementedError, match="dist"):
            core.fori_loop(0, 2, lambda i, c: c, 0, **kw)


def test_requires_max_iters_for_grad():
    body = (lambda c: (c[0] + 1, c[1] * 2.0))
    with pytest.raises(ValueError, match="max_iters"):
        jax.grad(lambda x: jcore.while_loop(
            lambda c: c[0] < 3, body, (jnp.int32(0), x))[1])(jnp.float32(1.))
    with pytest.raises(ValueError, match="max_iters"):
        core.while_loop(lambda c: c[0] < 3, body,
                        (0, torch.tensor(1.0, requires_grad=True)))
    w = torch.tensor(2.0, requires_grad=True)       # a captured constant
    with pytest.raises(ValueError, match="max_iters"):
        core.while_loop(lambda c: c[0] < 3, lambda c: (c[0] + 1, c[1] * w),
                        (0, torch.tensor(1.0)))
    with torch.no_grad():                         # primal: no bound needed
        out = core.while_loop(lambda c: c[0] < 3,
                              lambda c: (c[0] + 1, c[1] * w),
                              (0, torch.tensor(1.0)))
    assert float(out[1]) == 8.0


# --------------------------------------------------------------- gradients

def _tanh_loop(mod, policy, n=6, max_iters=8):
    def loss(w, x):
        i0 = jnp.int32(0) if mod is jcore else 0
        _, y = mod.while_loop(lambda c: c[0] < n,
                              lambda c: (c[0] + 1,
                                         (jnp if mod is jcore else torch)
                                         .tanh(c[1] * w)),
                              (i0, x), max_iters=max_iters,
                              save_policy=policy)
        return y ** 2
    return loss


@pytest.mark.parametrize("policy", POLICIES)
def test_grad_matches_jax_and_unrolled(policy):
    g = _tgrad(_tanh_loop(core, policy), 1.3, 0.7)
    gr = _jgrad(_tanh_loop(jcore, policy), 1.3, 0.7)

    def unrolled(w, x):
        y = x
        for _ in range(6):
            y = torch.tanh(y * w)
        return y ** 2

    gu = _tgrad(unrolled, 1.3, 0.7)
    for a, b, c in zip(g, gr, gu):
        _close(a, b, rtol=1e-4)
        assert torch.equal(a, c)


def test_loop_constant_gradient_summed():
    """Paper §5.1: gradients of loop constants accumulate per iteration."""
    def loss(mod, w):
        i0 = jnp.int32(0) if mod is jcore else 0
        z = jnp.float32(0.0) if mod is jcore else torch.tensor(0.0)
        _, y = mod.while_loop(lambda c: c[0] < 5,
                              lambda c: (c[0] + 1, c[1] + w), (i0, z),
                              max_iters=8)
        return y
    g = _tgrad(lambda w: loss(core, w), 2.0)
    gr = _jgrad(lambda w: loss(jcore, w), 2.0)
    _close(g[0], gr[0])
    assert float(g[0]) == 5.0


@pytest.mark.parametrize("n", [0, 1, 3, 16])
def test_data_dependent_trip_count_grad(n):
    """The gradient runs the actual number of iterations."""
    def loss(mod, x, i0):
        _, y = mod.while_loop(lambda c: c[0] < n,
                              lambda c: (c[0] + 1, c[1] * 2.0), (i0, x),
                              max_iters=16)
        return y
    g = _tgrad(lambda x: loss(core, x, torch.tensor(0)), 1.0)
    gr = _jgrad(lambda x: loss(jcore, x, jnp.int32(0)), 1.0)
    _close(g[0], gr[0])
    assert float(g[0]) == 2.0 ** n


@pytest.mark.parametrize("policy", POLICIES)
def test_nested_while_grad(policy):
    def nested(mod, np_, w, x):
        i0 = jnp.int32(0) if mod is jcore else 0

        def ob(s):
            i, y = s
            _, y2 = mod.while_loop(lambda t: t[0] < 3,
                                   lambda t: (t[0] + 1, t[1] * w), (i0, y),
                                   max_iters=4, save_policy=policy)
            return (i + 1, y2 + 1.0)
        return mod.while_loop(lambda s: s[0] < 2, ob, (i0, x), max_iters=4,
                              save_policy=policy)[1]

    g = _tgrad(lambda w, x: nested(core, torch, w, x), 0.5, 0.3)
    gr = _jgrad(lambda w, x: nested(jcore, jnp, w, x), 0.5, 0.3)
    for a, b in zip(g, gr):
        _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("backend", ["native", "select"])
def test_cond_in_while_grad(backend):
    def loss(mod, w, x):
        i0 = jnp.int32(0) if mod is jcore else torch.tensor(0)

        def b(c):
            i, y = c
            y = mod.cond(i % 2 == 0, lambda v: v * w, lambda v: v + 1.0, y,
                         backend=backend)
            return (i + 1, y)
        return mod.while_loop(lambda c: c[0] < 4, b, (i0, x),
                              max_iters=4)[1]

    g = _tgrad(lambda w, x: loss(core, w, x), 1.5, 2.0)
    gr = _jgrad(lambda w, x: loss(jcore, w, x), 1.5, 2.0)
    for a, b in zip(g, gr):
        _close(a, b, rtol=1e-4)


@pytest.mark.parametrize("policy", POLICIES)
def test_matrix_carry(policy):
    """Shape-preserving matrix loop (the paper's §5.1 example program)."""
    w = RNG.standard_normal((10, 10)).astype(np.float32) * 0.1
    x = RNG.standard_normal((10, 10)).astype(np.float32)

    def loss(mod, w, x):
        i0 = jnp.int32(0) if mod is jcore else 0
        _, a = mod.while_loop(lambda c: c[0] < 3,
                              lambda c: (c[0] + 1, c[1] @ w), (i0, x),
                              max_iters=3, save_policy=policy)
        return a.sum()

    g = _tgrad(lambda w, x: loss(core, w, x), w, x)
    gr = _jgrad(lambda w, x: loss(jcore, w, x), w, x)
    for a, b in zip(g, gr):
        _close(a, b, rtol=1e-4, atol=1e-6)


def test_policies_push_where_they_say():
    """all/carry keep the saved values on the device (here: in place),
    offload/carry_offload copy them to host memory; carry policies save
    only the carry, so fewer bytes than all."""
    w = torch.tensor(RNG.standard_normal((16, 16)) * 0.2, dtype=torch.float32,
                     requires_grad=True)
    x = torch.tensor(RNG.standard_normal((4, 16)), dtype=torch.float32)
    saved, grads = {}, {}
    for policy in POLICIES:
        _, y = core.while_loop(None, lambda c: (c[0] + 1, torch.tanh(c[1] @ w)),
                               (0, x), max_iters=5, save_policy=policy)
        stack = core.while_loop.last_stack
        saved[policy] = (stack.saved_bytes, stack.host_bytes)
        grads[policy] = torch.autograd.grad(y.square().sum(), w)[0]
    assert saved["all"][1] == saved["carry"][1] == 0
    assert saved["offload"][1] == saved["offload"][0] > 0
    assert saved["carry_offload"][1] == saved["carry_offload"][0] > 0
    assert saved["carry"][0] < saved["all"][0]
    for policy in POLICIES:
        assert torch.equal(grads[policy], grads["all"])


def test_host_stack_reuses_its_chunks_and_copies():
    """A pushed value is copied (not aliased) into the stack's chunk and
    comes back equal; a value saved twice in one iteration is pushed
    once."""
    stack = stacks.SaveStack(offload=True)
    t = torch.arange(6.0).reshape(2, 3).requires_grad_()[0:1] * 1.0
    a, b = stack._push(t), stack._push(t)
    assert a is b and stack.host_bytes == t.numel() * 4
    assert a.host.data_ptr() != t.data_ptr()
    stack.next_iteration()
    assert torch.equal(stack._pop(a), t.detach())


# ------------------------------------------------------------ TensorArray

def test_tensor_array_write_read():
    ta = core.TensorArray.create(3, (2,)).write(1, torch.tensor([1.0, 2.0]))
    jta = jcore.TensorArray.create(3, (2,)).write(1, jnp.array([1.0, 2.0]))
    _close(ta.read(1), jta.read(1))
    _close(ta.read(0), jta.read(0))
    _close(ta.stack(), jta.stack())


def test_tensor_array_unstack_stack_gather_size():
    x = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    ta, jta = core.TensorArray.unstack(torch.tensor(x)), \
        jcore.TensorArray.unstack(jnp.asarray(x))
    _close(ta.stack(), jta.stack())
    _close(ta.gather([3, 1]), jta.gather(jnp.array([3, 1])))
    assert ta.size() == jta.size() == 4
    assert tuple(ta.elem_shape) == tuple(jta.elem_shape) == (3,)
    ta = core.TensorArray.create(5, (2, 3), torch.bfloat16)
    assert (ta.size(), ta.elem_shape, ta.dtype) == (5, (2, 3),
                                                    torch.bfloat16)


def test_tensor_array_write_once():
    ta = core.TensorArray.create(3, ()).write(0, 1.0)
    with pytest.raises(core.WriteOnceError):
        ta.write(0, 2.0)
    with pytest.raises(core.WriteOnceError):
        core.TensorArray.unstack(torch.zeros(2)).write(1, 1.0)
    old = core.TensorArray.create(2, ())
    old.write(0, 1.0)                     # functional: old stays unwritten
    assert float(old.write(0, 3.0).read(0)) == 3.0


@pytest.mark.parametrize("case", ["read", "two_reads", "write", "stack"])
def test_tensor_array_gradient_duals(case):
    """§5.2: grad(read) = grad_ta.write; reads sum; grad(write) = read;
    stack and unstack transpose to each other."""
    def f(mod, v):
        TA = mod.TensorArray
        if case == "read":
            return TA.unstack(v).read(1).sum()
        if case == "two_reads":
            ta = TA.unstack(v)
            return (2.0 * ta.read(1) + 3.0 * ta.read(1)).sum()
        if case == "write":
            return TA.create(3, (2,)).write(2, v[0] * 4.0).stack().sum()
        return TA.unstack(v).stack().sum()

    v = np.ones((3, 2), np.float32)
    g = _tgrad(lambda v: f(core, v), v)[0]
    gr = _jgrad(lambda v: f(jcore, v), v)[0]
    _close(g, gr)


@pytest.mark.parametrize("policy", POLICIES)
def test_tensor_array_as_loop_variable(policy):
    """Fig. 2 pattern: TensorArray threaded through a while_loop."""
    def f(mod, xs):
        i0, z = ((jnp.int32(0), jnp.float32(0.0)) if mod is jcore
                 else (0, torch.tensor(0.0)))
        in_ta = mod.TensorArray.unstack(xs)

        def body(c):
            i, acc, ta = c
            v = acc + in_ta.read(i)
            return (i + 1, v, ta.write(i, v))

        _, _, out = mod.while_loop(lambda c: c[0] < 5, body,
                                   (i0, z, mod.TensorArray.create(5, ())),
                                   max_iters=5, save_policy=policy)
        return out.stack()

    xs = np.arange(5.0, dtype=np.float32)
    _close(f(core, torch.tensor(xs)), f(jcore, jnp.asarray(xs)))
    g = _tgrad(lambda xs: f(core, xs).sum(), xs)[0]
    gr = _jgrad(lambda xs: f(jcore, xs).sum(), xs)[0]
    _close(g, gr)
    _close(g, [5, 4, 3, 2, 1])


# -------------------------------------------------------------------- cond

@pytest.mark.parametrize("backend", ["native", "select"])
@pytest.mark.parametrize("pred", [True, False])
def test_cond_matches_jax(backend, pred):
    t = (lambda v, w: (v * 2.0 + w, w))
    f = (lambda v, w: (v - 3.0, w * w))
    out = core.cond(torch.tensor(pred), t, f, torch.tensor(1.5),
                    torch.tensor(0.5), backend=backend)
    ref = jcore.cond(jnp.asarray(pred), t, f, jnp.float32(1.5),
                     jnp.float32(0.5), backend=backend)
    for a, b in zip(out, ref):
        _close(a, b)
    with pytest.raises(ValueError):
        core.cond(True, t, f, 1.0, 1.0, backend="other")


# ------------------------------------------------------------ higher-order

@pytest.mark.parametrize("backend", ["paper", "native"])
def test_scan_matches_jax(backend):
    xs = np.arange(6.0, dtype=np.float32)
    fn = (lambda c, x: c * 0.9 + x)
    _close(core.scan(fn, torch.tensor(xs), torch.tensor(0.0),
                     backend=backend),
           jcore.scan(fn, jnp.asarray(xs), jnp.float32(0.0)))
    _close(core.scan(fn, torch.tensor(xs), torch.tensor(0.0), reverse=True,
                     backend=backend),
           jcore.scan(fn, jnp.asarray(xs), jnp.float32(0.0), reverse=True))


@pytest.mark.parametrize("policy", POLICIES)
def test_scan_grad_matches_jax(policy):
    xs = np.arange(6.0, dtype=np.float32)

    def loss(mod, w):
        tanh = jnp.tanh if mod is jcore else torch.tanh
        xs_ = jnp.asarray(xs) if mod is jcore else torch.tensor(xs)
        z = jnp.float32(0.0) if mod is jcore else torch.tensor(0.0)
        return mod.scan(lambda c, x: tanh(c * w + x), xs_, z,
                        save_policy=policy).sum()

    _close(_tgrad(lambda w: loss(core, w), 0.8)[0],
           _jgrad(lambda w: loss(jcore, w), 0.8)[0], rtol=1e-4)


def test_scan_pytree_elems():
    xs = {"a": torch.arange(4.0), "b": torch.ones(4, 2)}
    ys = core.scan(lambda c, x: c + x["a"] + x["b"].sum(), xs,
                   torch.tensor(0.0))
    ref = jcore.scan(lambda c, x: c + x["a"] + x["b"].sum(),
                     {"a": jnp.arange(4.0), "b": jnp.ones((4, 2))},
                     jnp.float32(0.0))
    assert ys.shape == (4,)
    _close(ys, ref)


@pytest.mark.parametrize("backend", ["paper", "native"])
def test_folds_match_jax(backend):
    xs = np.arange(5.0, dtype=np.float32)
    fn = (lambda a, x: a * 0.5 + x)
    for port, ref in ((core.foldl, jcore.foldl), (core.foldr, jcore.foldr)):
        _close(port(fn, torch.tensor(xs), torch.tensor(1.0),
                    backend=backend),
               ref(fn, jnp.asarray(xs), jnp.float32(1.0)))


def test_foldl_grad():
    xs = np.arange(1.0, 5.0, dtype=np.float32)
    g = _tgrad(lambda xs: core.foldl(lambda a, x: a * x, xs,
                                     torch.tensor(1.0)), xs)[0]
    gr = _jgrad(lambda xs: jcore.foldl(lambda a, x: a * x, xs,
                                       jnp.float32(1.0)), xs)[0]
    _close(g, gr)
    _close(g, np.prod(xs) / xs)


def test_map_fn_and_grad():
    xs = np.arange(5.0, dtype=np.float32)
    _close(core.map_fn(lambda x: x * x, torch.tensor(xs)),
           jcore.map_fn(lambda x: x * x, jnp.asarray(xs)))
    g = _tgrad(lambda xs: core.map_fn(lambda x: x ** 3, xs).sum(), xs)[0]
    gr = _jgrad(lambda xs: jcore.map_fn(lambda x: x ** 3, xs).sum(), xs)[0]
    _close(g, gr)


# -------------------------------------------------------------- primitives

def _live(v, tag=core.ROOT_TAG):
    return core.TaggedValue(torch.as_tensor(v), False, tag)


@pytest.mark.parametrize("p", [True, False])
@pytest.mark.parametrize("d_dead", [False, True])
@pytest.mark.parametrize("p_dead", [False, True])
def test_switch_matches_jax(p, d_dead, p_dead):
    def run(mod, asarray):
        d = mod.TaggedValue(asarray(3.0), d_dead)
        pv = mod.TaggedValue(asarray(p), p_dead)
        return [(v.is_dead, float(v.value)) for v in mod.switch(d, pv)]
    assert run(core, torch.as_tensor) == run(jcore, jnp.asarray)


def test_merge_enter_exit_next_iteration():
    assert float(core.merge(_live(1.0), _live(2.0)).value) == 1.0
    assert float(core.merge(_live(1.0).dead(), _live(2.0)).value) == 2.0
    assert core.merge(_live(1.0).dead(), _live(2.0).dead()).is_dead
    v = core.enter(_live(5.0), "loop")
    assert v.tag == (("loop", 0),)
    v = core.next_iteration(core.next_iteration(v))
    assert v.tag == (("loop", 2),) and core.format_tag(v.tag) == "/loop/2"
    assert core.exit_(v).tag == core.ROOT_TAG
    for fn in (core.next_iteration, core.exit_):
        with pytest.raises(ValueError):
            fn(_live(1.0))
    with pytest.raises(DeadnessError):
        core.switch(_live(1.0, (("f", 0),)), _live(True))


def test_apply_op_skips_compute_on_dead_input():
    calls = []

    def f(a, b):
        calls.append(1)
        return a + b

    assert float(core.apply_op(f, _live(2.0), _live(3.0)).value) == 5.0
    assert core.apply_op(f, _live(2.0).dead(), _live(3.0)).is_dead
    assert calls == [1]


# -------------------------------------------------------------- properties

def f32s(lo, hi, steps=40):
    return st.integers(0, steps).map(lambda i: float(lo + (hi - lo) * i
                                                     / steps))


@FAST
@given(x=f32s(-2.0, 2.0), n=st.integers(0, 9), a=f32s(0.1, 1.5),
       b=f32s(-2.0, 2.0))
def test_while_agrees_with_dataflow_oracle(x, n, a, b):
    body = (lambda i, y: (i + 1, y * a + b))
    pred = (lambda i, y: i < n)
    ref = core.dataflow_while(pred, body, (0, torch.tensor(x)))
    jref = jcore.dataflow_while(pred, body, (0, jnp.float32(x)))
    out = core.while_loop(lambda c: pred(*c), lambda c: body(*c),
                          (0, torch.tensor(x)), max_iters=16)
    _close(out[1], ref[1], atol=1e-5)
    _close(ref[1], jref[1], atol=1e-5)


@FAST
@given(pred=st.booleans(), x=f32s(-2.0, 2.0))
def test_cond_agrees_with_dataflow_oracle(pred, x):
    t = (lambda v: v * 2.0 + 1.0)
    f = (lambda v: v - 3.0)
    ref = core.dataflow_cond(pred, t, f, torch.tensor(x))
    _close(ref, jcore.dataflow_cond(pred, t, f, jnp.float32(x)))
    for backend in ("native", "select"):
        _close(core.cond(torch.tensor(pred), t, f, torch.tensor(x),
                         backend=backend), ref)


@FAST
@given(n=st.integers(0, 8), w=f32s(0.2, 1.2), x=f32s(-1.0, 1.0),
       policy=st.sampled_from(POLICIES))
def test_while_grad_equals_unrolled(n, w, x, policy):
    def loss(w, x):
        return core.while_loop(lambda c: c[0] < n,
                               lambda c: (c[0] + 1, torch.tanh(c[1] * w)),
                               (0, x), max_iters=8, save_policy=policy)[1]

    def ref(w, x):
        y = x
        for _ in range(n):
            y = torch.tanh(y * w)
        return y

    if n == 0:      # y = x: no gradient reaches w
        assert float(_tgrad(lambda w, x: loss(w, x) + 0 * w, w, x)[1]) == 1.
        return
    for a, b in zip(_tgrad(loss, w, x), _tgrad(ref, w, x)):
        assert torch.equal(a, b)


@FAST
@given(data=st.lists(f32s(-2.0, 2.0), min_size=1, max_size=8))
def test_scan_matches_python(data):
    ys = core.scan(lambda c, x: c * 0.7 + x, torch.tensor(data),
                   torch.tensor(0.0))
    c, ref = 0.0, []
    for v in data:
        c = c * 0.7 + v
        ref.append(c)
    _close(ys, np.asarray(ref, np.float32), rtol=1e-4, atol=1e-5)


@FAST
@given(d1=st.booleans(), d2=st.booleans(), p=st.booleans())
def test_deadness_algebra(d1, d2, p):
    a = core.TaggedValue(torch.tensor(1.0), d1)
    b = core.TaggedValue(torch.tensor(2.0), d2)
    assert core.apply_op(lambda x, y: x + y, a, b).is_dead == (d1 or d2)
    assert core.merge(a, b).is_dead == (d1 and d2)
    f_port, t_port = core.switch(a, core.TaggedValue(torch.tensor(p)))
    if d1:
        assert f_port.is_dead and t_port.is_dead
    else:
        assert (f_port.is_dead, t_port.is_dead) == (p, not p)
