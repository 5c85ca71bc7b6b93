"""§5.1's gradient of a conditional and nested graph loops on the card:
``cond(backend="graph")`` under grad as IF nodes on the predicate, and a
``while_loop(impl="graph")`` in a graph loop's body as a nested WHILE
node, held to the host lowering (``impl="host"``, each predicate read
on the host) on the same inputs. The file imports neither ``jax`` nor
``repro``; ``tests/test_torch_graph_control.py`` holds the same programs
to the JAX package on the CPU. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_graph_control_card.py

Tolerance: the graph replays the host lowering's kernels on the same
operands, but cuBLAS may pick another algorithm under capture, so fp32
gradients are held at rtol 1e-5 (atol 1e-6); the nested forward is held
bit for bit to the same layers run as one graph loop each.
"""

import pytest
import torch

from repro_torch import bridge, core
from repro_torch.core import device_grad
from repro_torch.core.device_grad import GradLoop
from repro_torch.core.device_loop import DeviceLoop
from repro_torch.models import rnn

POLICIES = ["all", "offload", "carry", "carry_offload"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    device_grad.release()
    yield torch.device("cuda")
    device_grad.release()


def _long0(dev):
    return torch.zeros((), dtype=torch.long, device=dev)


def _even_scale(w, x, impl, policy):
    """``cond(i % 2 == 0, y * w, y + 1)`` four times (the JAX package's
    ``test_cond_in_while_grad``)."""
    def b(c):
        i, y = c
        return (i + 1, core.cond(i % 2 == 0, lambda v: v * w,
                                 lambda v: v + 1.0, y,
                                 backend="graph" if impl == "graph"
                                 else "native"))
    i0 = _long0(x.device) if impl == "graph" else 0
    return core.while_loop(lambda c: c[0] < 4, b, (i0, x), max_iters=4,
                           save_policy=policy, impl=impl)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cond_under_grad_reads_nothing_on_the_host(cuda_device, policy):
    """The gradient of the JAX test's program equals the host lowering's
    (dy/dw = 2xw + 1 = 7, not 0), two graph launches a pass, and a pass
    adds no host read."""
    def grads(impl):
        w = torch.tensor(1.5, device=cuda_device, requires_grad=True)
        x = torch.tensor(2.0, device=cuda_device, requires_grad=True)
        y = _even_scale(w, x, impl, policy)
        return (y.detach(),) + torch.autograd.grad(y, [w, x])

    ref = grads("host")
    grads("graph")                               # captures
    torch.cuda.synchronize()
    launches, reads = GradLoop.replays, DeviceLoop.host_reads
    loop_reads = core.while_loop.host_reads
    ours = grads("graph")
    torch.cuda.synchronize()
    assert GradLoop.replays - launches == 2
    assert DeviceLoop.host_reads == reads
    assert core.while_loop.host_reads == loop_reads
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float(ours[1]) != 0.0


def _flagged(params, x, flags, impl, policy):
    """The LSTM step where ``flags[t]`` is set, the state carried through
    where not."""
    B, S, _ = x.shape
    H = params["b"].shape[0] // 4
    graph = impl == "graph"
    ta = core.DeviceTensorArray if graph else core.TensorArray
    xs = ta.unstack(x.transpose(0, 1).contiguous())
    fl = ta.unstack(flags)

    def step(c, h, xt):
        _, (c2, h2) = rnn.lstm_cell(params, xt, (c, h))
        return c2, h2

    def body(s):
        t, c, h = s
        c, h = core.cond(fl.read(t) != 0, step, lambda c, h, xt: (c, h), c,
                         h, xs.read(t),
                         backend="graph" if graph else "native")
        return (t + 1, c, h)

    zeros = torch.zeros(B, H, device=x.device)
    _, c, h = core.while_loop(
        None, body, (_long0(x.device) if graph else 0, zeros, zeros),
        max_iters=S, save_policy=policy, impl=impl)
    return c, h


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_flagged_lstm_body_equals_the_host_lowering(cuda_device, policy):
    B, S, D, H = 16, 24, 32, 32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = bridge.init_lstm_params(D, H, seed=1, device="cuda")
    for p in params.values():
        p.requires_grad_()
    x = torch.randn(B, S, D, generator=gen, device=cuda_device,
                    requires_grad=True)
    flags = (torch.rand(S, generator=gen, device=cuda_device) < 0.5).int()

    def grads(impl):
        c, h = _flagged(params, x, flags, impl, policy)
        loss = (h ** 2).sum() + (c * h).sum()
        return (loss.detach(),) + torch.autograd.grad(
            loss, [params["w"], params["b"], x])

    ref = grads("host")
    for _ in range(2):
        ours = grads("graph")
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(ours[3][:, flags == 0]) == 0


def _stacked_fns(w, b, impl, inner="all", cell=rnn.lstm_cell):
    """An outer loop over the layers, weights (L, D+H, 4H) read at its
    counter, its body one ``dynamic_rnn``: (cond_fn, body_fn)."""
    H = b.shape[1] // 4

    def cond_fn(s):
        return s[0] < w.shape[0]

    def body_fn(s):
        l, y = s
        ix = l.reshape(1) if torch.is_tensor(l) else l
        p = {"w": w[ix].reshape(w.shape[1:]), "b": b[ix].reshape(b.shape[1:])}
        out, _ = rnn.dynamic_rnn(p, y, hidden=H, save_policy=inner,
                                 impl=impl, cell=cell)
        return (l + 1, out)

    return cond_fn, body_fn


def _stacked(w, b, x, impl, outer="all", inner="all"):
    cond_fn, body_fn = _stacked_fns(w, b, impl, inner)
    l0 = _long0(x.device) if impl == "graph" else 0
    return core.while_loop(cond_fn, body_fn, (l0, x), max_iters=w.shape[0],
                           save_policy=outer, impl=impl)[1]


def _restart(s):
    s[0].zero_()


def _weights(L, D, H, dev, grad=False):
    ps = [bridge.init_lstm_params(D, H, seed=5 + k, device="cuda")
          for k in range(L)]
    w = torch.stack([p["w"] for p in ps]).to(dev)
    b = torch.stack([p["b"] for p in ps]).to(dev)
    return w.requires_grad_(grad), b.requires_grad_(grad), ps


@pytest.mark.cuda
def test_nested_forward_is_one_launch_equal_to_a_loop_a_layer(cuda_device):
    L, B, S, D = 3, 8, 20, 32
    w, b, ps = _weights(L, D, D, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(B, S, D, generator=gen, device=cuda_device)
    cond_fn, body_fn = _stacked_fns(w, b, "graph")
    carry = (_long0(cuda_device), x.clone())
    with torch.no_grad():
        ref = rnn.multilayer_dynamic_rnn(ps, x, hidden=D, impl="graph")
        core.while_loop(cond_fn, body_fn, carry, max_iters=L, impl="graph",
                        prologue=_restart)              # captures
        torch.cuda.synchronize()
        first = carry[1].clone()
        carry[1].copy_(x)
        captures, launches = DeviceLoop.captures, DeviceLoop.replays
        core.while_loop(cond_fn, body_fn, carry, max_iters=L, impl="graph",
                        prologue=_restart)
        torch.cuda.synchronize()
    assert DeviceLoop.replays - launches == 1
    assert DeviceLoop.captures == captures
    assert torch.equal(carry[1], ref) and torch.equal(first, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("inner", POLICIES)
@pytest.mark.parametrize("outer", ["carry", "carry_offload"])
def test_nested_gradient_equals_the_host_lowering(cuda_device, outer, inner):
    L, B, S, D = 2, 8, 12, 16

    def grads(impl):
        w, b, _ = _weights(L, D, D, cuda_device, grad=True)
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        x = torch.randn(B, S, D, generator=gen, device=cuda_device,
                        requires_grad=True)
        y = _stacked(w, b, x, impl, outer=outer, inner=inner)
        return (y.detach(),) + torch.autograd.grad((y ** 2).sum(),
                                                   [w, b, x])

    ref = grads("host")
    grads("graph")                               # captures
    launches = GradLoop.replays
    ours = grads("graph")
    assert GradLoop.replays - launches == 2
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("outer", ["all", "offload"])
def test_inner_graph_loop_in_a_recorded_body_is_refused(cuda_device, outer):
    w, b, _ = _weights(2, 8, 8, cuda_device, grad=True)
    x = torch.randn(2, 4, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="'carry'"):
        _stacked(w, b, x, "graph", outer=outer)


def _inner_loop(y, body, impl, inner):
    i0 = _long0(y.device) if impl == "graph" else 0
    return core.while_loop(lambda t: t[0] < 3, body, (i0, y), max_iters=4,
                           save_policy=inner, impl=impl)[1]


def _cond_in_inner(w, x, impl, outer, inner):
    """The inner loop's body a cond; tanh after it, twice."""
    backend = "graph" if impl == "graph" else "native"

    def ib(t):
        return (t[0] + 1, core.cond(t[0] % 2 == 0, lambda u: u @ w,
                                    lambda u: u + 1.0, t[1],
                                    backend=backend))

    def ob(s):
        i, y = s
        return (i + 1, torch.tanh(_inner_loop(y, ib, impl, inner)))
    i0 = _long0(x.device) if impl == "graph" else 0
    return core.while_loop(lambda s: s[0] < 2, ob, (i0, x), max_iters=4,
                           save_policy=outer, impl=impl)[1]


def _while_in_cond(w, x, impl, outer, inner):
    """An inner loop in a branch taken on even outer steps."""
    backend = "graph" if impl == "graph" else "native"

    def ob(s):
        i, y = s
        return (i + 1, core.cond(
            i % 2 == 0,
            lambda v: _inner_loop(v, lambda t: (t[0] + 1, t[1] @ w), impl,
                                  inner),
            lambda v: v + 1.0, y, backend=backend))
    i0 = _long0(x.device) if impl == "graph" else 0
    return core.while_loop(lambda s: s[0] < 4, ob, (i0, x), max_iters=4,
                           save_policy=outer, impl=impl)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("inner", POLICIES)
@pytest.mark.parametrize("program", [_cond_in_inner, _while_in_cond])
def test_conds_and_loops_nested_under_grad_equal_the_host(cuda_device,
                                                          program, inner):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    w0 = torch.randn(16, 16, generator=gen, device=cuda_device) * 0.3
    x0 = torch.randn(8, 16, generator=gen, device=cuda_device)

    def grads(impl):
        w = w0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        y = program(w, x, impl, "carry", inner)
        return (y.detach(),) + torch.autograd.grad((y ** 2).sum(), [w, x])

    ref = grads("host")
    for _ in range(2):
        ours = grads("graph")
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


def _halve_or_step(s):
    """Outer body: on even steps a counted inner loop of 7 steps, unrolled
    by 3 (two WHILE-node steps and a remainder step), whose body is a
    cond; on odd steps y / 2."""
    i, y = s

    def inner(v):
        def ib(t):
            return (t[0] + 1, core.cond(t[0] % 3 == 0,
                                        lambda u: u * 0.9 + 0.1,
                                        lambda u: u - 0.05, t[1],
                                        backend="graph"))
        return core.while_loop(None, ib, (_long0(v.device), v), max_iters=7,
                               parallel_iterations=3, impl="graph")[1]

    return (i + 1, core.cond(i % 2 == 0, inner, lambda v: v * 0.5, y,
                             backend="graph"))


def _five(s):
    return s[0] < 5


@pytest.mark.cuda
def test_nested_while_in_an_if_node_with_a_remainder_step(cuda_device):
    x0 = torch.linspace(-1.0, 1.0, 64, device=cuda_device)
    ref = x0.clone()
    for i in range(5):
        if i % 2 == 0:
            for t in range(7):
                ref = ref * 0.9 + 0.1 if t % 3 == 0 else ref - 0.05
        else:
            ref = ref * 0.5
    carry = (_long0(cuda_device), x0.clone())
    with torch.no_grad():
        core.while_loop(_five, _halve_or_step, carry, max_iters=8,
                        impl="graph", prologue=_restart)    # captures
        torch.cuda.synchronize()
        first = carry[1].clone()
        carry[1].copy_(x0)
        launches, captures = DeviceLoop.replays, DeviceLoop.captures
        core.while_loop(_five, _halve_or_step, carry, max_iters=8,
                        impl="graph", prologue=_restart)
        torch.cuda.synchronize()
    assert (DeviceLoop.replays - launches, DeviceLoop.captures) == \
        (1, captures)
    assert int(carry[0]) == 5
    torch.testing.assert_close(carry[1], ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(first, ref, rtol=1e-6, atol=1e-6)
