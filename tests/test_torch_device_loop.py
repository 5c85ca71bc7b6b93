"""``core.while_loop(impl="graph")`` and ``core.cond(backend="graph")``:
the loop captured once as a CUDA graph with a WHILE node and IF nodes
(``core.device_loop``), replayed with every decision on the device.

The file imports neither ``jax`` nor ``repro``. On the CPU it checks
what the graph lowering refuses (CPU tensors, grad mode, Python numbers
in the carry, a predicate that is not a CUDA tensor, ``cond`` outside a
capture) and the one-transfer host read; the tests marked ``cuda`` run
the lowering on the card and hold it to the host-read loop:

    python -m pytest --noconftest -m cuda tests/test_torch_device_loop.py

Tolerance: the graph replays the same kernels on the same operands as
the eager loop, but cuBLAS may pick another algorithm under capture, so
fp32 results are held to 1e-6 (about eight ulps at magnitude 1) rather
than bit for bit; integer results and trip counts exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch import core, kernels
from repro_torch.core import device_loop
from repro_torch.core.device_loop import DeviceLoop


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _nothing():
    pass


def _i32(v, device):
    return torch.full((), v, dtype=torch.int32, device=device)


# ------------------------------------------------------------------ CPU

def test_graph_loop_refuses_cpu_tensors():
    x = torch.zeros(3)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        core.while_loop(lambda c: c[0] < 3, lambda c: (c[0] + 1, c[1]),
                        (torch.zeros((), dtype=torch.int32), x),
                        impl="graph")


def test_graph_loop_refuses_grad_mode():
    with pytest.raises(RuntimeError, match="no_grad"):
        core.while_loop(lambda c: c < 3, lambda c: c + 1,
                        torch.zeros((), dtype=torch.int32), impl="graph")


@pytest.mark.parametrize("number", [0, 1.5, True])
def test_graph_loop_refuses_python_numbers_in_the_carry(number):
    with torch.no_grad(), pytest.raises(TypeError, match="Python number"):
        core.while_loop(lambda c: c[1] < 3, lambda c: c,
                        (number, torch.zeros(2)), impl="graph")


def test_graph_loop_refuses_tensor_arrays():
    ta = core.TensorArray.unstack(torch.ones(2, 3))
    with torch.no_grad(), pytest.raises(TypeError, match="device-indexed"):
        core.while_loop(lambda c: c[1] < 3, lambda c: c,
                        (ta, torch.zeros(())), impl="graph")


@pytest.mark.parametrize("pred", [True, torch.tensor(True)])
def test_graph_cond_refuses_predicates_off_the_card(pred):
    with pytest.raises(TypeError, match="CUDA tensor"):
        core.cond(pred, lambda: 1, lambda: 0, backend="graph")


def test_unknown_lowerings_are_refused():
    with pytest.raises(ValueError, match="impl"):
        core.while_loop(lambda c: False, lambda c: c, torch.zeros(()),
                        impl="eager")
    with pytest.raises(ValueError, match="backend"):
        core.cond(True, lambda: 1, lambda: 0, backend="while")


def test_host_loop_runs_the_prologue_once_before_the_predicate():
    seen = []

    def prologue(c):
        seen.append(int(c))
        c.zero_()

    out = core.while_loop(lambda c: c < 4, lambda c: c + 1,
                          torch.tensor(9), prologue=prologue)
    assert seen == [9] and int(out) == 4


def test_read_host_packs_mixed_tensors_into_one_read():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random(5) < 0.5)
    b = torch.from_numpy(rng.integers(-9, 9, (2, 3)).astype(np.int32))
    c = torch.tensor(7, dtype=torch.int32)
    d = torch.from_numpy(rng.integers(0, 2**40, (4,)))
    before = DeviceLoop.host_reads
    got = device_loop.read_host(a, b, c, d)
    assert DeviceLoop.host_reads == before + 1
    for want, have in zip((a, b, c, d), got):
        assert have.dtype == want.numpy().dtype
        np.testing.assert_array_equal(have, want.numpy())


def test_launches_count_on_the_device_only_under_capture():
    """An eager launch is counted by its wrapper in Python alone: the
    device counter moves only in a graph captured while it is armed."""
    counts = torch.zeros(2, dtype=torch.int64)
    with kernels.device_launch_counts(counts, ("a", "b")):
        kernels.count_launch("a")
        kernels.count_launch("c")
    kernels.count_launch("a")
    assert counts.tolist() == [0, 0]


# ----------------------------------------------------------------- card

def _mm_loop(device, n):
    """§6.1's loop: tanh(x @ w), x (8, 128), w (128, 128), fp32."""
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(128, 128, generator=gen) / 11.3).to(device)
    x0 = torch.randn(8, 128, generator=gen).to(device)
    return w, x0, (x0.clone(), _i32(0, device), _i32(n, device))


@pytest.mark.cuda
def test_graph_loop_equals_the_host_loop_and_replays(cuda_device):
    w, x0, carry = _mm_loop(cuda_device, 200)

    def cond_fn(c):
        return c[1] < c[2]

    def body_fn(c):
        return torch.tanh(c[0] @ w), c[1] + 1, c[2]

    host = core.while_loop(cond_fn, body_fn, (x0.clone(), _i32(0, cuda_device),
                                             _i32(200, cuda_device)))
    with torch.no_grad():
        body_fn(carry)                       # lazy init outside capture
        captures, replays = DeviceLoop.captures, DeviceLoop.replays
        reads = core.while_loop.host_reads
        out = core.while_loop(cond_fn, body_fn, carry, impl="graph")
        torch.cuda.synchronize()
        assert out is carry
        assert int(carry[1]) == 200
        torch.testing.assert_close(carry[0], host[0], rtol=0, atol=1e-6)
        # replay with other inputs: the same graph, another trip count
        for n in (37, 0, 1):
            carry[0].copy_(x0)
            carry[1].zero_()
            carry[2].fill_(n)
            core.while_loop(cond_fn, body_fn, carry, impl="graph")
            torch.cuda.synchronize()
            assert int(carry[1]) == n
            ref = x0
            for _ in range(n):
                ref = torch.tanh(ref @ w)
            torch.testing.assert_close(carry[0], ref, rtol=0, atol=1e-6)
        assert DeviceLoop.captures == captures + 1
        assert DeviceLoop.replays == replays + 4
        assert core.while_loop.host_reads == reads
        # other carry objects: captured anew
        other = (x0.clone(), _i32(0, cuda_device), _i32(3, cuda_device))
        core.while_loop(cond_fn, body_fn, other, impl="graph")
        assert DeviceLoop.captures == captures + 2
        assert int(other[1]) == 3
        device_loop.release(body_fn)


@pytest.mark.cuda
def test_vector_predicate_and_counted_loop_on_the_card(cuda_device):
    lim = torch.tensor([3, 7, 0, 5], dtype=torch.int32, device=cuda_device)
    ctr = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    steps = _i32(0, cuda_device)

    def cond_fn(c):
        return c[0] < lim                        # alive while any holds

    def body_fn(c):
        return torch.minimum(c[0] + 1, lim), c[1] + 1

    with torch.no_grad():
        core.while_loop(cond_fn, body_fn, (ctr, steps), impl="graph")
        assert ctr.tolist() == [3, 7, 0, 5] and int(steps) == 7
        ctr.zero_()
        steps.zero_()
        core.while_loop(cond_fn, body_fn, (ctr, steps), impl="graph",
                        max_iters=4)
        assert ctr.tolist() == [3, 4, 0, 4] and int(steps) == 4
        steps.zero_()
        core.while_loop(None, lambda c: c + 1, steps, impl="graph",
                        max_iters=6)
        assert int(steps) == 6
    device_loop.release(body_fn)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 3, 4, 10])
def test_parallel_iterations_unrolls_the_while_node(cuda_device, window):
    """A counted loop of 10 with ``parallel_iterations=window``: its
    WHILE node takes 10 // window iterations, each running ``window``
    bodies, a remainder step after it runs the other 10 % window, and
    the carry comes out bit for bit as with window 1."""
    n = 10
    w, x1 = _mm_loop(cuda_device, n)[:2]
    with torch.no_grad():
        torch.tanh(x1 @ w)                   # lazy init outside capture
    outs = {}
    for par in (1, window):
        x = x1.clone()
        k = _i32(0, cuda_device)

        def body(c):
            return torch.tanh(c[0] @ w), c[1] + 1

        with torch.no_grad():
            core.while_loop(None, body, (x, k), max_iters=n, impl="graph",
                            parallel_iterations=par)
            loop = core.while_loop.last_loop
            outs[par] = (x.clone(), int(k), loop.iterations(),
                         loop.remainder)
        device_loop.release(body)
    assert outs[window][1] == outs[1][1] == n
    assert outs[window][2] == -(-n // window) and outs[1][2] == n
    assert outs[window][3] == n % window and outs[1][3] == 0
    assert torch.equal(outs[window][0], outs[1][0])


@pytest.mark.cuda
def test_graph_cond_runs_exactly_one_branch(cuda_device):
    """In-place branches, branches that return new tensors, a nested
    cond, and a branch that allocates and copies."""
    i = _i32(0, cuda_device)
    n = _i32(30, cuda_device)
    hits = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    acc = torch.zeros((), device=cuda_device)

    def body_fn(c):
        i, n, hits, acc = c

        def count(k):
            def run():
                hits[k] += 1
            return run

        def every_third():
            count(0)()
            core.cond(i % 2 == 0, count(2), _nothing, backend="graph")

        core.cond(i % 3 == 0, every_third, _nothing, backend="graph")
        v = core.cond(i < 10, lambda: acc + 1.0, lambda: acc * 2.0,
                      backend="graph")
        core.cond(i >= 20, count(1), _nothing, backend="graph")
        return i + 1, n, hits, v

    with torch.no_grad():
        core.while_loop(lambda c: c[0] < c[1], body_fn, (i, n, hits, acc),
                        impl="graph")
    ref_acc = 0.0
    for k in range(30):
        ref_acc = ref_acc + 1.0 if k < 10 else ref_acc * 2.0
    assert int(i) == 30
    assert hits.tolist() == [10, 10, 5]     # k % 3 == 0; k >= 20; k % 6 == 0
    assert float(acc) == ref_acc
    with pytest.raises(RuntimeError, match="captures"):
        core.cond(i > 0, lambda: 1, lambda: 0, backend="graph")
    device_loop.release(body_fn)


@pytest.mark.cuda
def test_graph_loop_refusals_on_the_card(cuda_device):
    x = torch.zeros(2, device=cuda_device, requires_grad=True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="requires grad"):
        core.while_loop(lambda c: c[0] < 1, lambda c: c,
                        (_i32(0, cuda_device), x), impl="graph")
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA tensor"):
        core.while_loop(lambda c: True, lambda c: c,
                        _i32(0, cuda_device), impl="graph")
    with torch.no_grad(), pytest.raises(TypeError, match="Python number"):
        core.while_loop(lambda c: c[1] < 3, lambda c: c,
                        (3, _i32(0, cuda_device)), impl="graph")


@pytest.mark.cuda
def test_captured_launches_count_on_the_device_at_each_replay(cuda_device):
    counts = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    x = torch.zeros(4, device=cuda_device)
    g = torch.cuda.CUDAGraph()
    with kernels.device_launch_counts(counts, ("a", "b")):
        kernels.count_launch("b")      # eager: not on the device
        with torch.cuda.graph(g):
            x.add_(1)
            kernels.count_launch("b")
            kernels.count_launch("b")
            kernels.count_launch("c")  # not armed for it
    torch.cuda.synchronize()
    assert counts.tolist() == [0, 0]   # capturing launches nothing
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert counts.tolist() == [0, 6] and x.tolist() == [3.0] * 4


@pytest.mark.cuda
def test_graph_loop_cache_holds_its_functions_weakly(cuda_device):
    """The loop ``while_loop(impl="graph")`` keeps for a body goes, its
    graphs freed, when the body is collected; while the body lives it is
    replayed."""
    import gc
    c = _i32(0, cuda_device)

    def cond_fn(x):
        return x < 5

    def make_body():
        def body_fn(x):
            return x + 1
        return body_fn

    body = make_body()
    with torch.no_grad():
        captures = DeviceLoop.captures
        for _ in range(2):
            c.zero_()
            core.while_loop(cond_fn, body, c, impl="graph")
        assert int(c) == 5 and DeviceLoop.captures == captures + 1
        held = len(device_loop._CACHE)
        del body
        gc.collect()
        assert len(device_loop._CACHE) == held - 1
