"""The graph lowering of ``dynamic_rnn`` and of §5.1's gradient loop
(``core.device_grad``), run through its step-by-step driver
(``device_grad.plain_driver``): the same forward and gradient bodies,
contiguous stacks and one-row duals that the card replays as two WHILE
nodes, on the CPU.

- gradients of ``dynamic_rnn(impl="graph")`` under ``carry`` and
  ``carry_offload``, with and without lengths, against ``jax.grad`` of
  the JAX package's ``dynamic_rnn`` (rtol 1e-4, atol 1e-6, as
  ``test_torch_rnn.py``) and against the port's tape lowering
  (``impl="host"``: rtol 1e-6, atol 1e-7; the same ops on the same
  values, summed in the same order);
- the forward without grad against the host lowering, bit for bit;
- one loop per program, reused by later calls with new weights;
- a captured input array's gradient (the dual ``index_add_``), the
  double-write counter, the stacks, and the refusals (a tensor the body
  reaches outside the carry and its constants, CPU tensors without the
  plain driver, reads of a carry array under grad); ``all`` and
  ``offload``, refused until the residual stacks came, run
  (``test_torch_graph_residuals.py`` holds their parity cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rnn as jrnn
from repro_torch import bridge, core
from repro_torch.core import device_grad
from repro_torch.core.stacks import CarryStack
from repro_torch.examples import dynamic_rnn_nmt as nmt
from repro_torch.models import rnn

POLICIES = ["carry", "carry_offload"]
B, S, D, H = 3, 9, 4, 8
LENS = np.array([4, 9, 6], np.int32)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _case(seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jrnn.lstm_init(jax.random.PRNGKey(seed),
                                                D, H))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


def _port_grads(p, x, lens, policy, impl):
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    for t in tp.values():
        t.requires_grad_()
    tx = torch.tensor(x, requires_grad=True)
    tl = None if lens is None else torch.tensor(lens)
    out, (c, h) = rnn.dynamic_rnn(tp, tx, tl, hidden=H, save_policy=policy,
                                  impl=impl)
    loss = (out ** 2).mean() + (c * h).sum()
    return (loss, out) + torch.autograd.grad(loss, [tp["w"], tp["b"], tx])


@pytest.fixture(autouse=True)
def _fresh_loops():
    device_grad.release()
    yield
    device_grad.release()


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_graph_grads_match_jax(policy, with_lens):
    p, x = _case()
    lens = LENS if with_lens else None

    def jloss(p, x):
        out, (c, h) = jrnn.dynamic_rnn(
            p, x, None if lens is None else jnp.asarray(lens), hidden=H,
            save_policy=policy)
        return (out ** 2).mean() + (c * h).sum()

    jp = jax.tree.map(jnp.asarray, p)
    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    with device_grad.plain_driver():
        loss, _, gw, gb, gx = _port_grads(p, x, lens, policy, "graph")
    np.testing.assert_allclose(_np(loss), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((gw, jgp["w"]), (gb, jgp["b"]), (gx, jgx)):
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_graph_grads_match_the_tape_lowering(policy, with_lens):
    p, x = _case(1)
    lens = LENS if with_lens else None
    ref = _port_grads(p, x, lens, policy, "host")
    with device_grad.plain_driver():
        ours = _port_grads(p, x, lens, policy, "graph")
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    if with_lens:
        assert torch.count_nonzero(ours[1][0, LENS[0]:]) == 0


@pytest.mark.parametrize("with_lens", [False, True])
def test_graph_forward_equals_host_forward(with_lens):
    p, x = _case(2)
    tp = bridge.lstm_params_from_numpy(p, "cpu")
    tl = torch.tensor(LENS) if with_lens else None
    with torch.no_grad():
        ref = rnn.dynamic_rnn(tp, torch.tensor(x), tl, hidden=H)
        with device_grad.plain_driver():
            ours = rnn.dynamic_rnn(tp, torch.tensor(x), tl, hidden=H,
                                   impl="graph")
    loop = core.while_loop.last_grad_loop
    assert loop.stacks == [] and loop.iterations() == S
    for a, b in zip(pytree_leaves(ours), pytree_leaves(ref)):
        assert torch.equal(a, b)


def pytree_leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def test_later_calls_reuse_the_loop_with_new_weights():
    """Three same-shape calls with new weights, inputs and lengths: one
    loop, its static buffers reloaded each time; every call's
    gradients equal the tape lowering's."""
    with device_grad.plain_driver():
        for seed in range(3):
            p, x = _case(seed)
            lens = np.roll(LENS, seed)
            ours = _port_grads(p, x, lens, "carry", "graph")
            ref = _port_grads(p, x, lens, "carry", "host")
            for a, b in zip(ours, ref):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-7)
    assert [len(v) for v in device_grad._CACHE.values()] == [1]


def test_a_loop_waiting_for_its_backward_is_not_reused():
    """Two forwards of one program before either backward (two layers
    of one width): the second takes a second loop, and both gradients
    are right."""
    p, x = _case(3)
    params = [bridge.lstm_params_from_numpy(p, "cpu") for _ in range(2)]
    leaves = [t.requires_grad_() for q in params for t in q.values()]
    tx = torch.tensor(x, requires_grad=True)
    leaves.append(tx)
    proj = torch.eye(H)[:D]                   # H -> D, so layer 2 == layer 1

    def loss_of(impl):
        y1, _ = rnn.dynamic_rnn(params[0], tx, hidden=H,
                                save_policy="carry", impl=impl)
        y2, _ = rnn.dynamic_rnn(params[1], y1 @ proj.T, hidden=H,
                                save_policy="carry", impl=impl)
        return (y2 ** 2).sum()

    ref = torch.autograd.grad(loss_of("host"), leaves)
    with device_grad.plain_driver():
        ours = torch.autograd.grad(loss_of("graph"), leaves)
    assert [len(v) for v in device_grad._CACHE.values()] == [2]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_captured_input_array_gets_its_gradient():
    """A body that reads rows of a captured array (some twice, one never)
    and scales them by a captured weight: the array's source gets
    ``w`` summed over its reads, the weight the sum of the rows read."""
    src = torch.arange(12.0).reshape(6, 2).requires_grad_()
    w = torch.tensor([2.0, -1.0], requires_grad=True)
    ta = core.DeviceTensorArray.unstack(src * 1.0)
    order = torch.tensor([0, 3, 3, 5, 1])

    def body(s):
        t, acc = s
        return (t + 1, acc + ta.read(order[t]) * w)

    init = (torch.zeros((), dtype=torch.long), torch.zeros(2))
    with device_grad.plain_driver():
        _, acc = core.while_loop(lambda s: s[0] < 5, body, init,
                                 max_iters=6, save_policy="carry",
                                 impl="graph")
    g_src, g_w = torch.autograd.grad(acc.sum(), [src, w])
    reads = torch.tensor([1.0, 1, 0, 2, 0, 1])[:, None]
    assert torch.equal(g_src, reads * w.detach())
    assert torch.equal(g_w, (reads * src.detach()).sum(0))


def test_written_rows_pass_no_gradient_to_the_initial_array():
    """The carry array's initial buffer gets the output's cotangent on
    the rows the loop did not write and zero on those it did (the dual
    of ``write``, as ``dynamic_update_index_in_dim`` transposes); each
    written value gets its row's cotangent."""
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
                                 max_iters=4, save_policy="carry",
                                 impl="graph")
    weights = torch.arange(8.0).reshape(4, 2)
    g_base, g_x = torch.autograd.grad((out.stack() * weights).sum(),
                                      [base, x])
    assert torch.equal(g_base[:3], torch.zeros(3, 2))
    assert torch.equal(g_base[3], weights[3])
    assert torch.equal(g_x, (weights[:3] * torch.tensor([[1.0], [2], [3]])
                             ).sum(0))


def test_double_writes_are_counted_on_the_device():
    """Under a loop driver a double write adds to the array's device
    counter, read once after the loop; eagerly it raises at once."""
    out = core.DeviceTensorArray.create(4, (2,))

    def body(s):
        t, ta = s
        return (t + 1, ta.write(torch.zeros((), dtype=torch.long),
                                torch.ones(2)))

    init = (torch.zeros((), dtype=torch.long), out)
    with torch.no_grad(), device_grad.plain_driver(), pytest.raises(
            core.WriteOnceError, match="3 TensorArray write"):
        core.while_loop(None, body, init, max_iters=4, impl="graph")
    ta = core.DeviceTensorArray.create(2, (1,))
    ta.write(torch.tensor(1), torch.ones(1))
    with pytest.raises(core.WriteOnceError, match="location 1"):
        ta.write(1, torch.ones(1))
    assert int(ta.double_writes) == 0


@pytest.mark.parametrize("offload", [False, True])
def test_carry_stack_pushes_and_pops_rows_at_a_device_index(offload):
    like = torch.zeros(2, 3)
    st = CarryStack(like, 5, offload)
    for k in range(5):
        st.push(torch.tensor(k), torch.full((2, 3), float(k)))
    assert [float(st.pop(torch.tensor(k))[1, 2]) for k in (4, 0, 2)] == \
        [4.0, 0.0, 2.0]
    assert st.host_bytes == (5 * 24 if offload else 0)


def test_graph_grad_refusals():
    p, x = _case()
    # all and offload, once refused here, now run (their parity cases:
    # test_torch_graph_residuals.py)
    for policy in ("all", "offload"):
        ref = _port_grads(p, x, LENS, policy, "host")
        with device_grad.plain_driver():
            ours = _port_grads(p, x, LENS, policy, "graph")
        assert core.while_loop.last_grad_loop.residual_bytes > 0
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    # CPU tensors without the plain driver
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port_grads(p, x, LENS, "carry", "graph")

    class Holder:
        pass

    holder = Holder()
    holder.w = torch.ones(3, requires_grad=True)
    holder.v = holder.w * 2.0          # a result computed before the loop
    x0 = torch.zeros(3, requires_grad=True)
    init = (torch.zeros((), dtype=torch.long), x0)
    for attr, msg in (("w", r"\(3,\) torch.float32 tensor"),
                      ("v", "MulBackward0, a result computed before")):
        def body(s, attr=attr):
            return (s[0] + 1, s[1] * getattr(holder, attr))
        with device_grad.plain_driver(), pytest.raises(ValueError,
                                                       match=msg):
            core.while_loop(lambda s: s[0] < 2, body, init, max_iters=3,
                            save_policy="carry", impl="graph")

    ta = core.DeviceTensorArray.create(3, (3,))
    init = (torch.zeros((), dtype=torch.long), x0, ta)

    def reads_its_carry(s):
        t, v, arr = s
        return (t + 1, v + arr.read(t), arr.write(t, v))
    with device_grad.plain_driver(), pytest.raises(NotImplementedError,
                                                   match="carry"):
        core.while_loop(lambda s: s[0] < 2, reads_its_carry, init,
                        max_iters=3, save_policy="carry", impl="graph")


def test_nmt_step_under_the_graph_lowering_equals_the_host_step():
    """One training step of the NMT example: both RNNs under the graph
    lowering (its default policy, ``all``), through the plain driver,
    give the host lowering's loss and updated parameters."""
    gen = torch.Generator().manual_seed(0)
    params = nmt.init(gen)
    src, lens, tgt = nmt.batch(gen)
    cfg = nmt.adamw.AdamWConfig(lr=nmt.LR, weight_decay=0.0)
    ref = nmt.train_step(cfg, params, nmt.adamw.init(params), src, lens,
                         tgt, impl="host")
    with device_grad.plain_driver():
        ours = nmt.train_step(cfg, params, nmt.adamw.init(params), src,
                              lens, tgt, impl="graph")
    np.testing.assert_allclose(_np(ours[2]), _np(ref[2]), rtol=1e-6)
    for a, b in zip(pytree_leaves(ours[0]), pytree_leaves(ref[0])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
