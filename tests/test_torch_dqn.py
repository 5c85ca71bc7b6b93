"""The paper's §6.5 DQN in the port against the JAX package's
(``benchmarks/bench_dqn.py``), and the PRNG functions it needs.

Tolerances:
- ``prng.split`` and ``prng.randint`` (with a tensor ``maxval``): bit
  for bit against ``jax.random`` (integer hashes and uint32 modular
  arithmetic);
- ``prng.normal``: XLA's ``erf_inv`` polynomial in float32, its Horner
  steps fused as XLA fuses them, but ``log1p`` and ``sqrt`` are
  PyTorch's: within 4 float32 ulps of JAX's draw (3 seen on 10^6 draws,
  99% equal), i.e. ``|port - jax| <= 4 * spacing(|jax|)``;
- one agent step from the same carry, under each of the 2 x 2 x 2
  combinations of its conditionals: the key, ``t`` and the actions
  exactly, every float within 1e-6 of its leaf's magnitude (fp32: the
  analytic gradient against ``jax.grad``, sums in another order);
- 200 steps: identical actions, the return within 1e-4 relative (the
  parameters drift apart by at most about 1e-5 of their magnitude; no
  near-tie flipped an action at seeds 0-3).

The tests marked ``cuda`` hold the graph lowering (one WHILE-node launch
for 200 steps, IF nodes for the conditionals) to the eager one on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_dqn.py

JAX is imported only inside the tests that hold the port to it.
"""

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.examples import dqn_in_graph as dqn
from repro_torch.serve import prng

SEEDS = (0, 1, 7, 123, 2**31 - 1)
STEP_RTOL = 1e-6
RET_RTOL = 1e-4


def _jax():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import jax
    from benchmarks import bench_dqn
    return jax, bench_dqn


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _to_port(c):
    return {k: _to_port(v) if isinstance(v, dict) else _t(v)
            for k, v in c.items()}


def _to_jax(c):
    import jax.numpy as jnp
    out = {}
    for k, v in c.items():
        if isinstance(v, dict):
            out[k] = _to_jax(v)
        elif k == "key":
            out[k] = jnp.asarray(v.numpy().astype(np.uint32))
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


# ------------------------------------------------------------- prng

@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed):
    jax, _ = _jax()
    k = jax.random.PRNGKey(seed)
    for num in (2, 4, 7):
        np.testing.assert_array_equal(
            prng.split(_t(k), num).numpy(),
            np.asarray(jax.random.split(k, num)).astype(np.int64))
    # a batch of keys splits row by row
    ks = jax.random.split(k, 3)
    got = prng.split(_t(ks), 4).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.split(ks[i], 4)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed):
    jax, _ = _jax()
    k = jax.random.PRNGKey(seed)
    for lo, hi, shape in ((0, 4, ()), (0, 1, (32,)), (0, 33, (32,)),
                          (0, 256, (32,)), (-5, 9, (3, 4)), (3, 3, (5,)),
                          (0, 2**20 + 3, (64,)), (7, 2**31 - 1, (16,))):
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        np.testing.assert_array_equal(
            prng.randint(_t(k), shape, lo, hi).numpy(), want)
        # the bound as a tensor (the DQN's min(t + 1, BUF) lives on the
        # device)
        np.testing.assert_array_equal(
            prng.randint(_t(k), shape, lo,
                         torch.tensor(hi, dtype=torch.int32)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_four_ulps_of_jax(seed):
    jax, _ = _jax()
    k = jax.random.PRNGKey(seed)
    for shape in ((), (8,), (8, 64), (200_000,)):
        want = np.asarray(jax.random.normal(k, shape), np.float32)
        got = prng.normal(_t(k), shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_less(
            np.abs(got - want), 4 * np.spacing(np.abs(want)) + 1e-45)


# ------------------------------------------------------------- the agent

def test_carry0_equals_jax():
    jax, bench = _jax()
    want = _to_port(bench._carry0(jax.random.PRNGKey(0)))
    got = dqn.carry0(prng.prng_key(0))
    assert dqn.same_carry(got, want, 1e-6) is None


def _explores(key: torch.Tensor) -> bool:
    k_eps = prng.split(key, 4)[1]
    return bool(prng.uniform(k_eps) < dqn.EPSILON)


def _carry(t, explore, seed=0):
    """A carry with ``t`` interactions behind it: buffers and parameters
    drawn with numpy, and a key (the first from seed upward) that takes
    the explore branch or not."""
    rng = np.random.default_rng(seed)
    c = dqn.carry0(prng.prng_key(seed))
    for name in ("w1", "w2"):
        c["target"][name] = torch.from_numpy(
            rng.normal(0, 0.3, c["target"][name].shape).astype(np.float32))
    c["obs"] = torch.from_numpy(rng.normal(0, 0.5, dqn.OBS).astype(
        np.float32))
    n = min(t, dqn.BUF)
    c["buf_obs"][:n] = torch.from_numpy(rng.normal(0, 0.5, (n, dqn.OBS))
                                        .astype(np.float32))
    c["buf_next"][:n] = torch.from_numpy(rng.normal(0, 0.5, (n, dqn.OBS))
                                         .astype(np.float32))
    c["buf_rew"][:n] = torch.from_numpy(-rng.random(n).astype(np.float32))
    c["buf_act"][:n] = torch.from_numpy(rng.integers(0, dqn.ACT, n)
                                        .astype(np.int32))
    c["t"].fill_(t)
    s = seed
    while _explores(prng.prng_key(s)) != explore:
        s += 1
    c["key"] = prng.prng_key(s)
    return c


# (explore, train, refresh) -> (t, TARGET_EVERY): training starts at
# t >= BATCH = 32 and the refresh fires at t % TARGET_EVERY ==
# TARGET_EVERY - 1, so "refresh without training" needs a period below
# 32 (both packages patched alike)
CASES = {(e, tr, rf): ({(False, False): 5, (True, False): 40,
                        (True, True): 49, (False, True): 10}[tr, rf],
                       11 if (rf and not tr) else 50)
         for e in (False, True) for tr in (False, True)
         for rf in (False, True)}


@pytest.mark.parametrize("branches", sorted(CASES),
                         ids=lambda b: "explore%d-train%d-refresh%d" % b)
def test_one_step_equals_jax_under_each_branch(branches, monkeypatch):
    jax, bench = _jax()
    explore, train, refresh = branches
    t, every = CASES[branches]
    monkeypatch.setattr(bench, "TARGET_EVERY", every)
    monkeypatch.setattr(dqn, "TARGET_EVERY", every)
    c = _carry(t, explore)
    assert (t >= dqn.BATCH) == train and \
        (t % every == every - 1) == refresh
    got = dqn.agent_step(dqn.clone(c))
    want = _to_port(bench._agent_step(_to_jax(c)))
    assert dqn.same_carry(got, want, STEP_RTOL) is None, \
        dqn.same_carry(got, want, STEP_RTOL)
    moved = not torch.equal(got["params"]["w1"], c["params"]["w1"])
    assert moved == train
    assert torch.equal(got["target"]["w1"],
                       got["params"]["w1"] if refresh
                       else c["target"]["w1"])


def test_two_hundred_steps_equal_jax():
    jax, bench = _jax()
    step = jax.jit(bench._agent_step)
    jc = bench._carry0(jax.random.PRNGKey(0))
    c = dqn.carry0(prng.prng_key(0))
    for _ in range(dqn.STEPS):
        jc = step(jc)
        c = dqn.agent_step(c)
    want = _to_port(jc)
    np.testing.assert_array_equal(c["buf_act"].numpy(),
                                  want["buf_act"].numpy())
    assert int(c["t"]) == dqn.STEPS
    np.testing.assert_allclose(float(c["ret"]), float(want["ret"]),
                               rtol=RET_RTOL)
    assert dqn.same_carry(c, want, 1e-4) is None


def _graph_like_cond(pred, true_fn, false_fn, *operands, backend):
    """``cond(backend="graph")``'s semantics on the CPU: the true
    branch's outputs are the result's storage, and when the predicate
    fails the false branch's outputs are copied into them (refusing a
    true output that is an operand)."""
    t_out = true_fn(*operands)
    if bool(pred):
        return t_out
    f_out = false_fn(*operands)
    ops = [x for x in torch.utils._pytree.tree_leaves(operands)]
    for a, b in zip(torch.utils._pytree.tree_leaves(t_out),
                    torch.utils._pytree.tree_leaves(f_out)):
        if a is b:
            continue
        assert not any(a is o for o in ops)
        a.copy_(b)
    return t_out


def test_parameters_survive_a_step_that_does_not_refresh(monkeypatch):
    """Under the graph lowering the untaken branch's result is copied
    into the taken one's outputs: the target refresh's true branch
    returns a clone, so a step that trains and does not refresh keeps
    its new parameters (not the old target's)."""
    c = _carry(40, explore=False)
    want = dqn.agent_step(dqn.clone(c), "native")
    monkeypatch.setattr(dqn, "_cond", _graph_like_cond)
    got = dqn.agent_step(dqn.clone(c), "graph")
    assert dqn.same_carry(got, want, 0.0) is None
    assert not torch.equal(got["params"]["w1"], got["target"]["w1"])


def test_native_conditionals_read_three_predicates_a_step():
    c = dqn.carry0(prng.prng_key(0))
    before = dqn.host_reads
    for _ in range(3):
        c = dqn.agent_step(c, "native")
    assert dqn.host_reads - before == 9


def test_host_loop_equals_python_loop():
    c0 = dqn.carry0(prng.prng_key(2))
    c = c0
    for _ in range(40):
        c = dqn.agent_step(c)
    reads = core.while_loop.host_reads
    got = dqn.run_host(c0, 40)
    assert core.while_loop.host_reads - reads == 41
    assert dqn.same_carry(got, c, 0.0) is None


def test_main_on_cpu_improves_the_return(capsys):
    out = dqn.main(["--device", "cpu"])
    assert out["post"] > out["pre"] and out["t"] == dqn.TRAIN_STEPS
    assert "while_loop(impl='host')" in capsys.readouterr().out


def test_agent_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        dqn.Agent(dqn.carry0(prng.prng_key(0)))


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_lowering_equals_eager_on_card(cuda_device):
    """200 steps in one WHILE-node launch, no host read, against the
    eager step from the same carry; and one captured step at a time."""
    from repro_torch.core import device_loop
    c0 = dqn.carry0(prng.prng_key(0, cuda_device))
    agent = dqn.Agent(c0)
    try:
        replays = device_loop.DeviceLoop.replays
        reads = dqn.host_reads + device_loop.DeviceLoop.host_reads
        agent.load(c0)
        agent.run(dqn.STEPS)
        graph = agent.carry()
        assert device_loop.DeviceLoop.replays - replays == 1
        assert dqn.host_reads + device_loop.DeviceLoop.host_reads == reads
        c = c0
        with torch.no_grad():
            for _ in range(dqn.STEPS):
                c = dqn.agent_step(c, "native")
        assert dqn.same_carry(graph, c, 1e-5) is None
        agent.load(c0)
        for _ in range(dqn.STEPS):
            agent.step()
        assert dqn.same_carry(agent.carry(), c, 1e-5) is None
        # 41 steps: the last trains and does not refresh, and keeps its
        # parameters
        agent.load(c0)
        agent.run(41)
        assert not torch.equal(agent.state["params"]["w1"],
                               agent.state["target"]["w1"])
    finally:
        agent.close()
