"""In-graph Deep Q-Network (paper §6.5, Fig. 16), the JAX package's
``examples/dqn_in_graph.py`` with the agent of its
``benchmarks/bench_dqn.py``: environment steps, conditional replay
writes, conditional Q-learning and the target refresh all inside one
``core.while_loop``, so the agent trains without Python in the loop.

    PYTHONPATH=src python -m repro_torch.examples.dqn_in_graph
    PYTHONPATH=src python -m repro_torch.examples.dqn_in_graph --device cpu

The step (``agent_step``) takes the lowering of its three conditionals
(explore/exploit, train once the buffer holds a batch, refresh the
target every ``TARGET_EVERY`` steps) as an argument:

- ``"graph"``: ``cond(backend="graph")``, IF nodes inside the CUDA graph
  that ``while_loop(impl="graph")`` captures (``Agent``): 200 steps are
  one WHILE-node launch and no host read;
- ``"native"``: ``cond(backend="native")``, each predicate read on the
  host (three reads a step, counted in ``host_reads``); the lowering on
  the CPU, under ``while_loop(impl="host")``.

The step is functional (it returns a new carry), as the JAX step is.
Replay writes go to the device slot ``t % BUF`` by ``index_copy``, and
the batch indices are drawn below ``min(t + 1, BUF)`` by
``prng.randint`` with that bound as a device tensor: nothing is read.
The Q-update's gradient is the analytic gradient of the two-layer tanh
MLP (the target network is a constant, as under ``jax.grad``), written
with JAX's own derivative of ``tanh``, so that it can run inside a
captured body, where autograd records nothing. The target refresh's
taken branch returns a clone of the new parameters: under the graph
lowering the untaken branch's result is copied into the taken one's
outputs, and returning the parameters themselves would let the old
target overwrite them on every step that does not refresh.

``main`` runs the reference's script: 200 steps of the untrained agent,
2000 training steps as one call, then 200 steps from a fresh
environment, and asserts that the return improved. As in the reference,
those last 200 steps keep the epsilon-greedy draw and go on training.
``dqn_rows`` times the paper's comparison on the card (the counterpart
of ``bench_dqn.rows``).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from .. import core, resolve_device
from ..core import device_loop
from ..serve import prng

OBS, ACT, HID = 8, 4, 64
BUF = 256
BATCH = 32
TARGET_EVERY = 50
STEPS = 200
LR = 1e-3
GAMMA = 0.97
EPSILON = 0.1
TRAIN_STEPS = 2000        # main's training call, and the loops' bound
PROFILED_STEPS = 10       # dqn_rows counts kernel launches over these

# predicate reads made by ``cond(backend="native")`` in ``agent_step``
host_reads = 0


def _cond(pred, true_fn: Callable, false_fn: Callable, *operands,
          backend: str):
    global host_reads
    if backend == "native":
        host_reads += 1
    return core.cond(pred, true_fn, false_fn, *operands, backend=backend)


def mlp_init(key: torch.Tensor) -> Dict[str, torch.Tensor]:
    k1, k2 = prng.split(key, 2).unbind(-2)
    return {"w1": prng.normal(k1, (OBS, HID)) * 0.3,
            "w2": prng.normal(k2, (HID, ACT)) * 0.3}


def q_values(params, obs: torch.Tensor) -> torch.Tensor:
    return torch.tanh(obs @ params["w1"]) @ params["w2"]


def env_step(x: torch.Tensor, key: torch.Tensor, action: torch.Tensor):
    """Synthetic linear dynamics; the reward peaks when x tracks 0.
    Returns (x', key', reward)."""
    key, sub = prng.split(key, 2).unbind(-2)
    push = (action.float() / (ACT - 1) - 0.5) * 0.2
    x = x * 0.98 + push + 0.01 * prng.normal(sub, (OBS,))
    return x, key, -(x ** 2).sum()


def q_update(params, target, obs, act, rew, nxt):
    """One SGD step on the mean squared TD error, the target network
    held constant: ``params - LR * grad``, the gradient written out."""
    h = torch.tanh(obs @ params["w1"])
    q = h @ params["w2"]
    qa = q.gather(1, act.long()[:, None])[:, 0]
    tq = (torch.tanh(nxt @ target["w1"]) @ target["w2"]).amax(-1)
    td = rew + GAMMA * tq - qa
    g_qa = -(2.0 * td * (1.0 / obs.shape[0]))
    g_q = torch.zeros_like(q).scatter_(1, act.long()[:, None], g_qa[:, None])
    g_w2 = h.T @ g_q
    g_h = g_q @ params["w2"].T
    g_z = (g_h + g_h * h) * (1.0 - h)      # JAX's d tanh: (g + g y)(1 - y)
    g_w1 = obs.T @ g_z
    return {"w1": params["w1"] - LR * g_w1, "w2": params["w2"] - LR * g_w2}


def carry0(key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The initial carry on ``key``'s device (``bench_dqn._carry0``)."""
    dev = key.device
    params = mlp_init(key)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "params": params,
        "target": {k: v.clone() for k, v in params.items()},
        "obs": zeros(OBS),
        "key": key.clone(),
        "t": zeros(dtype=torch.int32),
        "buf_obs": zeros(BUF, OBS),
        "buf_act": zeros(BUF, dtype=torch.int32),
        "buf_rew": zeros(BUF),
        "buf_next": zeros(BUF, OBS),
        "ret": zeros(),
    }


def agent_step(c: Dict, backend: str = "native") -> Dict:
    """One agent-environment interaction (``bench_dqn._agent_step``);
    ``backend`` lowers the three conditionals (module docstring)."""
    key, k_eps, k_act, k_samp = prng.split(c["key"], 4).unbind(0)
    # explore/exploit (§2.2 reinforcement-learning usage)
    explore = prng.uniform(k_eps) < EPSILON
    action = _cond(explore,
                   lambda: prng.randint(k_act, (), 0, ACT).int(),
                   lambda: torch.argmax(q_values(c["params"], c["obs"])
                                        ).int(),
                   backend=backend)
    x2, key, reward = env_step(c["obs"], key, action)
    # the replay write at the device slot t % BUF (circular)
    slot = (c["t"] % BUF).long().reshape(1)
    buf_obs = c["buf_obs"].index_copy(0, slot, c["obs"][None])
    buf_act = c["buf_act"].index_copy(0, slot, action.reshape(1))
    buf_rew = c["buf_rew"].index_copy(0, slot, reward.reshape(1))
    buf_next = c["buf_next"].index_copy(0, slot, x2[None])

    def do_train(params):
        idx = prng.randint(k_samp, (BATCH,), 0,
                           torch.clamp_max(c["t"] + 1, BUF)).long()
        return q_update(params, c["target"], buf_obs[idx], buf_act[idx],
                        buf_rew[idx], buf_next[idx])

    # Q-learning once the buffer holds a batch
    params = _cond(c["t"] >= BATCH, do_train, lambda p: p, c["params"],
                   backend=backend)
    # the target refresh (a clone: see the module docstring)
    target = _cond(c["t"] % TARGET_EVERY == TARGET_EVERY - 1,
                   lambda: {k: v.clone() for k, v in params.items()},
                   lambda: c["target"], backend=backend)
    return {"params": params, "target": target, "obs": x2, "key": key,
            "t": c["t"] + 1, "buf_obs": buf_obs, "buf_act": buf_act,
            "buf_rew": buf_rew, "buf_next": buf_next,
            "ret": c["ret"] + reward}


def clone(c):
    return pytree.tree_map(torch.clone, c)


def run_host(carry: Dict, n: int) -> Dict:
    """``while t < n: agent_step`` eagerly (``impl="host"``, native
    conditionals): the loop's predicate is read too."""
    with torch.no_grad():
        return core.while_loop(lambda c: c["t"] < n,
                               lambda c: agent_step(c, "native"), carry,
                               max_iters=TRAIN_STEPS)


class Agent:
    """The carry at fixed device addresses and its two captured loops
    (``while_loop(impl="graph")``, graph conditionals):

    - ``run(n)``: ``while t < n: agent_step``, one WHILE-node launch;
    - ``step()``: one step, the step captured once and replayed (a
      WHILE node of one trip): one launch a step, no host read.

    ``load`` copies a carry in, ``carry()`` a clone out."""

    def __init__(self, carry: Dict):
        if carry["t"].device.type != "cuda":
            raise ValueError("Agent runs on the card; on the CPU use "
                             "run_host")
        self.state = clone(carry)
        self.limit = torch.zeros((), dtype=torch.int32,
                                 device=carry["t"].device)
        with torch.no_grad():
            # lazy initialisation before capture: every branch runs
            agent_step(self.state, "select")
            torch.cuda.synchronize()

    def _pred(self, c):
        return c["t"] < self.limit

    def _body(self, c):
        return agent_step(c, "graph")

    def load(self, carry: Dict) -> None:
        for dst, src in zip(pytree.tree_leaves(self.state),
                            pytree.tree_leaves(carry)):
            dst.copy_(src)

    def carry(self) -> Dict:
        return clone(self.state)

    def run(self, n: int) -> None:
        self.limit.fill_(n)
        with torch.no_grad():
            core.while_loop(self._pred, self._body, self.state,
                            max_iters=TRAIN_STEPS, impl="graph")

    def step(self) -> None:
        with torch.no_grad():
            core.while_loop(None, self._body, self.state, max_iters=1,
                            impl="graph")

    def close(self) -> None:
        device_loop.release(self._body)


def same_carry(a: Dict, b: Dict, rtol: float) -> Optional[str]:
    """None when the carries agree: integers (the key, ``t``, the
    actions in the buffer) exactly, floats within ``rtol`` of the
    larger magnitude of each leaf; else what differs."""
    def flat(c):
        return {pytree.keystr(p): x
                for p, x in pytree.tree_flatten_with_path(c)[0]}

    fa, fb = flat(a), flat(b)
    if fa.keys() != fb.keys():
        return f"the carries' leaves differ: {sorted(fa)} vs {sorted(fb)}"
    for name, x in fa.items():
        x, y = x.detach().cpu(), fb[name].detach().cpu()
        if not x.is_floating_point():
            if not torch.equal(x, y):
                return f"{name} differs"
            continue
        scale = max(float(x.abs().max()), float(y.abs().max()), 1e-30)
        err = float((x - y).abs().max()) / scale
        if err > rtol:
            return f"{name} differs by {err:.2e} of its magnitude"
    return None


def dqn_rows(seed: int = 0) -> Dict:
    """The paper's §6.5 comparison on the card (``bench_dqn.rows``): the
    same ``STEPS`` steps from the same carry three ways, in turns (a, b,
    c, c, b, a):

    - (a) in-graph: ``Agent.run``, one WHILE-node launch;
    - (b) out-of-graph: the reference's baseline, a host loop of
      ``Agent.step`` (one launch a step and no host read, as
      ``jax.jit(_agent_step)`` is one dispatch a step);
    - (c) eager: ``agent_step`` with native conditionals (three
      predicate reads a step).

    Returns, for each way, the host and device microseconds a step
    (each run), graph launches and host reads a step, and the host's
    kernel launches a training step (counted by the profiler over
    ``PROFILED_STEPS`` steps from the carry after ``STEPS // 2``,
    outside the timed runs); the ratios (b)/(a) and (c)/(a) on the
    host's clock; and the final carries of one run of each way."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    c0 = carry0(prng.prng_key(seed, dev))
    agent = Agent(c0)

    def a_run(start, steps):
        agent.load(start)
        t_end = int(start["t"]) + steps
        return lambda: agent.run(t_end), agent.carry

    def b_run(start, steps):
        agent.load(start)

        def go():
            for _ in range(steps):
                agent.step()
        return go, agent.carry

    def c_run(start, steps):
        box = {}

        def go():
            c = start
            with torch.no_grad():
                for _ in range(steps):
                    c = agent_step(c, "native")
            box["c"] = c
        return go, lambda: box["c"]

    ways = {"a": a_run, "b": b_run, "c": c_run}
    for d in ways.values():             # capture both loops, warm up
        go, _ = d(c0, STEPS)
        go()
    torch.cuda.synchronize()
    out = {k: {"host_us": [], "device_us": []} for k in ways}
    for k in "abccba":
        go, final = ways[k](c0, STEPS)
        torch.cuda.synchronize()
        replays = device_loop.DeviceLoop.replays
        reads = host_reads + device_loop.DeviceLoop.host_reads \
            + core.while_loop.host_reads
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        go()
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        r = out[k]
        r["host_us"].append(host_s * 1e6 / STEPS)
        r["device_us"].append(start.elapsed_time(end) * 1e3 / STEPS)
        r["graph_launches"] = (device_loop.DeviceLoop.replays
                               - replays) / STEPS
        r["host_reads"] = (host_reads + device_loop.DeviceLoop.host_reads
                           + core.while_loop.host_reads - reads) / STEPS
        r["carry"] = final()
    go, mid = a_run(c0, STEPS // 2)
    go()
    mid = mid()                         # a training step's carry
    for k, d in ways.items():
        go, _ = d(mid, PROFILED_STEPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            go()
            torch.cuda.synchronize()
        out[k]["kernel_launches"] = sum(
            e.count for e in prof.key_averages() if e.key in (
                "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")) / PROFILED_STEPS
    agent.close()

    def mean(k):
        return sum(out[k]["host_us"]) / len(out[k]["host_us"])

    out["b_over_a"] = mean("b") / mean("a")
    out["c_over_a"] = mean("c") / mean("a")
    out["speedup_percent"] = (out["b_over_a"] - 1.0) * 100.0
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the graph lowering) or cpu (the "
                         "host lowering)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    carry = carry0(prng.prng_key(1, dev))
    if dev.type == "cuda":
        agent = Agent(carry)

        def run_episode(c, n):
            agent.load(c)
            agent.run(n)
            return agent.carry()
        lowering = "while_loop(impl='graph'): one WHILE-node launch a call"
    else:
        agent = None
        run_episode = run_host
        lowering = ("while_loop(impl='host'): the predicates read on the "
                    "host")

    def fresh(c, **kw):
        c = clone(c)
        for k, v in kw.items():
            c[k].fill_(v) if k != "obs" else c[k].zero_()
        return c

    # the untrained return over the first 200 steps
    c_pre = run_episode(fresh(carry, t=0), STEPS)
    pre = float(c_pre["ret"]) / STEPS
    # 2000 training steps as one call
    c_tr = run_episode(fresh(carry, t=0), TRAIN_STEPS)
    # the trained policy from a fresh environment
    c_post = run_episode(fresh(c_tr, t=0, ret=0.0, obs=0.0), STEPS)
    post = float(c_post["ret"]) / STEPS
    if agent is not None:
        agent.close()
    print(f"avg reward/step before training: {pre:8.4f}")
    print(f"avg reward/step after  training: {post:8.4f}")
    print(f"the agent-environment loop ran through {lowering} "
          f"({int(c_tr['t'])} interactions in the training call)")
    assert post > pre, "training should improve the return"
    return {"pre": pre, "post": post, "t": int(c_tr["t"])}


if __name__ == "__main__":
    main()
