"""The port's single-device examples against the JAX package's:
``quickstart``, ``train_lm`` and ``elastic_restart``.
``dqn_in_graph`` has its own file (``test_torch_dqn.py``).

Tolerances:
- ``quickstart``: its five results within 1e-6 of the JAX example's
  (fp32 scalars through tanh, sin and products; the trip count, the
  prefix sums, the TensorArray read and the cond exactly);
- ``train_lm``: the smoke smollm with the JAX package's weights, in fp32
  compute, 4 steps: each step's loss within 1e-5 relative of the JAX
  step's (the train tests' fp32 loss tolerance), through the Trainer
  and through the in-graph loop (``--in-graph 2``, which must give the
  Trainer's losses at its steps);
- ``elastic_restart``: the resumed run's parameters within 1e-5 of the
  uninterrupted run's (the reference's bar; on the CPU exactly 0), and
  phase 3's restore onto a (4, 2) mesh of 8 gloo ranks exact.

JAX is imported only inside the tests that hold the port to it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.examples import elastic_restart, quickstart, train_lm

QUICK_TOL = 1e-6
LOSS_RTOL = 1e-5


def test_quickstart_equals_jax(capsys):
    import jax
    import jax.numpy as jnp
    from repro.core import TensorArray, cond, scan, while_loop
    got = quickstart.main(["--device", "cpu"])
    assert "loop ran 9 iterations -> 118.59" in capsys.readouterr().out

    out = while_loop(lambda c: c[1] < 100.0,
                     lambda c: (c[0] + 1, c[1] * 1.7),
                     (jnp.int32(0), jnp.float32(1.0)), max_iters=50)

    def f(x, w):
        _, y = while_loop(lambda c: c[0] < 5,
                          lambda c: (c[0] + 1, jnp.tanh(c[1] * w)),
                          (jnp.int32(0), x), max_iters=8)
        return y

    dx, dw = jax.grad(f, argnums=(0, 1))(jnp.float32(0.3), jnp.float32(1.2))
    g_off = jax.grad(lambda x: while_loop(
        lambda c: c[0] < 5, lambda c: (c[0] + 1, jnp.sin(c[1])),
        (jnp.int32(0), x), max_iters=8, save_policy="offload")[1])(
            jnp.float32(0.5))
    sums = scan(lambda c, x: c + x, jnp.arange(6.0), jnp.float32(0.0))
    read2 = TensorArray.unstack(jnp.arange(4.0)).read(2)
    y = cond(jnp.asarray(True), lambda v: v * 2, lambda v: v - 1,
             jnp.float32(21.0))
    assert got["iterations"] == int(out[0])
    for name, want in (("value", out[1]), ("dx", dx), ("dw", dw),
                       ("offload_grad", g_off)):
        np.testing.assert_allclose(got[name], float(want), rtol=QUICK_TOL,
                                   err_msg=name)
    assert got["scan"] == np.asarray(sums).tolist()
    assert got["ta_read"] == float(read2) and got["cond"] == float(y) == 42.0


@pytest.fixture(scope="module")
def smollm_fp32():
    """(jax cfg, jax params, port cfg, port params): the JAX package's
    draws on both sides, fp32 compute."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo as jzoo
    jcfg = dataclasses.replace(jax_get_config("smollm-135m", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("smollm-135m", smoke=True),
                              compute_dtype="float32")
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, jax.tree.map(np.asarray, jparams)


def _ours(np_params, cfg):
    return bridge.from_numpy(np_params, cfg, device="cpu",
                             keep_param_dtype=True)


def test_train_lm_losses_equal_jax(smollm_fp32):
    import jax
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.optim import adamw as jadamw
    from repro.optim import schedule as jschedule
    from repro.train import train_loop as jtrain
    jcfg, jparams, cfg, np_params = smollm_fp32
    steps, batch, seq = 4, 2, 16
    # the JAX example's Trainer path: lr 1e-3, warmup_cosine(20, steps)
    jopt = jadamw.AdamWConfig(lr=1e-3,
                              schedule=jschedule.warmup_cosine(20, steps))
    step = jax.jit(jtrain.make_train_step(jcfg, jopt))
    data = JSyntheticLM(jcfg.vocab, seq, batch, seed=0)
    p, o, want = jparams, jadamw.init(jparams), []
    for i in range(steps):
        p, o, m = step(p, o, data.batch_at(i))
        want.append(float(m["loss"]))
    args = train_lm.parse_args(["--steps", str(steps), "--batch", str(batch),
                                "--seq", str(seq), "--device", "cpu"])
    got = train_lm.train(args, cfg, _ours(np_params, cfg))
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
    assert got["lowering"] == "python loop of train steps"
    args.in_graph = 2
    fused = train_lm.train(args, cfg, _ours(np_params, cfg))
    np.testing.assert_allclose(fused["losses"], want[1::2], rtol=LOSS_RTOL)
    assert fused["lowering"] == train_lm.IN_GRAPH_LOWERING


def test_train_lm_main_runs_on_cpu(capsys):
    out = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "8",
                         "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "smollm-135m" in capsys.readouterr().out


def test_elastic_restart_resumes_within_tolerance(smollm_fp32, capsys):
    _, _, cfg, np_params = smollm_fp32
    out = elastic_restart.run(cfg, _ours(np_params, cfg))
    assert out["max_diff"] < elastic_restart.RESUME_TOL
    text = capsys.readouterr().out
    assert "phase2: resumed step 4 -> 6" in text
    assert "phase3: restored step 4 onto a (4,2) mesh spanning 8 ranks" \
        in text
    assert out["mesh_ranks"] == 8


def test_elastic_restart_main_on_cpu():
    out = elastic_restart.main(["--device", "cpu"])
    assert out["max_diff"] < elastic_restart.RESUME_TOL
    assert np.isfinite(out["loss"]) and np.isfinite(out["resumed_loss"])


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (quickstart, train_lm, elastic_restart):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
