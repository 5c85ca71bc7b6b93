"""Two faults the port shared with the JAX package's design, repaired in
the port only (the JAX package keeps them), each pinned here.

- The model drafter after a prefix hit. The draft model's cache is its
  own dense register and shares no block, so a hit row's draft
  positions below the hit held stale values and the drafts were
  rejected. Admission now prefills the draft's hit positions. With the
  target drafting for itself, the accept rate with hits equals the rate
  without (both 1.0 here; before the repair 0.27 with hits), and the
  streams are unchanged.
- The SLO victim planner with the prefix cache. It counted only a
  victim's unpinned blocks, so a block-short preemption of a
  prefix-cached victim (whose prompt blocks are pinned by the index)
  looked infeasible. It now also counts the victim's PENDING
  registrations and the READY entries that only it references, which
  the admission after may evict, from host state. The preemption is
  planned, carried out, and the victim's replay equals its
  uninterrupted stream (``replay_mismatches == 0``).

Two faults the port shared with the JAX package's scheduler and
launcher, repaired in the port only (each test failed before):

- A retiring row's last decode. ``_decode`` freed a finishing row's
  blocks before the step's decode, whose ``live`` mask still held the
  row: under early exit it kept the layer loop alive and its depth,
  computed over freed blocks, went to ``slot_layers``, so a request's
  mean depth depended on the other requests in the pool. Now only the
  rows that go on are live and counted.
- The open-loop launcher's tokens. A submission to a drained pool
  restarts the scheduler's run counters, so ``serve_arrivals`` counted
  only the tokens since the last drain, and the ``TokenClock``'s step
  marks went backwards. It now counts its own streams and steps.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import slo as slo_lib
from repro_torch.serve import speculative as spec_lib


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32")
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(2))
    return cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")


def _prompts(cfg, n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab, 16).astype(np.int32)
            for _ in range(n)]


def test_self_drafting_accepts_as_much_with_prefix_hits():
    cfg, tp = _pair()
    a, b = _prompts(cfg, 2)
    runs = {}
    for pc in (False, True):
        s = sched_lib.DecodeScheduler(
            tp, cfg, n_slots=1, prompt_len=16, max_new_cap=8, eos_id=-1,
            kv="paged", kv_block=4, kv_blocks=24, prefill="chunked",
            chunk_tokens=5, prefix_cache=pc,
            speculative=spec_lib.SpecConfig(k=3, drafter="model"),
            draft_params=tp, draft_cfg=cfg)
        for rid, p in enumerate([a, b, a, a, b]):
            s.submit(p[None], max_new=8, request_id=rid)
        out = {}
        while s.pending:
            for f in s.step():
                out[f.request_id] = np.asarray(f.tokens)
        runs[pc] = (out, s.accept_rate, s.prefix_hit_blocks)
    (off, rate_off, _), (on, rate_on, hits) = runs[False], runs[True]
    assert hits > 0
    assert rate_on == rate_off > 0.9
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])


def test_block_short_preemption_of_a_prefix_cached_victim():
    """A batch request holds 3 unpinned blocks and 4 index-pinned prompt
    blocks of an 8-block pool; an interactive request needs 7. Counting
    only unpinned blocks (1 + 3 < 7) the plan was infeasible; with the
    pins that become evictable (1 + 3 + 4 >= 7) it is carried out."""
    cfg, tp = _pair()
    victim, head = _prompts(cfg, 2, seed=9)
    kw = dict(n_slots=2, prompt_len=16, max_new_cap=8, eos_id=-1,
              kv="paged", kv_block=4, prefill="chunked", chunk_tokens=8)
    alone = sched_lib.DecodeScheduler(tp, cfg, **kw)
    alone.submit(victim[None], max_new=8, request_id=0)
    (ref,) = alone.run_until_drained()

    inner = sched_lib.DecodeScheduler(tp, cfg, kv_blocks=8,
                                      prefix_cache=True, **kw)
    slo = slo_lib.SLOScheduler(inner, segment_steps=3)
    slo.submit(victim[None], max_new=8, slo_class="batch", request_id=0)
    events = []
    while not len(inner.emitted(0)):        # decoding, its pins READY
        events += slo.step()
    assert inner.free_blocks == 1 and int(inner._slot_blocks[0]) == 3
    assert inner.blocks_freed([0]) == 3 + 4
    slo.submit(head[None], max_new=8, slo_class="interactive",
               request_id=1)
    events += slo.step()
    assert slo.preemptions == 1
    assert [e.request_id for e in events if e.kind == "preempted"] == [0]
    while slo.pending:    # a replay round may deliver nothing new
        events += slo.step()
        assert slo.rounds < 100
    got = {e.request_id: e.finished for e in events if e.kind == "finished"}
    np.testing.assert_array_equal(got[0].tokens, ref.tokens)
    assert slo.replay_mismatches == 0
    assert inner.prefix_evictions > 0


def _depth_run(mod, params, cfg, others, target, **kw):
    """``target`` (request 0, 6 tokens) served after ``others``; returns
    every request's (tokens, mean depth)."""
    sched = mod.DecodeScheduler(params, cfg, **kw)
    for rid, p in enumerate(others):
        sched.submit(p[None], max_new=8, request_id=10 + rid)
    sched.submit(target[None], max_new=6, request_id=0)
    return {f.request_id: (np.asarray(f.tokens), f.mean_depth)
            for f in sched.run_until_drained()}


@pytest.mark.parametrize("others", [0, 1, 2])
def test_a_retiring_rows_depth_does_not_depend_on_the_pool(others):
    """Early exit at a margin threshold that halts some decodes after
    layer 1 of 2: request 0's mean depth is the same whichever request
    shared its pool (before the repair 1.67 beside one and 1.83 beside
    another), and every stream equals the JAX scheduler's."""
    from repro.serve import scheduler as jsched
    cfg, tp = _pair()
    acfg = dataclasses.replace(cfg, early_exit=True, exit_threshold=0.05,
                               exit_min_layers=1)
    jcfg = dataclasses.replace(
        jax_get_config("llama3.2-1b", smoke=True), compute_dtype="float32",
        early_exit=True, exit_threshold=0.05, exit_min_layers=1)
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(2))
    prompts = _prompts(cfg, 4)
    kw = dict(n_slots=2, prompt_len=16, max_new_cap=8, eos_id=-1,
              kv="paged", kv_block=4, prefill="chunked", chunk_tokens=5)
    pool = [prompts[others]] if others else []
    alone = _depth_run(sched_lib, tp, acfg, [], prompts[0], **kw)
    ours = _depth_run(sched_lib, tp, acfg, pool, prompts[0], **kw)
    assert ours[0][1] == alone[0][1]
    assert 1.0 < alone[0][1] < 2.0
    ref = _depth_run(jsched, jp, jcfg, pool, prompts[0], **kw)
    assert sorted(ours) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid][0], ref[rid][0])


def test_open_loop_tokens_count_every_request_across_a_drain(
        tmp_path, capsys, monkeypatch):
    """Two arrivals a second apart, the pool drained between them: the
    run reports every token its streams hold (before the repair only the
    second request's 4), and the clock's step marks never go back."""
    marks = []

    class Clock(launch_serve.TokenClock):
        def arrive(self, rid, t, step=0):
            marks.append(step)
            super().arrive(rid, t, step)

        def observe(self, sched, finished, t, *step):
            marks.append(step[0] if step else sched.total_steps)
            super().observe(sched, finished, t, *step)

    monkeypatch.setattr(launch_serve, "TokenClock", Clock)
    trace = tmp_path / "trace.csv"
    trace.write_text("0.0,3\n1.0,4\n")
    out = launch_serve.main(
        ["--arch", "llama3.2-1b", "--smoke", "--slots", "2",
         "--prompt-len", "8", "--device", "cpu", "--eos-id", "-1",
         "--trace", str(trace)])
    capsys.readouterr()
    assert sorted(len(s) for s in out["streams"].values()) == [3, 4]
    assert out["tokens"] == 3 + 4
    assert len(marks) >= 4 and marks == sorted(marks)
