"""One-shot admission in the port's scheduler, against the JAX
package's one-shot scheduler, and the invariants of its design pinned
inside the port.

Against the JAX package (same weights through ``bridge.from_numpy``,
same numpy prompts, fp32 compute, greedy): per-request streams, loop
iterations and occupancy are identical for smollm-135m smoke with
power-of-two prompt buckets (dense and paged cache, with and without
admission coalescing) and for falcon-mamba-7b smoke with exact-length
prompts. Inside the port: one-shot == ``generate_batch_sync`` and
one-shot == chunked prefill, greedy streams; the run counters reset on
the first submit to a drained scheduler; what the scheduler refuses.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro.serve import scheduler as jsched
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import engine
from repro_torch.serve import scheduler as sched_lib

REQS = [(9, 7), (4, 3), (12, 8), (1, 5), (7, 6), (3, 4)]  # (len, max_new)


@functools.lru_cache(maxsize=None)
def _pair(arch, scan=None):
    """(jax cfg, jax params, port cfg, port params), fp32 compute; the
    port's SSM scan path set to ``scan``."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    if scan is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl=scan))
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, jp, cfg, bridge.from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


def _prompts(cfg, exact=None):
    rng = np.random.default_rng(6)
    return [(rng.integers(2, cfg.vocab, (1, exact or n)).astype(np.int32), m)
            for n, m in REQS]


def _drive(sched, reqs):
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: np.asarray(f.tokens)
            for f in sched.run_until_drained()}


def _same_as_jax(jcfg, jp, cfg, tp, reqs, **kw):
    kw = {"n_slots": 2, "prompt_len": 12, "max_new_cap": 8, "eos_id": 1,
          "kv_block": 4, **kw}
    js = jsched.DecodeScheduler(jp, jcfg, prefill="oneshot", **kw)
    ref = _drive(js, reqs)
    sched = sched_lib.DecodeScheduler(tp, cfg, **kw)
    ours = _drive(sched, reqs)
    assert sorted(ours) == sorted(ref) == list(range(len(reqs)))
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])
    assert sched.total_steps == js.total_steps
    assert sched.occupancy == pytest.approx(js.occupancy)
    assert sched.tokens_emitted == js.tokens_emitted
    if kw.get("kv") == "paged":
        assert sched.free_blocks == sched.kv_blocks
    return sched


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("admit_threshold", [1, 2])
def test_dense_oneshot_matches_jax_scheduler(kv, admit_threshold):
    """2 slots, 6 requests of mixed lengths right-padded to buckets 1..12
    (queueing, slot reuse, coalesced admissions)."""
    jcfg, jp, cfg, tp = _pair("smollm-135m")
    sched = _same_as_jax(jcfg, jp, cfg, tp, _prompts(cfg), kv=kv,
                         admit_threshold=admit_threshold)
    assert sched.prefill_impl == "dense-bucketed"


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("scan", ["assoc", "cuda"])
def test_ssm_oneshot_matches_jax_scheduler(scan, kv):
    """falcon-mamba smoke, exact-length prompts; the JAX side scans with
    its associative scan, the port with ``scan``."""
    jcfg, jp, cfg, tp = _pair("falcon-mamba-7b", scan)
    sched = _same_as_jax(jcfg, jp, cfg, tp, _prompts(cfg, exact=12), kv=kv)
    assert sched.attn_impl == sched.prefill_impl == "attention-free"


def _sync_streams(tp, cfg, reqs):
    """Each request alone through generate_batch_sync, cut at its own
    max_new (greedy streams do not depend on the batch)."""
    out = {}
    for rid, (p, m) in enumerate(reqs):
        r = engine.generate_batch_sync(tp, cfg, torch.from_numpy(p),
                                       max_new=m, eos_id=1)
        out[rid] = r.tokens[0, :int(r.lengths[0])].numpy()
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b"])
def test_oneshot_equals_generate_batch_sync(arch):
    _, _, cfg, tp = _pair(arch)
    reqs = _prompts(cfg, exact=12 if cfg.family == "ssm" else None)
    sched = sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=12,
                                      max_new_cap=8, eos_id=1)
    ours = _drive(sched, reqs)
    ref = _sync_streams(tp, cfg, reqs)
    for rid in ref:
        np.testing.assert_array_equal(ours[rid], ref[rid])


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_oneshot_equals_chunked(kv):
    _, _, cfg, tp = _pair("smollm-135m")
    reqs = _prompts(cfg)
    streams = {}
    for mode in ("oneshot", "chunked"):
        sched = sched_lib.DecodeScheduler(
            tp, cfg, n_slots=3, prompt_len=12, max_new_cap=8, eos_id=1,
            kv=kv, kv_block=4, prefill=mode, chunk_tokens=5)
        streams[mode] = _drive(sched, reqs)
    for rid in streams["oneshot"]:
        np.testing.assert_array_equal(streams["oneshot"][rid],
                                      streams["chunked"][rid])


@pytest.mark.parametrize("mode", ["oneshot", "chunked"])
def test_stats_reset_on_first_submit_to_a_drained_scheduler(mode):
    """Counters describe runs: a second run on a drained scheduler
    reports only its own iterations and tokens, and a submit while work
    is in flight resets nothing."""
    _, _, cfg, tp = _pair("smollm-135m")
    reqs = _prompts(cfg)

    def fresh():
        return sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=12,
                                         max_new_cap=8, eos_id=-1,
                                         prefill=mode)

    sched = fresh()
    _drive(sched, reqs[:4])
    assert sched.tokens_emitted == sum(m for _, m in reqs[:4])
    _drive(sched, reqs[4:])
    alone = fresh()
    _drive(alone, reqs[4:])
    assert sched.tokens_emitted == alone.tokens_emitted == \
        sum(m for _, m in reqs[4:])
    assert sched.total_steps == alone.total_steps
    # mid-run: the round returns when the shorter request frees its
    # slot, the longer one still runs, so a submit keeps the counters
    for prompt, max_new in reqs[:2]:
        sched.submit(prompt, max_new=max_new)
    assert len(sched.step(expect_arrivals=True)) == 1
    assert sched.active_count == 1
    steps, toks = sched.total_steps, sched.tokens_emitted
    assert steps > 0 and toks == reqs[1][1]
    sched.submit(reqs[2][0], max_new=reqs[2][1])
    assert (sched.total_steps, sched.tokens_emitted) == (steps, toks)


def test_ssm_scheduler_refuses_what_it_cannot_serve():
    _, _, cfg, tp = _pair("falcon-mamba-7b")
    sched = sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=12,
                                      max_new_cap=8)
    assert sched.prefill == "oneshot"
    with pytest.raises(ValueError, match="exact-length"):
        sched.submit(np.ones((1, 11), np.int32), max_new=2)
    with pytest.raises(ValueError, match="chunked"):
        sched_lib.DecodeScheduler(tp, cfg, n_slots=2, prompt_len=12,
                                  max_new_cap=8, prefill="chunked")


def test_launcher_defaults_to_oneshot_and_serves_ssm():
    common = ["--smoke", "--device", "cpu", "--slots", "2", "--prompt-len",
              "8", "--requests", "3", "--rate", "1e9", "--max-new-short",
              "3", "--max-new-long", "5", "--eos-id", "-1"]
    dense = launch_serve.main(["--arch", "smollm-135m", "--kv", "paged",
                               *common])
    assert dense["prefill_impl"] == "dense-bucketed"
    assert dense["attn_impl"] == "gather:paged"
    assert dense["tokens"] == 3 + 5 + 3
    mamba = launch_serve.main(["--arch", "falcon-mamba-7b", "--prefill",
                               "oneshot", *common])
    assert mamba["attn_impl"] == mamba["prefill_impl"] == "attention-free"
    assert mamba["tokens"] == 3 + 5 + 3
