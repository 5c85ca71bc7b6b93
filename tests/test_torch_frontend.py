"""The asyncio streaming front-end in the port (as
``tests/serve/test_frontend.py``): SSE frames equal to the JAX
package's, concurrent streams equal to the uninterrupted streams token
for token (fp32), backpressure at ``max_inflight``, a ``preempted``
event that leaves the stream clean, the scheduler stepped from
``asyncio.to_thread`` as the front-end's driver does, and the launcher's
``--stream`` path end to end."""

import asyncio
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.serve import frontend as jfe
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import frontend as fe_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import slo as slo_lib

PROMPT, MAX_NEW, BLOCK = 16, 10, 8
NEED = 4      # ceil((16 + 10 + 1) / 8)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32")
    return cfg, bridge.init_params(cfg, seed=13, device="cpu")


def _sched(kv_blocks=None, **kw):
    cfg, params = _model()
    return sched_lib.DecodeScheduler(
        params, cfg, n_slots=4, prompt_len=PROMPT, max_new_cap=MAX_NEW,
        eos_id=-1, kv="paged", kv_block=BLOCK, kv_blocks=kv_blocks,
        prefill="chunked", chunk_tokens=8, **kw)


def _prompts(n):
    cfg, _ = _model()
    return np.random.default_rng(13).integers(
        2, cfg.vocab, (n, PROMPT)).astype(np.int32)


def _reference(pnp):
    sched = _sched()
    for i in range(pnp.shape[0]):
        sched.submit(pnp[i:i + 1], max_new=MAX_NEW, request_id=i)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


async def _consume(fe, pnp, rid, out, slo_class="batch", events=None,
                   first=None):
    toks = []
    async for ev in fe.stream(pnp[rid:rid + 1], max_new=MAX_NEW,
                              slo_class=slo_class, request_id=rid):
        if events is not None:
            events.append(ev["event"])
        if ev["event"] == "token":
            toks.extend(ev["tokens"])
            if first is not None:
                first.set()
    out[rid] = toks


@pytest.mark.parametrize("event", [
    {"event": "token", "request_id": 3, "tokens": [1, 2]},
    {"event": "done", "request_id": 0, "length": 10, "hit_eos": False},
    {"event": "preempted", "request_id": 7}, {"event": "done"},
    {"tokens": [5]}])
def test_format_sse_equals_the_jax_frontend(event):
    assert fe_lib.format_sse(event) == jfe.format_sse(event)


def test_format_sse_frame():
    assert fe_lib.format_sse(
        {"event": "token", "request_id": 3, "tokens": [1, 2]}) == \
        'event: token\ndata: {"request_id": 3, "tokens": [1, 2]}\n\n'


def test_concurrent_streams_equal_the_uninterrupted_streams():
    pnp = _prompts(6)
    ref = _reference(pnp)

    async def run():
        fe = fe_lib.StreamingFrontend(
            slo_lib.SLOScheduler(_sched(), segment_steps=4), max_inflight=8)
        out = {}
        await asyncio.gather(*[_consume(fe, pnp, r, out) for r in range(6)])
        return out, fe

    out, fe = asyncio.run(run())
    for rid in range(6):
        np.testing.assert_array_equal(np.asarray(out[rid]), ref[rid])
    assert fe.inflight == 0


def test_backpressure_admits_one_at_a_time():
    pnp = _prompts(3)
    ref = _reference(pnp)
    peak = {"inflight": 0, "waiting": 0}

    async def watched(fe, rid, out):
        async for ev in fe.stream(pnp[rid:rid + 1], max_new=MAX_NEW,
                                  request_id=rid):
            peak["inflight"] = max(peak["inflight"], fe.inflight)
            peak["waiting"] = max(peak["waiting"], fe.queue_depth)
            out.setdefault(rid, []).extend(
                ev["tokens"] if ev["event"] == "token" else [])

    async def run():
        fe = fe_lib.StreamingFrontend(
            slo_lib.SLOScheduler(_sched(), segment_steps=4), max_inflight=1)
        out = {}
        await asyncio.gather(*[watched(fe, r, out) for r in range(3)])
        return out

    out = asyncio.run(run())
    assert peak["inflight"] == 1 and peak["waiting"] >= 1
    for rid in range(3):
        np.testing.assert_array_equal(np.asarray(out[rid]), ref[rid])


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preempted_event_and_a_clean_stream(prefix_cache):
    """Batch streams hold a pool of two residents; an interactive one
    arrives once they stream tokens: some batch stream sees
    ``preempted``, then its remaining tokens exactly once."""
    pnp = _prompts(4)
    ref = _reference(pnp)

    async def run():
        slo = slo_lib.SLOScheduler(_sched(
            kv_blocks=2 * NEED + 2 * prefix_cache, prefix_cache=prefix_cache),
            segment_steps=2)
        fe = fe_lib.StreamingFrontend(slo, max_inflight=8)
        out, kinds = {}, {r: [] for r in range(4)}
        first = asyncio.Event()
        batch = [asyncio.ensure_future(_consume(
            fe, pnp, r, out, events=kinds[r], first=first))
            for r in range(3)]
        await first.wait()          # batch traffic holds the pool
        await _consume(fe, pnp, 3, out, slo_class="interactive",
                       events=kinds[3])
        await asyncio.gather(*batch)
        return out, kinds, slo

    out, kinds, slo = asyncio.run(run())
    assert slo.preemptions > 0 and slo.replay_mismatches == 0
    assert any("preempted" in kinds[r] for r in range(3))
    for rid in range(4):
        np.testing.assert_array_equal(np.asarray(out[rid]), ref[rid])
        assert kinds[rid][-1] == "done"


def test_scheduler_stepped_from_a_worker_thread():
    """``asyncio.to_thread(sched.step)`` (the front-end's driver) gives
    the streams of stepping on the calling thread; the device counters
    and the host mirrors stay consistent."""
    pnp = _prompts(5)
    ref = _reference(pnp)

    async def run():
        sched = _sched(kv_blocks=3 * NEED, prefix_cache=True)
        for i in range(5):
            sched.submit(pnp[i:i + 1], max_new=MAX_NEW, request_id=i)
        out = {}
        while sched.pending:
            for f in await asyncio.to_thread(sched.step, True, 3):
                out[f.request_id] = f.tokens
        return out, sched

    out, sched = asyncio.run(run())
    for rid in range(5):
        np.testing.assert_array_equal(out[rid], ref[rid])
    assert sched.free_blocks == int(sched.pool.cache["attn"].free_count)
    assert torch.is_grad_enabled()     # the caller's mode is untouched


def test_launcher_stream_serves_every_request():
    """``launch.serve --stream --prefix-cache`` on the CPU at smoke
    width: every stream ends in ``done`` with its ``max_new`` tokens, and
    the per-class summary covers both classes."""
    s = launch_serve.main([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--stream",
        "--prefix-cache", "--kv", "paged", "--kv-block", "4",
        "--kv-blocks", "24", "--prefill", "chunked",
        "--chunk-tokens", "8", "--slots", "2", "--prompt-len", "16",
        "--requests", "6", "--rate", "1000", "--prompt-pool", "2",
        "--max-new-short", "4", "--max-new-long", "6", "--eos-id", "-1",
        "--segment-steps", "4", "--hi-every", "3"])
    assert s["completed"] == 6 and s["replay_mismatches"] == 0
    assert set(s["classes"]) == {"interactive", "batch"}
    for i, rec in s["streams"].items():
        assert rec["last"] == "done"
        assert len(rec["tokens"]) == (4 if i % 2 == 0 else 6)
    assert s["prefix_hit_blocks"] > 0


def test_rejects_bad_max_inflight():
    with pytest.raises(ValueError, match="max_inflight"):
        fe_lib.StreamingFrontend(slo_lib.SLOScheduler(_sched()),
                                 max_inflight=0)
