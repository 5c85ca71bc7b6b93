"""The scheduler's segment as the JAX package's ``step``: one
``core.while_loop`` with the reference's ``cond_fn`` and, chunked, two
``cond`` branches, written in place so that a CUDA graph can replay it.

On the CPU (the host-read lowering, the only one there): the segment
predicate, which both lowerings evaluate, equals the JAX package's
``cond_fn`` over random flags, ``want`` and ``max_steps``; the body
leaves every register and cache tensor at its address; the device
counters equal what the former host counters counted; ``max_steps``
caps a segment's iterations as in the JAX package; a harvest is one host
read and advances the kernel wrappers' counters by the launches the
device counted. The tests marked ``cuda`` run the graph lowering on the
card against the host-read one (greedy streams, iterations, launch
counts counted on the device against those counted in Python, one host
read a segment):

    python -m pytest --noconftest -m cuda tests/test_torch_serve_graph.py

The file imports JAX only inside the tests that hold the port to it, so
the ``cuda`` tests run on a machine with only PyTorch.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch import bridge, core
from repro_torch.configs import get_config
from repro_torch.core.device_loop import DeviceLoop
from repro_torch.kernels.flash_prefill import kernel as fp_kernel
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve import speculative as spec_lib
from repro_torch.serve.sampling import SamplingParams


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _llama(device, attn_impl="cuda"):
    """Smoke llama with the kernels' head dim (64)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", attn_impl=attn_impl,
                              head_dim=64, n_heads=8, n_kv_heads=2,
                              d_model=128)
    return cfg, bridge.init_params(cfg, seed=0, device=device)


def _mamba(device):
    cfg = dataclasses.replace(get_config("falcon-mamba-7b", smoke=True),
                              compute_dtype="float32")
    return cfg, bridge.init_params(cfg, seed=0, device=device)


def _reqs(cfg, lens_news, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, cfg.vocab, (1, n)).astype(np.int32), m)
            for n, m in lens_news]


CHUNKED = dict(n_slots=3, prompt_len=24, max_new_cap=10, eos_id=-1,
               kv="paged", kv_block=4, prefill="chunked", chunk_tokens=8)
ONESHOT = dict(n_slots=2, prompt_len=16, max_new_cap=10, eos_id=-1)
DENSE_REQS = ((20, 7), (5, 10), (24, 3), (1, 6), (13, 9))
ONESHOT_REQS = ((15, 7), (5, 10), (16, 3), (1, 6), (13, 9))
SSM_REQS = ((16, 7), (16, 10), (16, 3), (16, 6))


def _drive(sched, reqs):
    for rid, (p, m) in enumerate(reqs):
        sched.submit(p, max_new=m, request_id=rid)
    return {f.request_id: f.tokens for f in sched.run_until_drained()}


# ------------------------------------------------------------------ CPU

def test_segment_predicate_equals_the_jax_cond_fn(monkeypatch):
    """The port's ``_seg_cond`` against the reference's ``cond_fn``
    (``repro/serve/scheduler.py``, inside ``step``), the latter taken
    from the JAX scheduler's own ``step`` with ``core.while_loop``
    patched to evaluate the predicate it is given, on the same random
    flag vectors, ``want``, ``max_steps`` and iterations since entry."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo
    from repro.serve import scheduler as jsched

    n = 5
    jcfg = jax_get_config("llama3.2-1b", smoke=True)
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(0))
    js = jsched.DecodeScheduler(jp, jcfg, n_slots=n, prompt_len=8,
                                max_new_cap=4, prefill="chunked",
                                chunk_tokens=4)
    delta = {}
    monkeypatch.setattr(jsched.core, "while_loop",
                        lambda cond_fn, body_fn, init, **kw: cond_fn(
                            dataclasses.replace(
                                init, steps=init.steps + delta["d"])))
    step = js._build_step()

    cfg, params = _llama("cpu", "gather")
    sched = sched_lib.DecodeScheduler(params, cfg, n_slots=n, prompt_len=8,
                                      max_new_cap=4, prefill="chunked",
                                      chunk_tokens=4, kv="paged")
    p = sched.pool
    rng = np.random.default_rng(0)
    for case in range(60):
        active = rng.random(n) < rng.random()
        prefilling = rng.random(n) < rng.random()
        want = int(rng.integers(0, n + 2))
        max_steps = int(rng.choice([0, 1, 3, sched_lib._NO_STEP_CAP]))
        s0, d = int(rng.integers(0, 50)), int(rng.integers(0, 5))
        delta["d"] = d
        jpool = dataclasses.replace(js.pool, active=jnp.asarray(active),
                                    prefilling=jnp.asarray(prefilling),
                                    steps=jnp.int32(s0))
        want_j = bool(step(jp, None, jpool, np.int32(want),
                           np.int32(max_steps)))
        p.active.copy_(torch.from_numpy(active))
        p.prefilling.copy_(torch.from_numpy(prefilling))
        p.limits.copy_(torch.tensor([want, max_steps]))
        p.seg_start.fill_(s0)
        p.steps.fill_(s0 + d)
        assert bool(sched._seg_cond(p)) == want_j, (case, active,
                                                     prefilling, want,
                                                     max_steps, d)


def _addresses(pool):
    """Every tensor the segment reads or writes, by address: the pool's
    leaves and the tensors inside the KV cache objects (the target's and
    a draft model's)."""
    out = {}
    for k, leaf in enumerate(pytree.tree_leaves(pool)):
        if torch.is_tensor(leaf):
            out[k] = leaf.data_ptr()
        else:
            for name, t in vars(leaf).items():
                if torch.is_tensor(t):
                    out[(k, name)] = t.data_ptr()
    return out


@pytest.mark.parametrize("mode", ["chunked", "oneshot-dense",
                                  "oneshot-ssm", "spec-ngram-sampled",
                                  "spec-model"])
def test_body_keeps_every_address(mode):
    """Capture-readiness on the CPU: admission, two body iterations and
    a harvest leave every register and cache tensor where it was, so a
    graph captured once can replay the segment. The speculative pools
    add the request keys, the spec counters and (model drafter) the
    draft model's cache, all among the addresses held."""
    spec = {}
    if mode == "oneshot-ssm":
        cfg, params = _mamba("cpu")
        sched = sched_lib.DecodeScheduler(params, cfg, **ONESHOT)
        reqs = _reqs(cfg, SSM_REQS)
    else:
        cfg, params = _llama("cpu")
        if mode == "spec-ngram-sampled":
            spec = dict(speculative=spec_lib.SpecConfig(k=3, ngram=1),
                        sampling=SamplingParams(temperature=0.8, top_k=5))
        elif mode == "spec-model":
            spec = dict(speculative=spec_lib.SpecConfig(k=2,
                                                        drafter="model"),
                        draft_params=params, draft_cfg=cfg)
        kw = (CHUNKED if mode == "chunked" or spec
              else dict(ONESHOT, kv="paged"))
        sched = sched_lib.DecodeScheduler(params, cfg, **kw, **spec)
        reqs = _reqs(cfg, ((14, 5), (3, 6)))
    before = _addresses(sched.pool)
    p = sched.pool
    held = set(before.values())
    for reg in (p.keys, p.slot_accepted, p.slot_windows):
        assert reg.data_ptr() in held
    if mode == "spec-model":
        draft = p.draft["attn"]
        assert {draft.k.data_ptr(), draft.v.data_ptr()} <= held
    for rid, (p, m) in enumerate(reqs[:2]):
        sched.submit(p, max_new=m, request_id=rid)
    sched._admit_queued()
    for _ in range(2):
        if sched._chunked:
            sched._chunk_branch()
        sched._decode_branch()
        sched.pool.steps.add_(1)
    assert int(sched.pool.decode_steps) == 2
    sched._harvest()
    assert _addresses(sched.pool) == before
    if spec:
        assert sched.spec_windows > 0


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_device_counters_equal_the_host_counters(mode):
    """The former host counters, counted on the host around the
    host-read loop's decisions (an iteration per read that goes on; the
    slots running when the decode branch starts), equal the device
    counters read at harvest."""
    cfg, params = _llama("cpu")
    kw = CHUNKED if mode == "chunked" else dict(ONESHOT, kv="paged")
    sched = sched_lib.DecodeScheduler(params, cfg, **kw, admit_threshold=1)
    host = {"steps": 0, "busy": 0}
    read, decode = sched._read_flags, sched._decode_branch

    def read_flags():
        flags = read()
        host["steps"] += bool(flags[0])
        return flags

    def decode_branch():
        host["busy"] += int(sched.pool.active.sum())
        decode()

    sched._read_flags, sched._decode_branch = read_flags, decode_branch
    _drive(sched, _reqs(cfg, DENSE_REQS if mode == "chunked"
                        else ONESHOT_REQS))
    assert sched.total_steps == host["steps"] > 0
    assert sched.busy_slot_steps == host["busy"] > 0
    assert int(sched.pool.decode_steps) <= sched.total_steps
    if mode == "oneshot":
        assert int(sched.pool.chunk_steps) == 0
        assert int(sched.pool.decode_steps) == sched.total_steps


def test_max_steps_caps_segments_as_in_jax():
    """``step(max_steps=k)`` against the JAX scheduler's: the same
    iterations and streams, segment for segment (fp32, smoke llama,
    chunked paged)."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import model_zoo
    from repro.serve import scheduler as jsched

    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", smoke=True),
                               compute_dtype="float32", attn_impl="xla")
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype="float32", attn_impl="gather")
    jp = model_zoo.init_params(jcfg, jax.random.PRNGKey(2))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    kw = dict(CHUNKED, eos_id=1)
    js = jsched.DecodeScheduler(jp, jcfg, **kw)
    ts = sched_lib.DecodeScheduler(tp, cfg, **kw)
    reqs = _reqs(cfg, DENSE_REQS)
    for rid, (p, m) in enumerate(reqs):
        js.submit(p, max_new=m, request_id=rid)
        ts.submit(p, max_new=m, request_id=rid)
    got = {"jax": {}, "port": {}}
    for _ in range(200):
        if not (js.pending or ts.pending):
            break
        for name, s in (("jax", js), ("port", ts)):
            for f in s.step(max_steps=3):
                got[name][f.request_id] = np.asarray(f.tokens)
        assert ts.total_steps == js.total_steps
    assert sorted(got["port"]) == sorted(got["jax"]) == list(range(len(reqs)))
    for rid in got["jax"]:
        np.testing.assert_array_equal(got["port"][rid], got["jax"][rid])


def test_harvest_is_one_read_and_advances_launch_counts():
    """A harvest is one host read, and advances each wrapper's counter by
    the launches the device counted since the last harvest (what graph
    segments launched); capture keeps each branch's counts and puts the
    counters back."""
    cfg, params = _llama("cpu")
    sched = sched_lib.DecodeScheduler(params, cfg, **CHUNKED)
    reads = DeviceLoop.host_reads
    sched._harvest()
    assert DeviceLoop.host_reads == reads + 1 and sched.host_reads == 1
    pa0 = pa_kernel.paged_attention.launches
    fp0 = fp_kernel.flash_prefill.launches
    fv0 = fp_kernel.flash_verify.launches

    def fake_chunk():
        fp_kernel.flash_prefill.launches += cfg.n_layers

    sched._captured_branch(fake_chunk, "chunk")()
    assert fp_kernel.flash_prefill.launches == fp0
    assert sched._per_branch["chunk"] == [0, cfg.n_layers, 0, 0]
    L = cfg.n_layers
    sched.pool.launches.copy_(torch.tensor([5 * L, 3 * L, 0, 2 * L]))
    sched._harvest()
    assert pa_kernel.paged_attention.launches - pa0 == 5 * L
    assert fp_kernel.flash_prefill.launches - fp0 == 3 * L
    assert fp_kernel.flash_verify.launches - fv0 == 2 * L
    sched.pool.launches[0] += L      # one more decode run
    sched._harvest()
    assert pa_kernel.paged_attention.launches - pa0 == 6 * L
    sched._harvest()                 # no new launches: nothing to add
    assert pa_kernel.paged_attention.launches - pa0 == 6 * L
    assert fp_kernel.flash_prefill.launches - fp0 == 3 * L
    assert fp_kernel.flash_verify.launches - fv0 == 2 * L
    pa_kernel.paged_attention.launches = pa0
    fp_kernel.flash_prefill.launches = fp0
    fp_kernel.flash_verify.launches = fv0


def test_loop_lowering_is_chosen_by_device_and_refused_on_the_cpu():
    cfg, params = _llama("cpu")
    sched = sched_lib.DecodeScheduler(params, cfg, **CHUNKED)
    assert sched.loop_impl == "host-read"
    with pytest.raises(ValueError, match="loop"):
        sched_lib.DecodeScheduler(params, cfg, **CHUNKED, loop="eager")
    graph = sched_lib.DecodeScheduler(params, cfg, **CHUNKED, loop="graph")
    assert graph.loop_impl == "cuda-graph:while"
    graph.submit(_reqs(cfg, ((5, 3),))[0][0], max_new=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        graph.step()


def test_launcher_reports_the_loop_lowering():
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                             "cpu", "--slots", "2", "--prompt-len", "8",
                             "--requests", "3", "--max-new-short", "2",
                             "--max-new-long", "4", "--kv", "paged",
                             "--prefill", "chunked", "--chunk-tokens", "4"])
    assert out["loop_impl"] == "host-read"
    assert out["host_reads"] > out["segments"] > 0
    assert out["graph_replays"] == 0


# ----------------------------------------------------------------- card

def _graph_vs_host(params, cfg, kw, reqs):
    runs = {}
    for loop in ("host", "graph"):
        sched = sched_lib.DecodeScheduler(params, cfg, **kw, loop=loop)
        sched.warmup()
        pa0 = pa_kernel.paged_attention.launches
        fp0 = fp_kernel.flash_prefill.launches
        g0 = kvc.PagedView.gather_calls
        fv0 = fp_kernel.flash_verify.launches
        wl0 = core.while_loop.host_reads
        streams = _drive(sched, reqs)
        torch.cuda.synchronize()
        runs[loop] = dict(
            sched=sched, streams=streams,
            launches=(pa_kernel.paged_attention.launches - pa0,
                      fp_kernel.flash_prefill.launches - fp0,
                      kvc.PagedView.gather_calls - g0,
                      fp_kernel.flash_verify.launches - fv0),
            wl_reads=core.while_loop.host_reads - wl0)
    return runs


def _check(runs, reqs):
    h, g = runs["host"], runs["graph"]
    assert g["sched"].loop_impl == "cuda-graph:while"
    assert h["sched"].loop_impl == "host-read"
    for rid, (_, m) in enumerate(reqs):
        assert len(g["streams"][rid]) == m
        np.testing.assert_array_equal(g["streams"][rid], h["streams"][rid])
    gs, hs = g["sched"], h["sched"]
    assert (gs.total_steps, gs.busy_slot_steps) == \
        (hs.total_steps, hs.busy_slot_steps)
    # one host read a segment, one launch a segment, no predicate read
    assert gs.host_reads == gs.segments == gs.graph_replays > 0
    assert hs.host_reads > hs.segments
    assert g["wl_reads"] == 0
    # the launches counted on the device == the eager ones counted in
    # Python == captured counts x device branch runs
    assert g["launches"] == h["launches"]
    runs = dict(chunk=int(gs.pool.chunk_steps),
                decode=int(gs.pool.decode_steps))
    assert list(g["launches"]) == [
        sum(per[i] * runs[k] for k, per in gs._per_branch.items())
        for i in range(len(sched_lib._COUNTED))]
    gs.close()


@pytest.mark.cuda
def test_graph_segment_equals_host_segment_chunked_paged(cuda_device):
    cfg, params = _llama(cuda_device)
    reqs = _reqs(cfg, DENSE_REQS)
    runs = _graph_vs_host(params, cfg, CHUNKED, reqs)
    _check(runs, reqs)
    pa, fp, gathers, verify = runs["graph"]["launches"]
    sched = runs["graph"]["sched"]
    assert pa == int(sched.pool.decode_steps) * cfg.n_layers > 0
    assert fp == int(sched.pool.chunk_steps) * cfg.n_layers > 0
    assert gathers == verify == 0


@pytest.mark.cuda
def test_graph_segment_equals_host_segment_oneshot_dense(cuda_device):
    cfg, params = _llama(cuda_device, "gather")
    reqs = _reqs(cfg, ONESHOT_REQS)
    _check(_graph_vs_host(params, cfg, ONESHOT, reqs), reqs)


@pytest.mark.cuda
def test_graph_segment_equals_host_segment_oneshot_ssm(cuda_device):
    cfg, params = _mamba(cuda_device)
    reqs = _reqs(cfg, SSM_REQS)
    _check(_graph_vs_host(params, cfg, ONESHOT, reqs), reqs)


@pytest.mark.cuda
def test_graph_segment_pauses_for_arrivals_and_caps_steps(cuda_device):
    """``expect_arrivals`` and ``max_steps`` reach the captured
    predicate through the segment's device arguments: the graph and
    host lowerings stop at the same iterations."""
    cfg, params = _llama(cuda_device)
    reqs = _reqs(cfg, DENSE_REQS)
    steps = {}
    for loop in ("host", "graph"):
        sched = sched_lib.DecodeScheduler(params, cfg, **CHUNKED, loop=loop)
        for rid, (p, m) in enumerate(reqs):
            sched.submit(p, max_new=m, request_id=rid)
        trace = []
        while sched.pending:
            sched.step(expect_arrivals=True, max_steps=4)
            trace.append(sched.total_steps)
        steps[loop] = trace
        sched.close()
    assert steps["graph"] == steps["host"]
