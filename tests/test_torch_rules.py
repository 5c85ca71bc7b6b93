"""Rules of the PyTorch port: what it may import, its configs, and the
device its entry points run on by default."""

import ast
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model_zoo
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, require_ported
from repro_torch.examples import dynamic_rnn_nmt
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_prefill import kernel as fp_kernel
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.selective_scan import kernel as ss_kernel
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.serve import engine, kv_cache as kvc
from repro_torch.serve import scheduler as sched_lib

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    """The port, chip_smoke.py, and the card tests (which run on a
    machine without JAX)."""
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "test_torch_card.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_repro(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_port_import_loads_no_jax_or_repro_module():
    """Importing every module of the port, and chip_smoke.py, leaves no
    jax or repro module in sys.modules (a fresh interpreter)."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT.rglob("*.py")]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, env={"PYTHONPATH": str(ROOT / "src") + ":" + str(ROOT),
                        "PATH": "/usr/bin:/bin"}, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_ops_dispatch_has_no_fallback():
    """ops.py picks the kernel for a CUDA tensor and the plain version
    only for a CPU one: no try/except that could fall back."""
    for name in ("paged_attention", "flash_prefill", "selective_scan",
                 "lstm_cell", "flash_attention"):
        tree = ast.parse((PORT / "kernels" / name / "ops.py").read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax_field_for_field(arch, smoke):
    ours = dataclasses.asdict(get_config(arch, smoke=smoke))
    ref = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    ref["attn_impl"] = {"xla": "gather", "pallas": "cuda"}[ref["attn_impl"]]
    if ref["ssm"] is not None:
        ref["ssm"]["scan_impl"] = {"kernel": "cuda"}.get(
            ref["ssm"]["scan_impl"], ref["ssm"]["scan_impl"])
    assert ours == ref
    cfg = get_config(arch, smoke=smoke)
    assert cfg.padded_vocab == jax_get_config(arch, smoke).padded_vocab
    assert cfg.dtype("compute") == torch.bfloat16
    assert cfg.dtype("param") == torch.float32


def test_unported_families_are_refused():
    """Every family of the JAX package loads, the audio family
    (whisper-small) the last of them; ``require_ported`` still refuses
    a family the port does not know, and ``get_config`` an unknown
    arch."""
    cfg = get_config("whisper-small")
    assert (cfg.family, cfg.encoder_layers, cfg.n_frames) == ("audio", 12,
                                                             1500)
    require_ported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        require_ported(dataclasses.replace(cfg, family="video"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_config("zamba2-1.2b")
    assert (cfg.family, cfg.ssm.kind) == ("hybrid", "mamba2")


@pytest.mark.parametrize("call", [
    "init_params", "from_numpy", "make_cache", "make_kv_cache", "serve",
    "make_ssm_cache", "init_lstm_params", "lstm_params_from_numpy", "nmt",
    "launch_train", "init_params_keep_param_dtype", "opt_state_from_numpy"])
def test_entry_points_default_to_cuda(call):
    """Omitting the device means the card: without one, the call raises
    instead of running on the CPU."""
    cfg = get_config("llama3.2-1b", smoke=True)
    calls = {
        "init_params": lambda: bridge.init_params(cfg, seed=0)["embed"],
        "from_numpy": lambda: bridge.from_numpy(
            jax.tree.map(np.asarray, model_zoo.init_params(
                jax_get_config("llama3.2-1b", smoke=True),
                jax.random.PRNGKey(0))), cfg)["embed"],
        "make_cache": lambda: engine.make_cache(cfg, 2, 8)["attn"].k,
        "make_kv_cache": lambda: kvc.make_kv_cache(
            cfg, 1, 2, 8, impl="paged").k_pool,
        "make_ssm_cache": lambda: engine.make_cache(
            get_config("falcon-mamba-7b", smoke=True), 2, 8)["ssm"]["h"],
        "serve": lambda: launch_serve.main(
            ["--arch", "llama3.2-1b", "--smoke", "--requests", "1"]),
        "init_lstm_params": lambda: bridge.init_lstm_params(4, 8)["w"],
        "lstm_params_from_numpy": lambda: bridge.lstm_params_from_numpy(
            {"w": np.zeros((12, 32), np.float32)})["w"],
        "nmt": lambda: dynamic_rnn_nmt.main(["--steps", "1"]),
        "launch_train": lambda: launch_train.main(
            ["--arch", "llama3.2-1b", "--smoke", "--steps", "1"]),
        "init_params_keep_param_dtype": lambda: bridge.init_params(
            cfg, seed=0, keep_param_dtype=True)["embed"],
        "opt_state_from_numpy": lambda: bridge.opt_state_from_numpy(
            (np.int32(0), {"w": np.zeros(2, np.float32)},
             {"w": np.zeros(2, np.float32)})).mu["w"],
    }
    if torch.cuda.is_available():
        out = calls[call]()
        if torch.is_tensor(out):
            assert out.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[call]()


@pytest.mark.parametrize("fn", [pa_kernel.paged_attention,
                                fp_kernel.flash_prefill,
                                fp_kernel.flash_verify,
                                ss_kernel.selective_scan,
                                lstm_kernel.lstm_cell,
                                fa_kernel.flash_attention])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """The kernel wrappers never compute on the CPU: only ops.py picks
    the plain version, and only for CPU tensors."""
    if fn is lstm_kernel.lstm_cell:
        state = torch.zeros(2, 8)
        args = (torch.zeros(12, 32), torch.zeros(32), torch.zeros(2, 4),
                state, state)
    elif fn is fa_kernel.flash_attention:
        kv = torch.zeros(1, 128, 1, 16)
        args = (torch.zeros(1, 128, 2, 16), kv, kv)
    elif fn is ss_kernel.selective_scan:
        seq, state = torch.zeros(1, 4, 128), torch.zeros(1, 4, 8)
        args = (seq, torch.zeros(128, 8), state, state, seq,
                torch.zeros(1, 128, 8))
    else:
        q = torch.zeros(1, 1, 4, 64)
        pool = torch.zeros(3, 4, 1, 64)
        args = (q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert fn.launches == before


def test_ssm_family_is_ported_but_hybrid_is_not():
    """The name is older than the hybrid's port: the mamba1 family and
    the mamba2 hybrid both load, and launch.train trains the hybrid
    (one step, a finite loss); the audio family loads too."""
    cfg = get_config("falcon-mamba-7b")
    assert (cfg.family, cfg.ssm.kind, cfg.d_inner) == ("ssm", "mamba1", 8192)
    assert get_config("whisper-small").family == "audio"
    hyb = get_config("zamba2-1.2b")
    assert (hyb.family, hyb.ssm.kind, hyb.d_inner, hyb.shared_attn_every) \
        == ("hybrid", "mamba2", 4096, 6)
    out = launch_train.main(["--arch", "zamba2-1.2b", "--smoke", "--steps",
                             "1", "--batch", "2", "--seq", "8",
                             "--device", "cpu"])
    assert np.isfinite(float(out["metrics"]["loss"]))
    # the MoE and VLM families load (field for field: above)
    assert {a: get_config(a).family for a in (
        "qwen2-moe-a2.7b", "dbrx-132b", "internvl2-1b")} == {
        "qwen2-moe-a2.7b": "moe", "dbrx-132b": "moe", "internvl2-1b": "vlm"}


def test_one_shot_admission_is_the_default():
    """As in the JAX package, DecodeScheduler admits one-shot unless
    asked for chunked prefill (the launcher's default is run in
    tests/test_torch_oneshot.py)."""
    sig = inspect.signature(sched_lib.DecodeScheduler)
    assert sig.parameters["prefill"].default == "oneshot"


def test_core_is_checked_and_imports_no_jax():
    """The control-flow core is part of the port the import rules cover:
    every module of ``repro_torch.core`` is among the checked files, and
    importing the package alone loads no jax (a fresh interpreter)."""
    names = {p.stem for p in (PORT / "core").glob("*.py")}
    assert {"tensor_array", "stacks", "while_loop", "cond", "higher_order",
            "frames", "primitives", "dataflow_ref"} <= names
    assert all(p in _port_files() for p in (PORT / "core").glob("*.py"))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.core; print("
         "sorted(m for m in sys.modules if m.split('.')[0] in "
         f"{FORBIDDEN!r}))"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_training_modules_are_checked_and_import_no_jax():
    """The fourth slice's modules (the flash-attention kernel, model_zoo,
    the schedules, the data pipeline, checkpoints, the train loop and
    the launcher) are among the checked files, and importing the
    launcher loads no jax (a fresh interpreter)."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
            "kernels/flash_attention/kernel.py", "models/model_zoo.py",
            "optim/schedule.py", "data/pipeline.py",
            "checkpointing/checkpoint.py", "train/train_loop.py",
            "launch/train.py"} <= files
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").exists()
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.launch.train; print("
         "sorted(m for m in sys.modules if m.split('.')[0] in "
         f"{FORBIDDEN!r}))"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_dist_modules_are_checked_and_import_no_jax():
    """The multi-device slice (``dist/`` and the mesh launchers) is
    among the checked files, and importing it loads no jax (a fresh
    interpreter)."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"dist/__init__.py", "dist/sharding.py", "dist/pipeline.py",
            "launch/mesh.py", "launch/distributed.py"} <= files
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.dist, "
         "repro_torch.launch.mesh, repro_torch.launch.distributed; print("
         "sorted(m for m in sys.modules if m.split('.')[0] in "
         f"{FORBIDDEN!r}))"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
