"""The port's boundaries: it (and ``chip_smoke.py``) imports no JAX,
nothing of the JAX package and none of the packages the card's machine
lacks, its entry points run on CUDA unless told otherwise, and a tensor
that is not on the CPU never reaches a kernel's plain version.
"""

import ast
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pairwise_sample_optimization_tpu_torch as port
from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg
from pairwise_sample_optimization_tpu_torch.ops import kernel_lib

PKG = Path(port.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_collections", "absl", "regex",
             "safetensors", "PIL", "pairwise_sample_optimization_tpu")
SUBPACKAGES = ("checkpoints", "cli", "configs", "data", "models", "ops", "rewards", "train",
               "utils")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return sorted(PKG.rglob("*.py"))


def test_every_subpackage_is_covered():
    covered = {p.relative_to(PKG).parts[0] for p in _modules() if len(p.relative_to(PKG).parts) > 1}
    assert set(SUBPACKAGES) <= covered


@pytest.mark.parametrize("path", _modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in _modules()]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from pairwise_sample_optimization_tpu_torch.models import (
        AutoencoderKL, CLIPDualEncoder, CLIPTextConfig, CLIPTextTower, CLIPVisionConfig,
        CLIPVisionTower, SDXLUNet, UNetConfig, VAEConfig)
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.rewards import PickScoreScorer

    builders = [
        lambda **kw: SDXLPipeline.random(tiny=True, **kw),
        lambda **kw: PickScoreScorer.random(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
        lambda **kw: SDXLUNet(UNetConfig.tiny(), **kw),
        lambda **kw: AutoencoderKL(VAEConfig.tiny(), **kw),
        lambda **kw: CLIPTextTower(CLIPTextConfig.tiny(), **kw),
        lambda **kw: CLIPVisionTower(CLIPVisionConfig.tiny(), **kw),
        lambda **kw: CLIPDualEncoder(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        build(device="cpu")  # the CPU is taken only when asked for


def test_trainer_entry_point_defaults_to_cuda(no_cuda, tmp_path):
    from pairwise_sample_optimization_tpu_torch.cli.online_runner import run_online_pso
    from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import (
        build_config, main)

    config = build_config(tiny=True, overrides=[f"output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_online_pso(config, num_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--tiny", "--epochs", "1", f"output_dir={tmp_path}"])
    _, history, _ = run_online_pso(config, num_epochs=1, device="cpu")
    assert len(history) == 1


class _FakeLib:
    """Stands in for a kernel library: records calls, returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if name == "pso_error_string":
            return lambda code: b"fake failure"

        def fn(*args):
            self.calls.append(name)
            return self.rc

        return fn


@pytest.fixture
def kernel_path(monkeypatch):
    """Meta tensors stand in for CUDA ones: the plain versions are made to
    fail, the device checks and the stream lookup are bypassed, and the
    library is a fake that returns the error code the test sets."""

    def plain_reached(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_attention_plain", plain_reached)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", plain_reached)
    monkeypatch.setattr(tfg, "fused_groupnorm_silu_plain", plain_reached)
    monkeypatch.setattr(tfa, "_check", lambda *a: None)
    monkeypatch.setattr(tfg, "_check", lambda *a: None)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    lib = _FakeLib(rc=0)
    monkeypatch.setattr(kernel_lib, "load", lambda name, sigs: lib)
    kernel_lib.reset_launch_counts()
    yield lib
    kernel_lib.reset_launch_counts()


def _meta_attention_inputs():
    return [torch.empty((2, 77, 2, 64), device="meta") for _ in range(3)]


def test_non_cpu_tensor_without_cuda_raises_instead_of_falling_back(monkeypatch):
    def plain_reached(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_attention_plain", plain_reached)
    monkeypatch.setattr(tfg, "fused_groupnorm_silu_plain", plain_reached)
    from pairwise_sample_optimization_tpu_torch.models.layers import GroupNorm
    from pairwise_sample_optimization_tpu_torch.ops.attention import dot_product_attention

    with pytest.raises(ValueError, match="CUDA"):
        dot_product_attention(*_meta_attention_inputs())
    with pytest.raises(ValueError, match="CUDA"):
        GroupNorm(64, 32, act="silu", dtype=torch.float32).to("meta")(
            torch.empty((2, 64, 8, 8), device="meta"))


def test_kernel_failure_propagates_and_is_not_counted(kernel_path):
    from pairwise_sample_optimization_tpu_torch.ops.attention import dot_product_attention
    from pairwise_sample_optimization_tpu_torch.ops.group_norm import group_norm

    kernel_path.rc = 700
    with pytest.raises(RuntimeError, match="flash_attn_fwd: CUDA error 700: fake failure"):
        dot_product_attention(*_meta_attention_inputs())
    w = torch.empty((64,), device="meta")
    with pytest.raises(RuntimeError, match="gn_stats: CUDA error 700"):
        group_norm(torch.empty((2, 64, 8, 8), device="meta"), w, w, 32, act="silu")
    assert set(kernel_lib.launch_counts.values()) == {0}


def test_each_launch_counts_once(kernel_path):
    from pairwise_sample_optimization_tpu_torch.ops.attention import dot_product_attention
    from pairwise_sample_optimization_tpu_torch.ops.group_norm import group_norm

    o = dot_product_attention(*_meta_attention_inputs())
    assert o.shape == (2, 77, 2, 64)
    w = torch.empty((64,), device="meta")
    group_norm(torch.empty((2, 64, 8, 8), device="meta"), w, w, 32, act="silu")
    group_norm(torch.empty((2, 64, 8, 8), device="meta"), w, w, 32)  # no act: plain, no kernel
    assert kernel_path.calls == ["flash_attn_fwd", "gn_stats", "gn_silu_norm"]
    assert kernel_lib.launch_counts == {"flash_attn_fwd": 1, "flash_attn_bwd_dkv": 0,
                                        "flash_attn_bwd_dq": 0, "gn_stats": 1,
                                        "gn_silu_norm": 1}


def _meta_bwd_inputs(d=64, skv=77):
    q = torch.empty((2, 64, 2, d), device="meta")
    k, v = (torch.empty((2, skv, 2, d), device="meta") for _ in range(2))
    o = torch.empty_like(q)
    lse = torch.empty((2, 2, 64), device="meta")
    return q, k, v, o, lse


def test_backward_launches_k2_then_k3_and_counts_each_once(kernel_path):
    q, k, v, o, lse = _meta_bwd_inputs()
    # dO as autograd may hand it over: a non-contiguous view is copied, not refused
    do = torch.empty((2, 64, 2, 64, 2), device="meta")[..., 0]
    assert do.stride(3) != 1
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert kernel_path.calls == ["flash_attn_bwd_dkv", "flash_attn_bwd_dq"]
    assert kernel_lib.launch_counts["flash_attn_bwd_dkv"] == 1
    assert kernel_lib.launch_counts["flash_attn_bwd_dq"] == 1


def test_attention_function_backward_goes_through_the_kernels(kernel_path):
    q, k, v, _, _ = _meta_bwd_inputs()
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention(q, k, v)
    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert kernel_path.calls == ["flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"]


def test_backward_kernel_failure_propagates_and_is_not_counted(kernel_path):
    kernel_path.rc = 700
    q, k, v, o, lse = _meta_bwd_inputs()
    with pytest.raises(RuntimeError, match="flash_attn_bwd_dkv: CUDA error 700"):
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.empty_like(q))
    assert set(kernel_lib.launch_counts.values()) == {0}


def test_backward_takes_head_dim_64_only():
    q, k, v, o, lse = _meta_bwd_inputs(d=80)
    for kernel in (tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match=r"head dim 80 of q \(2, 64, 2, 80\)"):
            kernel(q, k, v, torch.empty_like(q), lse, lse)


def test_kernel_sources_and_signatures_line_up():
    """Each C entry point a wrapper declares exists in its source, with as
    many parameters as the wrapper passes (the card is needed to build)."""
    for name, sigs in (("flash_attn_fwd", tfa._SIGNATURES),
                       ("flash_attn_bwd", tfa._BWD_SIGNATURES),
                       ("group_norm_silu", tfg._SIGNATURES)):
        src = (kernel_lib.CSRC / kernel_lib.SOURCES[name]).read_text()
        c_api = src[src.index('extern "C" {'):]
        for fn, argtypes in sigs.items():
            start = c_api.index(f"int {fn}(")
            params = c_api[start:c_api.index(")", start)]
            assert params.count(",") + 1 == len(argtypes), fn
            assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
                       for t in argtypes)


def test_group_norm_splits_cover_each_slab():
    for slabs, slab_len in ((256, 40 * 256), (256, 4 * 512 * 512), (32, 8), (1, 24)):
        splits, chunk = tfg._splits(slabs, slab_len)
        assert chunk % 8 == 0 and splits * chunk >= slab_len > (splits - 1) * chunk
