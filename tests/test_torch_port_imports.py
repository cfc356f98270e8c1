"""The port's boundaries: it imports no JAX and nothing of the JAX package,
its entry points run on CUDA unless told otherwise, and a tensor that is
not on the CPU never reaches a kernel's plain version.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pairwise_sample_optimization_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(ROOT)))
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
    assert kernel_lib.launch_counts == {"flash_attn_fwd": 0, "gn_stats": 0, "gn_silu_norm": 0}


def test_each_launch_counts_once(kernel_path):
    from pairwise_sample_optimization_tpu_torch.ops.attention import dot_product_attention
    from pairwise_sample_optimization_tpu_torch.ops.group_norm import group_norm

    o = dot_product_attention(*_meta_attention_inputs())
    assert o.shape == (2, 77, 2, 64)
    w = torch.empty((64,), device="meta")
    group_norm(torch.empty((2, 64, 8, 8), device="meta"), w, w, 32, act="silu")
    group_norm(torch.empty((2, 64, 8, 8), device="meta"), w, w, 32)  # no act: plain, no kernel
    assert kernel_path.calls == ["flash_attn_fwd", "gn_stats", "gn_silu_norm"]
    assert kernel_lib.launch_counts == {"flash_attn_fwd": 1, "gn_stats": 1, "gn_silu_norm": 1}


def test_kernel_sources_and_signatures_line_up():
    """Each C entry point a wrapper declares exists in its source, with as
    many parameters as the wrapper passes (the card is needed to build)."""
    for name, sigs in (("flash_attn_fwd", tfa._SIGNATURES),
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
