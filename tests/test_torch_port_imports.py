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
from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

PKG = Path(port.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_collections", "absl", "regex",
             "safetensors", "PIL", "datasets", "pyarrow", "pairwise_sample_optimization_tpu")
SUBPACKAGES = ("checkpoints", "cli", "configs", "data", "models", "ops", "parallel", "rewards",
               "train", "utils")


@pytest.fixture(autouse=True, scope="module")
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
        AutoencoderKL, BertConfig, BertEncoder, CLIPDualEncoder, CLIPTextConfig, CLIPTextTower,
        CLIPVisionConfig, CLIPVisionTower, SDXLUNet, UNetConfig, VAEConfig, ViT, ViTConfig)
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.rewards import (AestheticMLP, AestheticScorer,
                                                                CLIPScorer, HPSScorer,
                                                                ImageRewardScorer,
                                                                PickScoreScorer)

    builders = [
        lambda **kw: SDXLPipeline.random(tiny=True, **kw),
        lambda **kw: PickScoreScorer.random(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
        lambda **kw: SDXLUNet(UNetConfig.tiny(), **kw),
        lambda **kw: AutoencoderKL(VAEConfig.tiny(), **kw),
        lambda **kw: CLIPTextTower(CLIPTextConfig.tiny(), **kw),
        lambda **kw: CLIPVisionTower(CLIPVisionConfig.tiny(), **kw),
        lambda **kw: CLIPDualEncoder(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
        lambda **kw: CLIPScorer.random(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
        lambda **kw: HPSScorer.random(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), **kw),
        lambda **kw: AestheticScorer.random(CLIPVisionConfig.tiny(), **kw),
        lambda **kw: AestheticMLP(16, **kw),
        lambda **kw: ViT(ViTConfig.tiny(), **kw),
        lambda **kw: BertEncoder(BertConfig.tiny(), **kw),
        lambda **kw: ImageRewardScorer.random(ViTConfig.tiny(), BertConfig.tiny(), **kw),
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


def test_dmd2_entry_points_default_to_cuda(no_cuda, tmp_path):
    from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2
    from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--tiny", "--epochs", "1", f"output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_sdxl_dmd2.main(["--tiny", "--max_prompts", "2"])
    assert not any(tmp_path.iterdir())


def test_dreambooth_entry_point_defaults_to_cuda(no_cuda, tmp_path):
    """The DreamBooth CLI takes the card unless ``--device cpu`` is given,
    and raises before it writes anything where there is none."""
    import numpy as np

    from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as db
    from pairwise_sample_optimization_tpu_torch.utils.png import write_png

    (tmp_path / "instance").mkdir()
    write_png(str(tmp_path / "instance" / "0.png"), np.zeros((40, 36, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        db.main(["--tiny", "--instance_data_dir", str(tmp_path / "instance"),
                 "--instance_prompt", "a sks dog", "--output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_generate_and_the_checkpoint_loaders_default_to_cuda(no_cuda, tmp_path):
    """``cli/generate.py``, ``SDXLPipeline.from_torch_dir`` and the eval's
    ``--model_dir`` take the card unless told otherwise; on the CPU when
    asked, generate writes its PNGs."""
    from pairwise_sample_optimization_tpu_torch.checkpoints import save_file
    from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2, generate
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--tiny", "--prompt", "a red fox", "--out", str(tmp_path / "g")])
    assert not (tmp_path / "g").exists()
    (tmp_path / "sdxl" / "vae").mkdir(parents=True)
    vae = SDXLPipeline.random(tiny=True, device="cpu", with_scorer=False).vae
    save_file(vae.state_dict(), str(tmp_path / "sdxl" / "vae" / "w.safetensors"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SDXLPipeline.from_torch_dir(str(tmp_path / "sdxl"), tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_sdxl_dmd2.main(["--tiny", "--max_prompts", "1", "--model_dir",
                                 str(tmp_path / "sdxl")])
    SDXLPipeline.from_torch_dir(str(tmp_path / "sdxl"), tiny=True, device="cpu")
    paths = generate.main(["--tiny", "--device", "cpu", "--prompt", "a red fox", "--out",
                           str(tmp_path / "g")])
    assert [Path(p).name for p in paths] == ["000.png"]


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
    for plain in ("absmax_plain", "quantize_rows_plain", "quantize_nhwc_plain", "conv3x3_plain",
                  "dequant_plain"):
        monkeypatch.setattr(tq, plain, plain_reached)
    monkeypatch.setattr(tfa, "_check", lambda *a: None)
    monkeypatch.setattr(tfg, "_check", lambda *a: None)
    monkeypatch.setattr(tq, "_on_cuda", lambda *a, what: True)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(tfa, "_sm_count", lambda index: 132)  # an H100's
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
    assert kernel_lib.launch_counts == {"flash_attn_fwd": 1, "flash_attn_bwd_pre": 0,
                                        "flash_attn_bwd": 0, "flash_attn_bwd_post": 0,
                                        "gn_stats": 1, "gn_silu_norm": 1, "int8_absmax": 0,
                                        "int8_quantize": 0, "int8_conv3x3": 0,
                                        "int8_dequant": 0}


# the int8 wrappers' launches: (call, C entry points in order, counts)
INT8_LAUNCHES = {
    "conv": (lambda x, w, b: tq.int8_conv2d(x, w, b),
             ["q8_absmax", "q8_quantize_rows", "q8_absmax", "q8_quantize_nhwc", "q8_conv3x3"],
             {"int8_absmax": 2, "int8_quantize": 2, "int8_conv3x3": 1}),
    "conv_smoothed": (lambda x, w, b: tq.int8_conv2d(x, w, b, smooth_alpha=0.5),
                      ["q8_absmax", "q8_absmax", "q8_quantize_rows", "q8_absmax",
                       "q8_quantize_nhwc", "q8_conv3x3"],
                      {"int8_absmax": 3, "int8_quantize": 2, "int8_conv3x3": 1}),
    "matmul": (lambda x, w, b: tq.int8_matmul(x.flatten(2).transpose(1, 2), w[:, :, 0, 0], b),
               ["q8_absmax", "q8_absmax", "q8_quantize_rows", "q8_quantize_rows", "q8_dequant"],
               {"int8_absmax": 2, "int8_quantize": 2, "int8_dequant": 1}),
}


@pytest.mark.parametrize("op", list(INT8_LAUNCHES))
def test_int8_wrappers_launch_q1_to_q3_and_count_each_once(kernel_path, op):
    call, calls, counts = INT8_LAUNCHES[op]
    x = torch.empty((2, 32, 8, 8), device="meta", dtype=torch.bfloat16)
    w = torch.empty((48, 32, 3, 3), device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        call(x, w, torch.empty((48,), device="meta", dtype=torch.bfloat16))
    assert kernel_path.calls == calls
    assert {n: c for n, c in kernel_lib.launch_counts.items() if c} == counts
    kernel_path.rc, kernel_path.calls = 700, []
    kernel_lib.reset_launch_counts()
    with pytest.raises(RuntimeError, match="q8_absmax: CUDA error 700"), torch.no_grad():
        call(x, w, None)
    assert set(kernel_lib.launch_counts.values()) == {0}


@pytest.mark.parametrize("m,k,n", [(16, 64, 24), (77, 60, 24), (77, 64, 20)])
def test_int8_refuses_shapes_the_card_does_not_take(kernel_path, m, k, n):
    """Off the CPU, ``torch._int_mm``'s CUDA rules (M > 16, K and N
    multiples of 8) raise naming the layer before any launch, and the conv
    refuses channels its 16-byte loads cannot take."""
    from pairwise_sample_optimization_tpu_torch.models.layers import Int8Linear

    layer = Int8Linear(k, n, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=fr"Int8Linear\({k}, {n}\).*M={m}, K={k}, N={n}"), \
            torch.no_grad():
        layer(torch.empty((1, m, k), device="meta", dtype=torch.bfloat16))
    meta = lambda shape, dt=torch.int8: torch.empty(shape, device="meta", dtype=dt)
    with pytest.raises(ValueError, match="multiples of 16"):
        tq.conv3x3(meta((1, 4, 4, 24)), meta((8, 3, 3, 24)), meta((1,), torch.float32),
                   meta((8,), torch.float32))



def _meta_bwd_inputs(d=64, skv=77, dtype=torch.float32):
    q = torch.empty((2, 64, 2, d), device="meta", dtype=dtype)
    k, v = (torch.empty((2, skv, 2, d), device="meta", dtype=dtype) for _ in range(2))
    o = torch.empty_like(q)
    lse = torch.empty((2, 2, 64), device="meta")
    return q, k, v, o, lse


# (dtype, kv length, the kernels the backward launches): bf16 runs the post
# kernel only where it has an fp32 accumulator (dQ summed over more than one
# block of 128 keys, or dK / dV over a split q loop); fp32 runs the
# two-kernel correctness path after the same pre kernel
BWD_LAUNCHES = [
    (torch.bfloat16, 200, ["flash_attn_bwd_pre", "flash_attn_bwd", "flash_attn_bwd_post"]),
    (torch.bfloat16, 77, ["flash_attn_bwd_pre", "flash_attn_bwd"]),
    (torch.float32, 77, ["flash_attn_bwd_pre", "flash_attn_bwd"]),
]


@pytest.mark.parametrize("dtype,skv,calls", BWD_LAUNCHES)
def test_backward_launches_k2_then_k3_and_counts_each_once(kernel_path, dtype, skv, calls):
    q, k, v, o, lse = _meta_bwd_inputs(skv=skv, dtype=dtype)
    # dO as autograd may hand it over: a non-contiguous view is copied, not refused
    do = torch.empty((2, 64, 2, 64, 2), device="meta", dtype=dtype)[..., 0]
    assert do.stride(3) != 1
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert kernel_path.calls == calls
    assert {n: c for n, c in kernel_lib.launch_counts.items() if c} == {n: 1 for n in calls}


def test_attention_function_backward_goes_through_the_kernels(kernel_path):
    q, k, v, _, _ = _meta_bwd_inputs(skv=200, dtype=torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention(q, k, v)
    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert kernel_path.calls == ["flash_attn_fwd", "flash_attn_bwd_pre", "flash_attn_bwd",
                                 "flash_attn_bwd_post"]


def test_backward_kernel_failure_propagates_and_is_not_counted(kernel_path):
    kernel_path.rc = 700
    q, k, v, o, lse = _meta_bwd_inputs()
    with pytest.raises(RuntimeError, match="flash_attn_bwd_pre: CUDA error 700"):
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.empty_like(q))
    assert set(kernel_lib.launch_counts.values()) == {0}


def test_backward_takes_head_dim_64_only():
    # the backward takes BWD_HEAD_DIMS (40, 64, 80, 160); any other head dim raises
    q, k, v, o, lse = _meta_bwd_inputs(d=48)
    with pytest.raises(ValueError, match=r"head dim 48 of q \(2, 64, 2, 48\)"):
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.empty_like(q))


def test_kernel_sources_and_signatures_line_up():
    """Each C entry point a wrapper declares exists in its source, with as
    many parameters as the wrapper passes (the card is needed to build)."""
    for name, sigs in (("flash_attn_fwd", tfa._SIGNATURES),
                       ("flash_attn_bwd", tfa._BWD_SIGNATURES),
                       ("group_norm_silu", tfg._SIGNATURES), ("int8_conv", tq._SIGNATURES)):
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


def _port_imports(path: Path):
    """(top-level names of absolute imports, port modules imported) of one
    port module; relative imports resolved against its package."""
    tree = ast.parse(path.read_text())
    package = path.relative_to(ROOT).parts[:-1]
    names, local = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1]
            mod = base + tuple((node.module or "").split(".")) if node.module else base
            targets = [mod + (a.name,) for a in node.names] + [mod]
            for t in targets:
                for cand in (ROOT.joinpath(*t).with_suffix(".py"), ROOT.joinpath(*t, "__init__.py")):
                    if cand.exists():
                        local.add(cand)
    return names, local


@pytest.mark.parametrize("entry", ["cli/train_online_pso_sdxl_dmd2.py",
                                   "cli/evaluate_sdxl_dmd2.py",
                                   "checkpoints/scorer_loaders.py", "rewards/aesthetic.py",
                                   "cli/generate.py", "cli/online_runner.py",
                                   "checkpoints/clip_loader.py", "rewards/imagereward.py",
                                   "data/wordpiece.py", "utils/png.py",
                                   "cli/train_pso_sdxl_turbo_dreambooth.py", "data/dreambooth.py",
                                   "train/dreambooth_pso.py", "train/db_validation.py",
                                   "train/prodigy.py", "train/quantized_adam.py",
                                   "train/flat_optim.py", "parallel/collectives.py",
                                   "parallel/multihost.py", "parallel/mesh.py",
                                   "parallel/prng.py", "cli/train_online_pso_sdxl_turbo.py",
                                   "ops/qconv.py", "ops/upsample.py", "ops/ddim.py"])
def test_new_entry_points_need_only_torch_numpy_and_the_stdlib(entry):
    """Every module the entry point reaches, through the port's own imports,
    imports nothing but the port, torch, numpy and the standard library;
    and ``wandb`` in ``utils/logging.py`` alone, which ``MetricLogger``
    tries only under ``use_wandb`` and, where it fails, logs to the JSONL
    alone (``test_torch_port_runner_options.py``), as the JAX package does."""
    seen, todo, outside = set(), [PKG / entry], {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        names, local = _port_imports(path)
        optional = {"wandb"} if path == PKG / "utils" / "logging.py" else set()
        bad = {n for n in names if n not in sys.stdlib_module_names
               and n not in ("torch", "numpy", "__future__", PKG.name)} - optional
        if bad:
            outside[str(path.relative_to(ROOT))] = sorted(bad)
        todo.extend(local)
    assert not outside, outside
    if entry.startswith("cli/"):  # the walk followed the port's imports
        assert PKG / "pipeline.py" in seen and PKG / "ops" / "flash_attention.py" in seen


def test_packaged_assets_are_the_ports_own_copies():
    """The port's packaged assets resolve inside its own tree and hold the
    same bytes as the JAX package's."""
    from pairwise_sample_optimization_tpu_torch.data import (DEFAULT_BPE_PATH,
                                                             imagereward_prompts_path,
                                                             training_prompts_path)
    from pairwise_sample_optimization_tpu_torch.rewards import packaged_mlp_path

    jax_pkg = ROOT / "pairwise_sample_optimization_tpu"
    for path, twin in ((packaged_mlp_path(), "rewards/assets/sac+logos+ava1-l14-linearMSE.pth"),
                       (imagereward_prompts_path(), "data/assets/imagereward_prompt.txt"),
                       (training_prompts_path(), "data/assets/4k_training_prompts.json"),
                       (DEFAULT_BPE_PATH, "data/assets/bpe_simple_vocab_16e6.txt.gz")):
        path = Path(path).resolve()
        assert path.is_relative_to(PKG) and path.is_file(), path
        assert path.read_bytes() == (jax_pkg / twin).read_bytes(), twin


def test_safetensors_modules_are_covered_and_use_no_safetensors_package():
    """The port writes and reads safetensors files itself: its modules for
    it (and for the checkpoints it reads and the PNGs it writes) are among
    those the import tests walk, and none imports the ``safetensors``
    package or PIL (the card's machine has neither)."""
    names = {str(p.relative_to(PKG)) for p in _modules()}
    for mod in ("checkpoints/safetensors_io.py", "checkpoints/lora_safetensors.py",
                "checkpoints/convert.py", "checkpoints/clip_loader.py",
                "checkpoints/scorer_loaders.py", "utils/png.py"):
        assert mod in names
        tree = ast.parse((PKG / mod).read_text())
        imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        imported += [n.module for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not any(m.split(".")[0] in ("safetensors", "PIL") for m in imported), (mod,
                                                                                      imported)
