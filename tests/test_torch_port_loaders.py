"""The port's checkpoint loaders vs the JAX package's, fp32 on the CPU:
``load_torch_state_dict`` on files the ``safetensors`` package and
``torch.save`` wrote, ``SDXLPipeline.from_torch_dir`` on a tiny
diffusers-layout directory written from the JAX towers with
``flax_to_torch``, the open_clip -> HF CLIP conversion with the scorers it
loads, and the aesthetic scorer's CLIP-L tower.

Inputs are made from a seed with numpy. Tolerance: ATOL 3e-5 / RTOL 2e-4
unless a test says otherwise.
"""

import functools
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from pairwise_sample_optimization_tpu.checkpoints import clip_loader as jcl
from pairwise_sample_optimization_tpu.checkpoints import convert as jconv
from pairwise_sample_optimization_tpu.checkpoints import scorer_loaders as jsl
from pairwise_sample_optimization_tpu.checkpoints import torch_names as jnames
from pairwise_sample_optimization_tpu.models.clip import CLIPTextConfig as JText
from pairwise_sample_optimization_tpu.models.clip import CLIPVisionConfig as JVision
from pairwise_sample_optimization_tpu.models.clip import CLIPVisionTower as JVisionTower
from pairwise_sample_optimization_tpu.models.sdxl_text import compute_time_ids
from pairwise_sample_optimization_tpu.ops.schedules import make_euler_ancestral_schedule
from pairwise_sample_optimization_tpu.pipeline import SDXLPipeline as JPipeline
from pairwise_sample_optimization_tpu.rewards import PickScoreScorer as JPickScore
from pairwise_sample_optimization_tpu.train.sampling import sample_turbo_trajectories
from pairwise_sample_optimization_tpu_torch.checkpoints import (is_openclip_format, load_clip_dual,
                                                                load_clip_vision,
                                                                load_torch_state_dict,
                                                                load_weights, openclip_to_hf_clip)
from pairwise_sample_optimization_tpu_torch.models.clip import (CLIPDualEncoder, CLIPTextConfig,
                                                                CLIPVisionConfig, CLIPVisionTower)
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.rewards import HPSScorer, PickScoreScorer

ATOL, RTOL = 3e-5, 2e-4
RES, STEPS, PROMPTS = 32, 4, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _fill(tree, rng):
    """Random values in a zero-initialized flax tree's shapes: kernels
    gaussian with std 1/sqrt(fan_in), norms identity, embeddings and biases
    small, LoRA A gaussian with std 1/rank and B zero (a fresh adapter)."""

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "logit_scale":
            return np.full(shape, 4.6052, np.float32)
        if name == "b":
            return np.zeros(shape, np.float32)
        if name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or "embedding" in name or len(shape) < 2:
            std = 0.02
        else:
            std = 1.0 / math.sqrt(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _ids(rng, n, vocab=1000):
    ids = rng.integers(1, vocab - 1, size=(n, 77)).astype(np.int32)
    ids[np.arange(n), rng.integers(5, 70, size=n)] = vocab - 1  # EOS: the highest id
    return ids


# ---------------------------------------------------------------------- #
# load_torch_state_dict
# ---------------------------------------------------------------------- #


def _write_weights(kind, tmp_path, arrays):
    """Write ``arrays`` (numpy, fp32) as ``kind``; returns the path to load."""
    if kind in ("f32", "f16"):
        path = tmp_path / "w.safetensors"
        st_save_numpy({k: a.astype(np.float16 if kind == "f16" else np.float32)
                       for k, a in arrays.items()}, str(path))
    elif kind == "bf16":
        path = tmp_path / "w.safetensors"
        st_save_torch({k: torch.from_numpy(a).to(torch.bfloat16) for k, a in arrays.items()},
                      str(path))
    elif kind == "bin":
        path = tmp_path / "w.bin"
        torch.save({"state_dict": {k: torch.from_numpy(a) for k, a in arrays.items()}}, path)
    else:  # an HF snapshot directory: model.safetensors wins over pytorch_model.bin
        path = tmp_path / "snapshot"
        path.mkdir()
        st_save_numpy(arrays, str(path / "model.safetensors"))
        torch.save({k: torch.zeros(a.shape) for k, a in arrays.items()},
                   path / "pytorch_model.bin")
        st_save_numpy({"other": np.zeros(2, np.float32)}, str(path / "a.safetensors"))
    return str(path)


@pytest.mark.parametrize("kind", ["f32", "f16", "bf16", "bin", "snapshot"])
def test_load_torch_state_dict_matches_jax(tmp_path, kind):
    r = np.random.default_rng(0)
    arrays = {"w": r.standard_normal((4, 6)).astype(np.float32),
              "b": r.standard_normal((6,)).astype(np.float32),
              "emb.weight": r.standard_normal((3, 2, 5)).astype(np.float32)}
    path = _write_weights(kind, tmp_path, arrays)
    got, want = load_torch_state_dict(path), jconv.load_torch_state_dict(path)
    assert set(got) == set(want) == set(arrays)
    for k, w in want.items():
        t = got[k]
        assert t.device.type == "cpu" and t.dtype == {"f16": torch.float16,
                                                      "bf16": torch.bfloat16}.get(kind,
                                                                                  torch.float32)
        g = t.numpy() if t.dtype != torch.bfloat16 else t.float().numpy()
        if t.dtype == torch.bfloat16:  # JAX gives bf16 as ml_dtypes' bfloat16 or upcast to fp32
            w = np.asarray(w, np.float32)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    on_meta = load_torch_state_dict(path, device="meta")  # the device path, without a card
    assert all(on_meta[k].is_meta and on_meta[k].shape == got[k].shape for k in got)


def test_load_torch_state_dict_finds_the_weight_file_of_a_directory(tmp_path):
    st_save_numpy({"x": np.ones(2, np.float32)}, str(tmp_path / "b.safetensors"))
    torch.save({"x": torch.zeros(2)}, tmp_path / "pytorch_model.bin")
    assert load_torch_state_dict(str(tmp_path))["x"].sum() == 0  # pytorch_model.bin first
    (tmp_path / "pytorch_model.bin").unlink()
    assert load_torch_state_dict(str(tmp_path))["x"].sum() == 2  # else the first weight file
    (tmp_path / "b.safetensors").unlink()
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path))


# ---------------------------------------------------------------------- #
# SDXLPipeline.from_torch_dir
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def diffusers_dir(tmp_path_factory):
    """A tiny diffusers-layout checkpoint written from random JAX towers:
    ``unet/`` and ``vae/`` (the encoder too) as safetensors, ``text_encoder/``
    as safetensors with an HF ``position_ids`` buffer, ``text_encoder_2/`` as
    a torch ``.bin``."""
    rng = np.random.default_rng(0)
    jp = JPipeline.random(tiny=True, resolution=RES, lora_rank=4, fast_init=True,
                          dtype=jnp.float32)
    n_vae = len(jp.vae.config.block_out_channels)
    towers = [
        ("unet", "diffusion_pytorch_model.safetensors", jp.unet_variables,
         functools.partial(jnames.unet_param_map, n_levels=2)),
        ("vae", "diffusion_pytorch_model.safetensors", jp.vae_variables,
         functools.partial(jnames.vae_param_map, n_levels=n_vae)),
        ("text_encoder", "model.safetensors", jp.te1_variables, jnames.clip_text_param_map),
        ("text_encoder_2", "pytorch_model.bin", jp.te2_variables, jnames.clip_text_param_map),
    ]
    root = tmp_path_factory.mktemp("diffusers")
    for folder, name, variables, name_map in towers:
        sd = jconv.flax_to_torch(_fill(variables["params"], rng), name_map)
        (root / folder).mkdir()
        if folder == "text_encoder":
            sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        if name.endswith(".bin"):
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / folder / name)
        else:
            st_save_numpy(sd, str(root / folder / name))
    return root


def test_from_torch_dir_matches_jax(diffusers_dir):
    """Encode, one 4-step Turbo generation with the same explicit noise and
    the decode, with LoRA B zero on both sides (each side's fresh adapter)."""
    jl = JPipeline.from_torch_dir(str(diffusers_dir), lora_rank=4, dtype=jnp.float32,
                                  resolution=RES, tiny=True)
    tp = SDXLPipeline.from_torch_dir(str(diffusers_dir), lora_rank=4, dtype=torch.float32,
                                     resolution=RES, tiny=True, device="cpu", with_scorer=False)
    lora = {k: v for k, v in tp.unet.state_dict().items() if ".lora." in k}
    assert lora and all(float(v.abs().max()) == 0 for k, v in lora.items() if ".up." in k)
    assert all(float(v.abs().max()) > 0 for k, v in lora.items() if ".down." in k)

    rng = np.random.default_rng(1)
    ids1, ids2 = _ids(rng, PROMPTS), _ids(rng, PROMPTS)
    jcond = jl.encode_prompt(jnp.asarray(ids1), jnp.asarray(ids2))
    jcond = {"embeds": jcond["embeds"], "pooled": jcond["pooled"],
             "time_ids": compute_time_ids(PROMPTS, RES)}
    k_init, k_step = jax.random.split(jax.random.key(3))
    hw = RES // 2
    init = jax.random.normal(k_init, (PROMPTS, hw, hw, 4), jnp.float32)
    sched = make_euler_ancestral_schedule(STEPS)

    def rollout(uv, vv, c, x, k):
        tr = sample_turbo_trajectories(lambda x, t: jl.unet_apply(uv, x, t, c, 1.0), sched, x, k)
        return tr.final_latents, jl.decode(tr.final_latents, vv)

    final, images = jax.jit(rollout)(jl.unet_variables, jl.vae_variables, jcond, init, k_step)
    step_noise = np.stack([np.asarray(jax.random.normal(k, init.shape, jnp.float32))
                           for k in jax.random.split(k_step, STEPS)])

    cond = tp.encode_prompt(torch.from_numpy(ids1).long(), torch.from_numpy(ids2).long())
    _close(cond["embeds"], jcond["embeds"])
    _close(cond["pooled"], jcond["pooled"])
    traj = tp.rollout(cond, init_noise=torch.from_numpy(np.array(init)),
                      step_noise=torch.from_numpy(step_noise), num_steps=STEPS)
    _close(traj.final_latents, final)
    got = tp.decode(traj.final_latents)
    assert got.shape == (PROMPTS, RES, RES, 3)
    _close(got, images)


def test_from_torch_dir_is_strict_and_reads_past_extra_keys(diffusers_dir, tmp_path, caplog):
    kw = dict(lora_rank=4, dtype=torch.float32, resolution=RES, tiny=True, device="cpu",
              with_scorer=False)
    with pytest.raises(FileNotFoundError):
        SDXLPipeline.from_torch_dir(str(tmp_path / "missing"), **kw)
    vae = load_torch_state_dict(str(diffusers_dir / "vae" / "diffusion_pytorch_model.safetensors"))
    tp = SDXLPipeline.random(**kw)
    # the VAE's encoder and quant_conv are ported: every key of the file is
    # read, and only a key the module has no place for is read past
    unused = load_weights(tp.vae, {**vae, "extra.weight": torch.zeros(1)})
    assert unused == ["extra.weight"]
    own = tp.vae.state_dict()
    assert any(k.startswith("encoder.") for k in vae) and "quant_conv.weight" in vae
    assert all(torch.equal(own[k], v) for k, v in vae.items() if k.startswith(("encoder.",
                                                                              "quant_conv.")))
    key = next(k for k in vae if k.startswith("decoder."))
    with pytest.raises(KeyError, match="missing"):
        load_weights(tp.vae, {k: v for k, v in vae.items() if k != key})
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_weights(tp.vae, {**vae, key: torch.zeros(vae[key].numel() + 1)})
    (tmp_path / "only_unet").mkdir()
    (tmp_path / "only_unet" / "unet").symlink_to(diffusers_dir / "unet")
    logger = logging.getLogger("pso.pipeline")  # the port's loggers do not propagate
    logger.addHandler(caplog.handler)
    try:
        SDXLPipeline.from_torch_dir(str(tmp_path / "only_unet"), **kw)
    finally:
        logger.removeHandler(caplog.handler)
    assert "no weights under vae -- its tower stays random" in caplog.text


# ---------------------------------------------------------------------- #
# CLIP dual encoders (PickScore, HPS) and the aesthetic scorer's tower
# ---------------------------------------------------------------------- #


def _openclip_state_dict(rng):
    """A tiny open_clip CLIP state dict (``JText.tiny()`` / ``JVision.tiny()``
    widths) in numpy."""
    t, v = JText.tiny(), JVision.tiny()
    shapes = {"logit_scale": (), "token_embedding.weight": (t.vocab_size, t.width),
              "positional_embedding": (t.max_positions, t.width),
              "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
              "text_projection": (t.width, t.projection_dim),
              "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
              "visual.class_embedding": (v.width,),
              "visual.positional_embedding": ((v.image_size // v.patch_size) ** 2 + 1, v.width),
              "visual.proj": (v.width, v.projection_dim)}
    for norm in ("ln_pre", "ln_post"):
        shapes.update({f"visual.{norm}.weight": (v.width,), f"visual.{norm}.bias": (v.width,)})
    for prefix, cfg in (("", t), ("visual.", v)):
        w = cfg.width
        for i in range(cfg.layers):
            b = f"{prefix}transformer.resblocks.{i}"
            shapes.update({f"{b}.ln_1.weight": (w,), f"{b}.ln_1.bias": (w,),
                           f"{b}.ln_2.weight": (w,), f"{b}.ln_2.bias": (w,),
                           f"{b}.attn.in_proj_weight": (3 * w, w),
                           f"{b}.attn.in_proj_bias": (3 * w,),
                           f"{b}.attn.out_proj.weight": (w, w), f"{b}.attn.out_proj.bias": (w,),
                           f"{b}.mlp.c_fc.weight": (4 * w, w), f"{b}.mlp.c_fc.bias": (4 * w,),
                           f"{b}.mlp.c_proj.weight": (w, 4 * w), f"{b}.mlp.c_proj.bias": (w,)})

    def value(k, shape):
        if k == "logit_scale":
            return np.full(shape, 4.6052, np.float32)
        if k.endswith(".weight") and len(shape) == 1:  # a norm's scale
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.02 if len(shape) < 2 or "embedding" in k else 1 / math.sqrt(t.width)
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {k: value(k, s) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def clip_weights(tmp_path_factory):
    """The open_clip dict (HPS's layout) as a ``.pt`` under ``state_dict``,
    its HF conversion as a snapshot directory with ``position_ids`` buffers
    (PickScore's layout), and one JAX dual-encoder scorer to load them."""
    sd = _openclip_state_dict(np.random.default_rng(5))
    root = tmp_path_factory.mktemp("clip")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / "HPS_v2_compressed.pt")
    hf = jcl.openclip_to_hf_clip(sd)
    hf = {k: np.ascontiguousarray(v) for k, v in hf.items()}
    for tower, n in (("text_model", 77), ("vision_model", hf[
            "vision_model.embeddings.position_embedding.weight"].shape[0])):
        hf[f"{tower}.embeddings.position_ids"] = np.arange(n, dtype=np.int64)[None]
    (root / "pickscore").mkdir()
    st_save_numpy(hf, str(root / "pickscore" / "model.safetensors"))
    js = JPickScore(text_config=JText.tiny(), vision_config=JVision.tiny(), fast_init=True)
    return sd, root, js


def test_openclip_to_hf_clip_equals_jax(clip_weights):
    sd, _, _ = clip_weights
    want = jcl.openclip_to_hf_clip(sd)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert is_openclip_format(tsd) and jcl.is_openclip_format(sd)
    got = openclip_to_hf_clip(tsd)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.shape(w) and np.array_equal(got[k].numpy(),
                                                                     np.asarray(w)), k


@pytest.mark.parametrize("source,cls", [("HPS_v2_compressed.pt", HPSScorer),
                                        ("pickscore", PickScoreScorer)], ids=["hps", "pickscore"])
def test_load_clip_dual_scores_match_jax(clip_weights, source, cls):
    _, root, js = clip_weights
    path = str(root / source)
    js.variables = jcl.load_hf_clip_dual(path, js.variables)
    model = CLIPDualEncoder(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), device="cpu")
    scorer = cls(load_clip_dual(path, model).eval())
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (3, 40, 40, 3)).astype(np.float32)
    ids = _ids(rng, 3)
    with torch.no_grad():
        got = scorer.score(torch.from_numpy(x), torch.from_numpy(ids).long())
    _close(got, js.score(jnp.asarray(x), jnp.asarray(ids)))


def test_load_clip_vision_matches_jax(clip_weights):
    """The aesthetic scorer's tower from an HF ``CLIPModel`` dict (its text
    half read past)."""
    _, root, _ = clip_weights
    path = str(root / "pickscore")
    jt = JVisionTower(JVision.tiny())
    abstract = jax.eval_shape(jt.init, jax.random.key(0), jnp.zeros((1, 28, 28, 3)))
    jvars = jsl.load_clip_vision(path, abstract)
    tower = load_clip_vision(path, CLIPVisionTower(CLIPVisionConfig.tiny(), device="cpu"))
    x = np.random.default_rng(7).standard_normal((2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        got = tower(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    _close(got, jt.apply(jvars, jnp.asarray(x)))
