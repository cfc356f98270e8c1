"""The tiny serving slice end to end, port vs the JAX package, fp32 on the
CPU: dual text encode -> a pair of 4-step Euler-ancestral trajectories per
prompt through the LoRA UNet (non-zero B) -> VAE decode -> PickScore ->
winner, as ``bench.py``'s program composes it.

All weights are the JAX pipeline's, carried with ``state_dict_from_jax``;
the init and per-step noise are drawn in JAX exactly as the JAX sampler
draws them and handed to the port.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.models.clip import CLIPTextConfig, CLIPVisionConfig
from pairwise_sample_optimization_tpu.models.sdxl_text import compute_time_ids
from pairwise_sample_optimization_tpu.ops.schedules import make_euler_ancestral_schedule
from pairwise_sample_optimization_tpu.pipeline import SDXLPipeline as JPipeline
from pairwise_sample_optimization_tpu.rewards import PickScoreScorer as JScorer
from pairwise_sample_optimization_tpu.train.sampling import sample_turbo_trajectories
from pairwise_sample_optimization_tpu.utils import init as jinit
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

PROMPTS, STEPS, RES = 3, 4, 32
ATOL, RTOL = 3e-5, 2e-4


def _ids(rng, vocab):
    ids = rng.integers(1, vocab - 1, size=(PROMPTS, 77)).astype(np.int32)
    for i, pos in enumerate(rng.integers(5, 70, size=PROMPTS)):
        ids[i, pos] = vocab - 1  # EOS: the highest id
    return ids


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module (its fixture too): the towers are
    tiny, so a thread pool costs more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill(tree, rng, lora_b_std=0.0):
    """Random values in a zero-initialized flax tree's shapes (much faster
    than running the towers' init): kernels gaussian with std
    1/sqrt(fan_in), norms identity, embeddings and biases small, LoRA A
    gaussian with std 1/rank and B with std ``lora_b_std``."""

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "logit_scale":
            return np.full(shape, 4.6052, np.float32)
        if name == "b":
            std = lora_b_std
        elif name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or "embedding" in name or len(shape) < 2:
            std = 0.02
        else:
            std = 1.0 / math.sqrt(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@contextlib.contextmanager
def _host_zero_init():
    """``fast_init``'s zero-filled JAX params as host arrays: every tower
    built under it is filled with numpy draws (``_fill``) at once, so the
    device zero-fill program JAX would compile for each is not needed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit, "zeros_from_shapes",
                   lambda shapes: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
        yield


@pytest.fixture(scope="module")
def slices():
    rng = np.random.default_rng(0)
    with _host_zero_init():
        jp = JPipeline.random(tiny=True, resolution=RES, lora_rank=4, fast_init=True)
        js = JScorer(text_config=CLIPTextConfig.tiny(), vision_config=CLIPVisionConfig.tiny(),
                     fast_init=True)
    # LoRA B made non-zero so the adapter does work
    uvars = _fill(jp.unet_variables, rng, lora_b_std=0.2)
    for name in ("vae_variables", "te1_variables", "te2_variables"):
        setattr(jp, name, _fill(getattr(jp, name), rng))
    js.variables = _fill(js.variables, rng)
    ids1, ids2 = _ids(rng, 1000), _ids(rng, 1000)
    reward_ids = _ids(rng, 1000)

    # JAX: the composite of bench.py's program at the tiny size
    embeds, pooled = [np.asarray(a) for a in (lambda c: (c["embeds"], c["pooled"]))(
        jax.jit(jp.encode_prompt)(jnp.asarray(ids1), jnp.asarray(ids2)))]
    cond = {"embeds": jnp.concatenate([embeds, embeds]), "pooled": jnp.concatenate([pooled, pooled]),
            "time_ids": compute_time_ids(2 * PROMPTS, RES)}
    k_init, k_step = jax.random.split(jax.random.key(7))
    hw = RES // 2
    init = jax.random.normal(k_init, (2 * PROMPTS, hw, hw, 4), jnp.float32)
    sched = make_euler_ancestral_schedule(STEPS)

    def rollout(uv, vv, c, x, k):
        tr = sample_turbo_trajectories(lambda x, t: jp.unet_apply(uv, x, t, c, 1.0), sched, x, k)
        return tr, jp.decode(tr.final_latents, vv)

    traj, images = jax.jit(rollout)(uvars, jp.vae_variables, cond, init, k_step)
    txt = js.text_features(jnp.asarray(reward_ids))
    scores = jnp.sum(jnp.concatenate([txt, txt]) * js.image_features(images), axis=-1)
    want = {
        "embeds": embeds, "pooled": pooled,
        "latents": np.asarray(traj.latents), "input_latents": np.asarray(traj.input_latents),
        "log_probs": np.asarray(traj.log_probs), "final": np.asarray(traj.final_latents),
        "images": np.asarray(images), "scores": np.asarray(scores),
        "winner": np.asarray(scores[PROMPTS:] >= scores[:PROMPTS]).astype(np.int64),
    }
    step_noise = np.stack([np.asarray(jax.random.normal(k, init.shape, jnp.float32))
                           for k in jax.random.split(k_step, STEPS)])

    # port, same weights
    tp = SDXLPipeline.random(tiny=True, resolution=RES, lora_rank=4, dtype=torch.float32,
                             device="cpu")
    tp.unet.load_state_dict(state_dict_from_jax(uvars, "unet", n_levels=2), strict=True)
    tp.vae.load_state_dict(state_dict_from_jax(jp.vae_variables["params"], "vae"), strict=True)
    tp.te1.load_state_dict(state_dict_from_jax(jp.te1_variables["params"], "clip_text"), strict=True)
    tp.te2.load_state_dict(state_dict_from_jax(jp.te2_variables["params"], "clip_text"), strict=True)
    sp = js.variables["params"]
    tp.scorer.model.load_state_dict({
        **state_dict_from_jax(sp["text"], "clip_text"),
        **state_dict_from_jax(sp["vision"], "clip_vision"),
        "logit_scale": torch.tensor(np.asarray(sp["logit_scale"])),
    }, strict=True)
    tcond = tp.encode_prompt(torch.from_numpy(ids1).long(), torch.from_numpy(ids2).long(),
                             reward_ids=torch.from_numpy(reward_ids).long())
    got = tp.sample_pairs(tcond, num_steps=STEPS, init_noise=torch.from_numpy(np.array(init)),
                          step_noise=torch.from_numpy(step_noise), timings={})
    return want, tcond, got, tp


def test_text_conditioning_matches_jax(slices):
    want, cond, _, _ = slices
    np.testing.assert_allclose(cond["embeds"].numpy(), want["embeds"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cond["pooled"].numpy(), want["pooled"], atol=ATOL, rtol=RTOL)


def test_trajectory_matches_jax(slices):
    want, _, got, _ = slices
    traj = got.trajectory
    assert traj.latents.shape == (STEPS, 2 * PROMPTS, RES // 2, RES // 2, 4)
    assert traj.input_latents.shape == (STEPS - 1,) + traj.latents.shape[1:]
    assert traj.log_probs.shape == (STEPS - 1, 2 * PROMPTS)
    assert torch.isfinite(traj.log_probs).all()
    # latents reach |x| ~ 15 (init_noise_sigma 14.6): same relative bar
    np.testing.assert_allclose(traj.latents.numpy(), want["latents"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(traj.input_latents.numpy(), want["input_latents"], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(traj.final_latents.numpy(), want["final"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(traj.log_probs.numpy(), want["log_probs"], atol=ATOL, rtol=RTOL)


def test_images_scores_and_winner_match_jax(slices):
    want, _, got, _ = slices
    assert got.images.shape == (2 * PROMPTS, RES, RES, 3)
    np.testing.assert_allclose(got.images.numpy(), want["images"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.scores.numpy(), want["scores"], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.winner.numpy(), want["winner"])


def test_ties_go_to_trajectory_one(slices, monkeypatch):
    _, cond, _, tp = slices
    scores = torch.tensor([0.3, 0.5, 0.2, 0.3, 0.4, 0.2])
    monkeypatch.setattr(tp.scorer, "score_with_text_features", lambda images, txt: scores)
    out = tp.sample_pairs(cond, generator=torch.Generator().manual_seed(0), num_steps=2)
    assert out.winner.tolist() == [1, 0, 1]
    assert out.trajectory.log_probs.shape == (1, 2 * PROMPTS)


def test_slice_meets_the_kernels_layout_preconditions(slices, monkeypatch):
    """Every tensor the slice hands a kernel wrapper has the layout the CUDA
    kernels take (they raise on others): contiguous NCHW with H*W % 8 == 0
    for GroupNorm+SiLU; unit last-dim stride and 16-byte row strides for
    attention."""
    from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
    from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg

    _, cond, _, tp = slices
    seen = {"attention": 0, "gn": 0}
    fwd, gn = tfa.flash_attention_fwd, tfg.fused_groupnorm_silu

    def attention(q, k, v, scale=None):
        for t in (q, k, v):
            assert t.stride(3) == 1 and all(s % (16 // t.element_size()) == 0
                                            for s in t.stride()[:3]), t.stride()
        seen["attention"] += 1
        return fwd(q, k, v, scale)

    def gn_silu(x, weight, bias, num_groups, eps=1e-5):
        assert x.is_contiguous() and (x.numel() // (x.shape[0] * x.shape[1])) % 8 == 0, (
            x.shape, x.stride())
        seen["gn"] += 1
        return gn(x, weight, bias, num_groups, eps)

    monkeypatch.setattr(tfa, "flash_attention_fwd", attention)
    monkeypatch.setattr(tfg, "fused_groupnorm_silu", gn_silu)
    tp.sample_pairs(cond, generator=torch.Generator().manual_seed(1), num_steps=STEPS)
    assert seen["attention"] and seen["gn"]
