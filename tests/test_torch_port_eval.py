"""The port's eval protocol and its scorers vs the JAX package, fp32 on the
CPU: the aesthetic scorer with the released MLP loaded on both sides, CLIP
score and HPS with either preprocessing, ``generate_dmd`` with per-prompt
noise, and the eval CLI on the toy models.

Weights are the JAX package's, carried with ``state_dict_from_jax``; the
per-prompt noise is drawn in JAX as its ``generate_dmd`` draws it and handed
to the port. Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test says otherwise.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.models.clip import CLIPTextConfig as JText
from pairwise_sample_optimization_tpu.models.clip import CLIPVisionConfig as JVision
from pairwise_sample_optimization_tpu.pipeline import SDXLPipeline as JPipeline
from pairwise_sample_optimization_tpu.rewards import AestheticScorer as JAesthetic
from pairwise_sample_optimization_tpu.rewards import CLIPScorer as JCLIP
from pairwise_sample_optimization_tpu.rewards import HPSScorer as JHPS
from pairwise_sample_optimization_tpu.rewards.preprocess import (
    clip_preprocess_max_size as j_max_size)
from pairwise_sample_optimization_tpu_torch.checkpoints import (load_aesthetic_mlp,
                                                                state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.cli import evaluate_sdxl_dmd2 as ev
from pairwise_sample_optimization_tpu_torch.models.clip import (CLIPDualEncoder, CLIPTextConfig,
                                                                CLIPVisionConfig, CLIPVisionTower)
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.rewards import (AestheticMLP, AestheticScorer,
                                                            CLIPScorer, HPSScorer,
                                                            clip_preprocess_max_size,
                                                            packaged_mlp_path)

ATOL, RTOL = 3e-5, 2e-4
STEPS, RES, PROMPTS = 4, 32, 3


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


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


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


def _ids(rng, n, vocab=1000):
    ids = rng.integers(1, vocab - 1, size=(n, 77)).astype(np.int32)
    ids[np.arange(n), rng.integers(5, 70, size=n)] = vocab - 1  # EOS: the highest id
    return ids


# ---------------------------------------------------------------------- #
# scorers
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("hw", [(28, 28), (40, 24), (20, 36), (50, 50)])
def test_max_size_preprocess_matches_jax(hw):
    x = _images((2,) + hw + (3,))
    _close(clip_preprocess_max_size(torch.from_numpy(x), 28), j_max_size(jnp.asarray(x), 28),
           atol=1e-5, rtol=1e-4)


def test_aesthetic_scorer_with_the_packaged_mlp_matches_jax():
    """A toy CLIP-L-shaped tower (quick-gelu, 768-wide embedding) and the
    released MLP, read by each package's own loader."""
    jcfg = dataclasses.replace(JVision.tiny(), act="quick_gelu", projection_dim=768)
    js = JAesthetic(vision_config=jcfg, fast_init=True, use_packaged_mlp=True)
    js.vision_variables = _fill(js.vision_variables, np.random.default_rng(2))
    tcfg = dataclasses.replace(CLIPVisionConfig.tiny(), act="quick_gelu", projection_dim=768)
    vision = CLIPVisionTower(tcfg, device="cpu")
    vision.load_state_dict(state_dict_from_jax(js.vision_variables, "clip_vision"), strict=True)
    mlp = load_aesthetic_mlp(packaged_mlp_path(), AestheticMLP(768, device="cpu"))
    carried = state_dict_from_jax(js.mlp_variables, "aesthetic_mlp")
    assert set(carried) == set(mlp.state_dict())
    for k, v in mlp.state_dict().items():  # the two loaders read the same file alike
        torch.testing.assert_close(carried[k], v, atol=0, rtol=0)
    scorer = AestheticScorer(vision.eval(), mlp.eval())
    x = _images((3, 40, 40, 3), seed=1)
    with torch.no_grad():
        _close(scorer.score(torch.from_numpy(x)), js.score(jnp.asarray(x)))


@pytest.mark.parametrize("preprocess", ["resize", "max_size"])
@pytest.mark.parametrize("cls", [(CLIPScorer, JCLIP), (HPSScorer, JHPS)], ids=["clip", "hps"])
def test_clip_and_hps_scorers_match_jax(cls, preprocess):
    port_cls, jax_cls = cls
    js = jax_cls(text_config=JText.tiny(), vision_config=JVision.tiny(), fast_init=True,
                 preprocess=preprocess)
    js.variables = _fill(js.variables, np.random.default_rng(3))
    model = CLIPDualEncoder(CLIPTextConfig.tiny(), CLIPVisionConfig.tiny(), device="cpu")
    model.load_state_dict(state_dict_from_jax(js.variables, "clip_dual"), strict=True)
    scorer = port_cls(model.eval(), preprocess=preprocess)
    x, ids = _images((3, 36, 24, 3), seed=2), _ids(np.random.default_rng(2), 3)
    with torch.no_grad():
        got = scorer.score(torch.from_numpy(x), torch.from_numpy(ids).long())
    _close(got, js.score(jnp.asarray(x), jnp.asarray(ids)))


# ---------------------------------------------------------------------- #
# generate_dmd and the eval CLI
# ---------------------------------------------------------------------- #


def test_generate_dmd_with_per_prompt_noise_matches_jax():
    """Random conditioning for both sides (the text encoders are held
    against JAX by ``test_torch_port_pipeline.py``)."""
    rng = np.random.default_rng(0)
    jp = JPipeline.random(tiny=True, resolution=RES, lora_rank=4, with_text_encoders=False,
                          fast_init=True)
    # a non-zero LoRA B: the adapter does work
    uvars, vvars = _fill(jp.unet_variables, rng, lora_b_std=0.2), _fill(jp.vae_variables, rng)
    cond = {"embeds": rng.standard_normal((PROMPTS, 77, 32)).astype(np.float32),
            "pooled": rng.standard_normal((PROMPTS, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32),
                                (PROMPTS, 1))}
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(PROMPTS))
    want = jax.jit(lambda uv, vv, c, k: jp.generate_dmd(
        c, None, num_steps=STEPS, sample_keys=k, unet_variables=uv, vae_variables=vv))(
        uvars, vvars, cond, keys)
    # the per-sample draws of the JAX generate_dmd: fold_in(key, 0) the init,
    # fold_in(key, 1 + i) transition i
    hw = RES // 2
    draw = lambda k, i: np.asarray(jax.random.normal(jax.random.fold_in(k, i), (hw, hw, 4),
                                                     jnp.float32))
    init = np.stack([draw(k, 0) for k in keys])
    trans = np.stack([np.stack([draw(k, 1 + i) for k in keys]) for i in range(STEPS - 1)])

    tp = SDXLPipeline.random(tiny=True, resolution=RES, lora_rank=4, dtype=torch.float32,
                             device="cpu", with_scorer=False)
    tp.unet.load_state_dict(state_dict_from_jax(uvars, "unet", n_levels=2), strict=True)
    tp.vae.load_state_dict(state_dict_from_jax(vvars["params"], "vae"), strict=True)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    got = tp.generate_dmd(tcond, num_steps=STEPS, init_noise=torch.from_numpy(init),
                          transition_noise=torch.from_numpy(trans))
    assert got.shape == (PROMPTS, RES, RES, 3)
    _close(got, want)
    # per-sample generators: a sample's noise, and so its image, does not
    # depend on the batch it is drawn in
    gens = lambda idx: [ev.prompt_generator(0, i, "cpu") for i in idx]
    both = tp.generate_dmd(tcond, num_steps=STEPS,
                           sample_generators=gens(range(PROMPTS)))
    one = tp.generate_dmd({k: v[1:2] for k, v in tcond.items()}, num_steps=STEPS,
                          sample_generators=gens([1]))
    _close(one[0], both[1])


def _run_eval(tmp_path, name, *extra):
    out = tmp_path / f"{name}.json"
    summary = ev.main(["--tiny", "--device", "cpu", "--scorers", "pickscore,clip,hps,aesthetic",
                       "--aesthetic_mlp_path", "packaged", "--output_json", str(out), *extra])
    return summary, json.loads(out.read_text())


def test_eval_cli_scores_do_not_depend_on_the_batch_size(tmp_path):
    """Three prompts at batch 1 and at batch 2 (the last batch padded): the
    per-prompt scores agree, and the output JSON has the JAX layout."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red fox\nan astronaut riding a horse\na bowl of ramen\n")
    s1, j1 = _run_eval(tmp_path, "b1", "--prompts_json", str(prompts), "--batch_size", "1")
    s2, j2 = _run_eval(tmp_path, "b2", "--prompts_json", str(prompts), "--batch_size", "2",
                       "--timing")
    assert set(j2) == {"n_prompts", "pickscore_mean", "clip_mean", "hps_mean", "aesthetic_mean",
                       "timing", "per_prompt"}
    assert j2["n_prompts"] == 3
    assert j2["per_prompt"]["prompts"] == ["a red fox", "an astronaut riding a horse",
                                           "a bowl of ramen"]
    assert j2["timing"]["prompts_per_min"] > 0
    for name in ev.SCORERS:
        assert len(j2["per_prompt"][name]) == 3
        _close(np.array(j2["per_prompt"][name]), np.array(j1["per_prompt"][name]))
        assert s2[f"{name}_mean"] == pytest.approx(np.mean(j2["per_prompt"][name]))


def test_eval_cli_warns_when_max_prompts_exceeds_the_source(tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red fox\na blue bird\n")
    with pytest.warns(UserWarning, match="--max_prompts 5 exceeds the 2 prompts"):
        _, out = _run_eval(tmp_path, "m", "--prompts_json", str(prompts), "--max_prompts", "5",
                           "--scorers", "aesthetic")
    assert out["n_prompts"] == 2 and len(out["per_prompt"]["aesthetic"]) == 2


@pytest.mark.parametrize("flag", [
    ["--model_dir", "/x"], ["--lora_path", "/x.safetensors"], ["--hps_path", "/x.pt"],
    ["--hf_dataset", "yuvalkirstain/pickapic_v1_no_images"], ["--scorers", "imagereward"],
    ["--offload_scorers"], ["--score_chunk", "8"], ["--gelu_exact"],
])
def test_eval_cli_refuses_unported_options(flag):
    with pytest.raises(NotImplementedError):
        ev.main(["--tiny", "--device", "cpu", *flag])


def test_round_robin_shards_gather_back_in_order():
    prompts = [f"p{i}" for i in range(7)]
    for world in (1, 2, 3):
        shards = [ev.shard_prompts(prompts, r, world) for r in range(world)]
        assert {len(s) for s in shards} == {-(-7 // world)}  # padded to one length
        assert list(ev.gather_round_robin(shards, 7)) == prompts


def test_chip_smoke_launch_counts_match_the_tiny_eval(tmp_path):
    """The launch counts chip_smoke.py expects of an eval run equal the
    kernel-wrapper calls the tiny eval makes on the CPU (3 prompts at batch
    2: two batches, the second padded), with all four scorers."""
    import importlib.util
    from pathlib import Path

    from pairwise_sample_optimization_tpu_torch.models import UNetConfig, VAEConfig

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red fox\nan astronaut riding a horse\na bowl of ramen\n")
    with cs.ShapeRecorder() as rec:
        _run_eval(tmp_path, "c", "--prompts_json", str(prompts))
    layers = [CLIPVisionConfig.tiny().layers] * 4
    want = cs.expected_eval_launches(UNetConfig.tiny(), VAEConfig.tiny(), STEPS, 2, layers)
    got = {"flash_attn_fwd": sum(rec.attention.values()),
           "flash_attn_bwd_pre": sum(rec.attention_bwd.values()),
           "flash_attn_bwd": sum(rec.attention_bwd.values()),
           "flash_attn_bwd_post": sum(n for (qs, ks, _), n in rec.attention_bwd.items()
                                      if cs.bwd_needs_post(qs, ks[1])),
           "gn_stats": sum(rec.gn.values()), "gn_silu_norm": sum(rec.gn.values())}
    assert got == want
    # the four vision towers (17 tokens: 16 patches and the class token)
    assert rec.attention[((2, 17, 4, 8), (2, 17, 4, 8), torch.float32)] == 2 * 4 * 2


def test_reward_registry_matches_jax_and_refuses_the_jpeg_rewards():
    from pairwise_sample_optimization_tpu.rewards import registry as jreg
    from pairwise_sample_optimization_tpu_torch.rewards import registry as treg

    x = _images((3, 16, 16, 3), seed=4)
    got, meta = treg.get_reward_fn("light_reward")(torch.from_numpy(x))
    _close(got, jreg.get_reward_fn("light_reward")(jnp.asarray(x))[0])
    assert meta == {} and set(treg.REWARD_FNS) == set(jreg.REWARD_FNS)
    for name in ("jpeg_compressibility", "jpeg_incompressibility"):
        with pytest.raises(NotImplementedError, match="JPEG codec"):
            treg.get_reward_fn(name)
    with pytest.raises(KeyError):
        treg.get_reward_fn("no_such_reward")
    aes = ev.build_scorers(["aesthetic"], True, 0, "cpu", aesthetic_mlp_path="packaged")
    with torch.no_grad():
        scores, _ = treg.get_reward_fn("aesthetic_score", scorer=aes["aesthetic"])(
            torch.from_numpy(x))
    assert scores.shape == (3,) and torch.isfinite(scores).all()
