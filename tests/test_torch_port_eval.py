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


@pytest.fixture(autouse=True, scope="module")
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
    summary = ev.main(["--tiny", "--device", "cpu", "--scorers", ",".join(ev.SCORERS),
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
                       "imagereward_mean", "timing", "per_prompt"}
    assert j2["n_prompts"] == 3
    assert j2["per_prompt"]["prompts"] == ["a red fox", "an astronaut riding a horse",
                                           "a bowl of ramen"]
    assert j2["timing"]["prompts_per_min"] > 0
    for name in ev.SCORERS:
        assert len(j2["per_prompt"][name]) == 3
        _close(np.array(j2["per_prompt"][name]), np.array(j1["per_prompt"][name]))
        assert s2[f"{name}_mean"] == pytest.approx(np.mean(j2["per_prompt"][name]))


def test_eval_cli_chunked_and_offloaded_scores_equal_the_default(tmp_path):
    """Five prompts at batch 2 with ``--score_chunk 3 --offload_scorers
    --gelu_exact`` (a chunk of two batches, then one of a padded batch; the
    scorers' moves are no-ops on the CPU; fp32 takes the exact GELU anyway):
    every per-prompt score equals the run without them bit for bit (the JAX
    package's ``--score_chunk`` promise), and the timing reports the chunk.
    Both decode one image a VAE call (``--vae_decode_chunk 1``, the default
    at 1024^2): the CPU's convolutions pick their kernels by batch size, so
    a decode of 2 differs in the last bits (``test_torch_port_memory_options``)."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red fox\nan astronaut\na bowl of ramen\na cat\na tree\n")
    _, base = _run_eval(tmp_path, "base", "--prompts_json", str(prompts), "--vae_decode_chunk",
                        "1")
    _, chunked = _run_eval(tmp_path, "chunked", "--prompts_json", str(prompts), "--timing",
                           "--score_chunk", "3", "--offload_scorers", "--vae_decode_chunk", "1",
                           "--gelu_exact")
    assert chunked["timing"]["score_chunk"] == 4 and set(chunked["timing"]["stage_s"]) == set(
        ev.SCORERS)
    for name in ev.SCORERS:
        assert chunked["per_prompt"][name] == base["per_prompt"][name], name
    ev.set_gelu_exact(False)


def test_eval_cli_warns_when_max_prompts_exceeds_the_source(tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red fox\na blue bird\n")
    with pytest.warns(UserWarning, match="--max_prompts 5 exceeds the 2 prompts"):
        _, out = _run_eval(tmp_path, "m", "--prompts_json", str(prompts), "--max_prompts", "5",
                           "--scorers", "aesthetic")
    assert out["n_prompts"] == 2 and len(out["per_prompt"]["aesthetic"]) == 2


@pytest.mark.parametrize("flag,error", [
    (["--model_dir", "/x"], FileNotFoundError), (["--lora_path", "/x.safetensors"],
                                                 FileNotFoundError),
    (["--scorers", "hps", "--hps_path", "/x.pt"], FileNotFoundError),
    (["--hf_dataset", "yuvalkirstain/pickapic_v1_no_images"], NotImplementedError),
    (["--score_chunk", "90", "--resolution", "1024"], ValueError),
    (["--score_chunk", "90000", "--batch_size", "4"], ValueError),
    (["--vae_decode_chunk", "3", "--batch_size", "4"], ValueError),
    (["--scorers", "pickscore,bogus"], ValueError),
])
def test_eval_cli_refuses_unported_options(flag, error):
    """The options still unported are refused, the ported weight flags
    refuse a file that is not there, a ``--score_chunk`` whose buffered fp32
    images pass ``SCORE_CHUNK_CAP_BYTES`` is refused (90 prompts at 1024^2;
    90000 at the tiny 32^2), as is a decode chunk that does not divide the
    batch."""
    with pytest.raises(error):
        ev.main(["--tiny", "--device", "cpu", "--max_prompts", "2", *flag])


def _write_weights(tmp_path):
    """The tiny eval's own random towers (``--seed 0``) written as the files
    its weight flags take: a diffusers directory, HF ``CLIPModel`` files for
    PickScore, CLIP and HPS, the CLIP-L tower, and a BLIP-layout ImageReward
    checkpoint (token types zero, so the fold changes nothing). HPS comes
    from another seed, so its scores must move."""
    from pairwise_sample_optimization_tpu_torch.checkpoints import save_file

    pipe = SDXLPipeline.random(tiny=True, resolution=RES, lora_rank=16, dtype=torch.float32,
                               device="cpu", with_scorer=False)
    frozen = lambda m: {k: v for k, v in m.state_dict().items() if ".lora." not in k}
    for folder, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.te1),
                           ("text_encoder_2", pipe.te2)):
        (tmp_path / "sdxl" / folder).mkdir(parents=True)
        save_file(frozen(module), str(tmp_path / "sdxl" / folder / "weights.safetensors"))
    scorers = ev.build_scorers(list(ev.SCORERS), True, 0, "cpu")
    other = ev.build_scorers(["hps"], True, 7, "cpu")["hps"]
    paths = {}
    for name, module in (("pickscore", scorers["pickscore"].model),
                         ("clip", scorers["clip"].model), ("hps", other.model),
                         ("aesthetic", scorers["aesthetic"].vision)):
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_file(module.state_dict(), paths[name])
    ir = scorers["imagereward"]
    blip = {**{"blip.visual_encoder." + k: v for k, v in ir.vit.state_dict().items()},
            **{"blip.text_encoder." + k: v for k, v in ir.bert.state_dict().items()},
            **{"mlp." + k: v for k, v in ir.mlp.state_dict().items()},
            "blip.text_encoder.embeddings.token_type_embeddings.weight":
                torch.zeros(2, ir.bert.config.hidden)}
    paths["imagereward"] = str(tmp_path / "ImageReward.pt")
    torch.save(blip, paths["imagereward"])
    return paths


def test_eval_cli_weight_flags_load_each_tower(tmp_path):
    """Every weight flag at once, on files holding the tiny eval's own
    random towers: the scores equal the run without flags, but HPS's (its
    file holds another seed's tower)."""
    paths = _write_weights(tmp_path)
    common = ("--max_prompts", "3")
    _, plain = _run_eval(tmp_path, "plain", *common)
    _, loaded = _run_eval(tmp_path, "loaded", *common, "--model_dir", str(tmp_path / "sdxl"),
                          "--pickscore_dir", paths["pickscore"], "--clip_dir", paths["clip"],
                          "--hps_path", paths["hps"], "--aesthetic_clip_dir", paths["aesthetic"],
                          "--imagereward_path", paths["imagereward"])
    for name in ev.SCORERS:
        got, want = np.array(loaded["per_prompt"][name]), np.array(plain["per_prompt"][name])
        if name == "hps":
            assert np.abs(got - want).max() > 1e-4
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_eval_cli_with_a_trained_lora_differs_from_without(tmp_path):
    """``--lora_path`` of the adapter a tiny DMD2 run trains (one update at a
    large learning rate) changes the scores."""
    from pairwise_sample_optimization_tpu_torch.checkpoints import LORA_FILE
    from pairwise_sample_optimization_tpu_torch.cli import online_runner
    from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 import build_config

    config = build_config(True, [f"output_dir={tmp_path}", "run_name=t",
                                 "train.learning_rate=0.05"])
    online_runner.run_online_pso(config, sampler="dmd", num_epochs=1, device="cpu")
    lora = f"{online_runner.run_dir(config, 'dmd')}/lora-1/{LORA_FILE}"
    common = ("--max_prompts", "2", "--lora_rank", "4", "--scorers", "pickscore,imagereward")
    _, base = _run_eval(tmp_path, "base", *common)
    _, tuned = _run_eval(tmp_path, "tuned", *common, "--lora_path", lora)
    for name in ("pickscore", "imagereward"):
        assert np.abs(np.array(base["per_prompt"][name])
                      - np.array(tuned["per_prompt"][name])).min() > 0, name


def test_round_robin_shards_gather_back_in_order(monkeypatch):
    """``shard_prompts`` and the eval's gather, ``parallel.round_robin_gather``,
    at worlds 1-3: the gather of the ranks' padded shards (here their stack,
    as ``process_allgather`` returns it) is the prompts in order."""
    from pairwise_sample_optimization_tpu_torch.parallel import collectives

    prompts = [f"p{i}" for i in range(7)]
    for world in (1, 2, 3):
        shards = [ev.shard_prompts(prompts, r, world) for r in range(world)]
        assert {len(s) for s in shards} == {-(-7 // world)}  # padded to one length
        monkeypatch.setattr(collectives, "process_allgather", lambda local: np.asarray(shards))
        assert list(collectives.round_robin_gather(np.asarray(shards[0]), 7)) == prompts


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
    from pairwise_sample_optimization_tpu_torch.models import BertConfig, ViTConfig

    layers = [CLIPVisionConfig.tiny().layers] * 4 + [ViTConfig.tiny().layers
                                                     + BertConfig.tiny().layers]
    want = cs.expected_eval_launches(UNetConfig.tiny(), VAEConfig.tiny(), STEPS, 2, layers)
    got = {"flash_attn_fwd": sum(rec.attention.values()),
           "flash_attn_bwd_pre": sum(rec.attention_bwd.values()),
           "flash_attn_bwd": sum(rec.attention_bwd.values()),
           "flash_attn_bwd_post": sum(n for (qs, ks, _), n in rec.attention_bwd.items()
                                      if cs.bwd_needs_post(qs, ks[1])),
           "gn_stats": sum(rec.gn.values()), "gn_silu_norm": sum(rec.gn.values()),
           **rec.int8_launches()}
    assert got == want
    # the four CLIP vision towers and ImageReward's ViT (17 tokens: 16 patches
    # and the class token), and BERT's cross-attention from its 35 tokens
    assert rec.attention[((2, 17, 4, 8), (2, 17, 4, 8), torch.float32)] == 2 * 5 * 2
    assert rec.attention[((2, 35, 4, 8), (2, 17, 4, 8), torch.float32)] == 2 * 2


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
