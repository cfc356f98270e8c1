"""The port's online-PSO update, trainer, data and runner vs the JAX
package, fp32 on the CPU with the tiny UNet.

The JAX tiny UNet is initialized from a seed and carried into the port with
``state_dict_from_jax``; transitions are sampled once with the port's
sampler, and the same arrays go through the JAX ``_update_impl`` and the
port's ``update``. Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test says
otherwise.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.data import prompt_dataset as jpd
from pairwise_sample_optimization_tpu.data import tokenizer as jtok
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.ops.euler_ancestral import turbo_logprob as j_turbo_logprob
from pairwise_sample_optimization_tpu.train import online_pso as jpso
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.cli import online_runner
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import (build_config,
                                                                                    main)
from pairwise_sample_optimization_tpu_torch.data import prompt_dataset as tpd
from pairwise_sample_optimization_tpu_torch.data import tokenizer as ttok
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.ops.euler_ancestral import turbo_logprob
from pairwise_sample_optimization_tpu_torch.ops.schedules import make_euler_ancestral_schedule
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                          PSOTrainState, lora_parameters,
                                                          make_optimizer,
                                                          sample_turbo_trajectories)

ATOL, RTOL = 3e-5, 2e-4
ROOT = Path(__file__).resolve().parent.parent
RANK, GA, BS, STEPS, CTX = 2, 2, 2, 4, 5
T = STEPS - 1
B = GA * BS  # prompts per update
HP = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-6,
          max_grad_norm=1.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _np_cond(r, n):
    return {"embeds": r.standard_normal((n, CTX, 32)).astype(np.float32),
            "pooled": r.standard_normal((n, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (n, 1))}


@pytest.fixture(scope="module")
def setup():
    """JAX tiny UNet (fresh adapter) + the port's copy, a jitted JAX update,
    and one batch of sampled transitions in the JAX samples layout."""
    cfg = junet.UNetConfig.tiny(lora_rank=RANK)
    model = junet.SDXLUNet(cfg)
    r = np.random.default_rng(0)
    cond = _np_cond(r, B)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), *(jnp.asarray(v[:1]) for v in cond.values()))
    variables = _random_variables(shapes, r)

    def unet_apply(v, x, t, c, lora_scale):
        return model.apply(v, x, t, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    jcfg = jpso.OnlinePSOConfig(num_steps=STEPS, train_batch_size=BS, grad_accum=GA)
    tx = jts.make_optimizer(**HP)
    jtrainer = jpso.OnlinePSOTrainer(jcfg, unet_apply, tx, donate=False)

    port = _port_unet(variables)
    pipe = SDXLPipeline(unet=port, vae=None, te1=None, te2=None)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    cond2 = {k: torch.cat([v, v]) for k, v in tcond.items()}
    # the policy with a non-zero B samples, so transitions are the model's own
    sampler = _port_unet(_with_lora_b(variables, 0.05))
    with torch.no_grad():
        traj = sample_turbo_trajectories(
            lambda x, t: sampler(x.permute(0, 3, 1, 2), t, cond2["embeds"], cond2["pooled"],
                                 cond2["time_ids"]).permute(0, 2, 3, 1),
            make_euler_ancestral_schedule(STEPS),
            torch.from_numpy(r.standard_normal((2 * B, 8, 8, 4)).astype(np.float32)),
            noise=torch.from_numpy(r.standard_normal((STEPS, 2 * B, 8, 8, 4)).astype(np.float32)))

    def to_bp(x):  # (T, 2B, ...) -> (B, 2, T, ...)
        x = x[:T].movedim(0, 1)
        return x.reshape((2, B) + x.shape[1:]).transpose(0, 1)

    samples = {"latents": to_bp(traj.current_latents), "next_latents": to_bp(traj.next_latents),
               "input_latents": to_bp(traj.input_latents), "log_probs": to_bp(traj.log_probs),
               "step_indices": torch.arange(T).repeat(B, 1),
               "timesteps": torch.tensor([999, 749, 499], dtype=torch.int32).repeat(B, 1),
               "rewards": torch.from_numpy(r.standard_normal((B, 2, 1)).astype(np.float32))}
    return dict(model=model, variables=variables, jtrainer=jtrainer, tx=tx, pipe=pipe,
                samples=samples, cond=tcond)


def _random_variables(shapes, r):
    """Random weights in the flax tree's shapes (faster than running the
    init): kernels gaussian with std 1/sqrt(fan_in), norms identity, small
    biases, LoRA A gaussian with std 1/rank and B zero (a fresh adapter)."""

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return np.zeros(shape, np.float32)
        std = {"bias": 0.02, "a": 1.0 / RANK}.get(name, 1.0 / math.sqrt(np.prod(shape[:-1])))
        return (r.standard_normal(shape) * std).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape) for k, v in node.items()}

    return walk(shapes)


def _with_lora_b(variables, std, seed=3):
    r = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (r.standard_normal(v.shape).astype(np.float32) * std if k == "b"
                     else np.asarray(v))) for k, v in node.items()}

    return {"params": variables["params"], "lora": walk(variables["lora"])}


def _port_unet(variables, remat=""):
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=RANK, remat=remat), device="cpu")
    unet.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return unet


def _lora_as_port(lora):
    return state_dict_from_jax({"params": {}, "lora": lora}, "unet", n_levels=2)


def _per_update(tree):
    return {k: v.reshape((GA, BS) + v.shape[1:]) for k, v in tree.items()}


def _port_update(unet, samples, cond, **cfg):
    pipe = SDXLPipeline(unet=unet, vae=None, te1=None, te2=None)
    trainer = OnlinePSOTrainer(
        OnlinePSOConfig(num_steps=STEPS, train_batch_size=BS, grad_accum=GA, **cfg), pipe)
    lora = lora_parameters(unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **HP))
    metrics = trainer.update(state, _per_update(samples), _per_update(cond))
    return state, metrics


@pytest.mark.parametrize("adapter", ["fresh", "trained"])
def test_update_matches_jax_update_impl(setup, adapter):
    variables = setup["variables"]
    if adapter == "trained":
        variables = _with_lora_b(variables, 0.05)
    samples, cond = setup["samples"], setup["cond"]
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in _per_update(samples).items()}
    jcond = {k: jnp.asarray(v.numpy()) for k, v in _per_update(cond).items()}
    jstate = jts.PSOTrainState.create(variables["lora"], setup["tx"])
    jnew, jm = setup["jtrainer"]._update(jstate, variables["params"], jbatch, jcond,
                                         jax.random.key(5))
    state, m = _port_update(_port_unet(variables), samples, cond)
    if adapter == "fresh":  # policy = reference: every ratio is 1
        assert abs(m["loss"] - math.log(2.0)) < 1e-6
        assert abs(float(jm["loss"]) - math.log(2.0)) < 1e-6
    else:
        assert abs(m["loss"] - math.log(2.0)) > 1e-4
    for key in ("loss", "grad_norm", "ratio_win"):
        _close(np.float32(m[key]), jm[key])
    assert state.step == int(jnew.step) == 1
    want = _lora_as_port(jnew.lora)
    assert set(want) == set(state.lora)
    for k, v in want.items():
        _close(state.lora[k], v)


def test_remat_on_and_off_give_the_same_update(setup):
    samples, cond = setup["samples"], setup["cond"]
    variables = _with_lora_b(setup["variables"], 0.05)
    s_off, m_off = _port_update(_port_unet(variables, remat=""), samples, cond)
    s_on, m_on = _port_update(_port_unet(variables, remat="full"), samples, cond)
    assert m_on == pytest.approx(m_off, rel=1e-6, abs=1e-7)
    for k in s_off.lora:
        _close(s_on.lora[k], s_off.lora[k], atol=1e-7, rtol=1e-6)


def test_fused_and_unfused_reference_pass_give_the_same_update(setup):
    samples, cond = setup["samples"], setup["cond"]
    variables = _with_lora_b(setup["variables"], 0.05)
    s_un, m_un = _port_update(_port_unet(variables), samples, cond, fuse_ref_pass=False)
    s_fu, m_fu = _port_update(_port_unet(variables), samples, cond, fuse_ref_pass=True)
    for key in m_un:
        _close(np.float32(m_fu[key]), np.float32(m_un[key]), atol=1e-6, rtol=1e-5)
    for k in s_un.lora:
        _close(s_fu.lora[k], s_un.lora[k], atol=1e-6, rtol=1e-5)


def test_frozen_weights_get_no_grad(setup):
    variables = _with_lora_b(setup["variables"], 0.05)
    unet = _port_unet(variables, remat="full")
    trainer = OnlinePSOTrainer(OnlinePSOConfig(num_steps=STEPS, train_batch_size=BS,
                                               grad_accum=GA, clamp_mode="none"),
                               SDXLPipeline(unet=unet, vae=None, te1=None, te2=None))
    lora = lora_parameters(unet)
    s, c = setup["samples"], setup["cond"]
    micro = {k: s[k][:BS, :, 0] for k in ("input_latents", "latents", "next_latents")}
    micro.update({k: s[k][:BS, 0] for k in ("step_indices", "timesteps")})
    micro["rewards"] = s["rewards"][:BS]
    loss, _ = trainer._micro_loss(micro, {k: v[:BS] for k, v in c.items()},
                                  torch.Generator().manual_seed(0))
    loss.backward()
    for name, p in unet.named_parameters():
        if name in lora:
            assert p.requires_grad and p.grad is not None
        else:
            assert not p.requires_grad and p.grad is None, name
    assert any(float(p.grad.abs().max()) > 0 for p in lora.values())


def test_shuffle_matches_jax_and_keeps_transitions_aligned(setup):
    samples, cond = setup["samples"], setup["cond"]
    key = jax.random.key(31)
    jsamples = {k: jnp.asarray(v.numpy()) for k, v in samples.items()}
    jshuf, jcond = setup["jtrainer"].shuffle(jsamples, {k: jnp.asarray(v.numpy())
                                                       for k, v in cond.items()}, key)
    k1, k2 = jax.random.split(key)  # the draws the JAX shuffle makes, handed to the port
    batch_perm = np.array(jax.random.permutation(k1, B))
    step_perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, T))(
        jax.random.split(k2, B)))
    trainer = OnlinePSOTrainer(OnlinePSOConfig(num_steps=STEPS), setup["pipe"])
    shuf, cond_sh = trainer.shuffle(samples, cond, batch_perm=torch.from_numpy(batch_perm),
                                    step_perms=torch.from_numpy(step_perms))
    for k in samples:
        np.testing.assert_array_equal(shuf[k].numpy(), np.asarray(jshuf[k]))
    for k in cond:
        np.testing.assert_array_equal(cond_sh[k].numpy(), np.asarray(jcond[k]))
    # (latents[j], next_latents[j], step_indices[j]) is still one transition:
    # its log-prob under the sampling policy is the recorded one
    sampler = _port_unet(_with_lora_b(setup["variables"], 0.05))
    sched = make_euler_ancestral_schedule(STEPS)
    for j in range(T):
        for traj in range(2):
            with torch.no_grad():
                eps = sampler(shuf["input_latents"][:, traj, j].permute(0, 3, 1, 2),
                              shuf["timesteps"][:, j], cond_sh["embeds"], cond_sh["pooled"],
                              cond_sh["time_ids"]).permute(0, 2, 3, 1)
            lp = turbo_logprob(sched, eps, shuf["step_indices"][:, j], shuf["latents"][:, traj, j],
                               shuf["next_latents"][:, traj, j])
            _close(lp, shuf["log_probs"][:, traj, j], atol=2e-3, rtol=2e-3)
    # a generator-drawn shuffle moves each pair whole and permutes its
    # timesteps the same way for both trajectories
    drawn, cond_d = trainer.shuffle(samples, cond, torch.Generator().manual_seed(0))
    for i in range(B):
        src = next(b for b in range(B) if torch.equal(cond["embeds"][b], cond_d["embeds"][i]))
        for j in range(T):
            t = int(drawn["step_indices"][i, j])
            for traj in range(2):
                for k in ("latents", "next_latents", "input_latents", "log_probs"):
                    assert torch.equal(drawn[k][i, traj, j], samples[k][src, traj, t])


def test_jax_logprob_recompute_agrees_with_port(setup):
    s = setup["samples"]
    sched = make_euler_ancestral_schedule(STEPS)
    eps = np.random.default_rng(4).standard_normal((B, 8, 8, 4)).astype(np.float32)
    want = j_turbo_logprob(sched, jnp.asarray(eps), jnp.asarray(s["step_indices"][:, 1].numpy()),
                           jnp.asarray(s["latents"][:, 0, 1].numpy()),
                           jnp.asarray(s["next_latents"][:, 0, 1].numpy()))
    got = turbo_logprob(sched, torch.from_numpy(eps), s["step_indices"][:, 1],
                        s["latents"][:, 0, 1], s["next_latents"][:, 0, 1])
    _close(got, want)


# ---------------------------------------------------------------------- #
# tokenizer and prompts
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tokenizers():
    return jtok.CLIPTokenizer(), ttok.CLIPTokenizer()


EDGE_PROMPTS = [
    "it's a dog's life, they've said we'll go & I'd stay", "R2-D2 met c3po in 1999 at 10:30",
    "snake_case__name and __dunder__", "café naïve résumé Ærøskøbing Łódź",
    "日本の猫と犬",
    "emoji 🐱!! ... ?!", "<|endoftext|> literal tokens <|startoftext|>", "&amp; html &lt;b&gt;",
    "   lots   of\twhite\nspace   ", "",
]


def test_clip_tokenizer_matches_jax(tokenizers):
    jt, tt = tokenizers
    prompts = tpd.PromptDataset("4k").prompts[:200] + EDGE_PROMPTS
    np.testing.assert_array_equal(tt(prompts), jt(prompts))
    for p in EDGE_PROMPTS[:4]:
        assert tt.encode(p) == jt.encode(p)
        assert tt.decode(tt.encode(p)) == jt.decode(jt.encode(p))


def test_tokenizer_factories_and_hash_tokenizer_match_jax():
    prompts = ["a red fox", "an astronaut riding a horse"]
    t1, t2, tr = ttok.make_clip_tokenizers(with_reward=True)
    j1, j2, jr = jtok.make_clip_tokenizers(with_reward=True)
    for a, b in ((t1, j1), (t2, j2), (tr, jr)):
        np.testing.assert_array_equal(a(prompts), b(prompts))
    assert t2(prompts)[0, -1] == 0 and t1(prompts)[0, -1] == 49407  # pad conventions
    h = ttok.make_clip_tokenizers(vocab_size=1000)
    hj = jtok.make_clip_tokenizers(vocab_size=1000)
    assert isinstance(h[0], ttok.HashTokenizer)
    for a, b in zip(h, hj):
        np.testing.assert_array_equal(a(prompts), b(prompts))


@pytest.mark.parametrize("source", ["", "4k"])
def test_prompt_loader_matches_jax(source):
    tds, jds = tpd.PromptDataset(source or None), jpd.PromptDataset(source or None)
    assert tds.prompts == jds.prompts
    tok = ttok.HashTokenizer(vocab_size=1000)
    tl = tpd.PromptLoader(tds, 4, tok, tok, reward_tokenizer=tok, seed=3)
    jl = jpd.PromptLoader(jds, 4, tok, tok, reward_tokenizer=tok, seed=3)
    for _ in range(2):  # two epochs: the rng advances the same way
        for a, b in zip(tl.epoch(), jl.epoch()):
            assert a["prompts"] == b["prompts"]
            np.testing.assert_array_equal(a["input_ids_one"], b["input_ids_one"])


def test_prompt_dataset_files_and_refusals(tmp_path):
    (tmp_path / "p.json").write_text(json.dumps([{"caption": "x"}, "y"]))
    (tmp_path / "p.txt").write_text("a\n\nb\n")
    (tmp_path / "s.json").write_text(json.dumps({"test": [{"caption": "z"}]}))
    assert tpd.PromptDataset(str(tmp_path / "p.json")).prompts == ["x", "y"]
    assert tpd.PromptDataset(str(tmp_path / "p.txt")).prompts == ["a", "b"]
    assert tpd.PromptDataset(str(tmp_path / "s.json"), split="test").prompts == ["z"]
    with pytest.raises(FileNotFoundError):
        tpd.PromptDataset(str(tmp_path / "missing.json"))
    with pytest.raises(NotImplementedError):
        tpd.PromptDataset(hf_dataset="yuvalkirstain/pickapic_v1_no_images")


# ---------------------------------------------------------------------- #
# config, runner, CLI
# ---------------------------------------------------------------------- #


def test_config_overrides_keep_types():
    c = build_config(overrides=["train.beta=25", "sample.batch_size=2", "seed=3",
                                "activation_checkpoint=", "train.fuse_ref_pass=True"])
    assert c.train.beta == 25.0 and isinstance(c.train.beta, float)
    assert c.sample.batch_size == 2 and c.seed == 3 and c.train.fuse_ref_pass is True
    assert c.activation_checkpoint == ""
    assert c.to_dict()["train"]["beta"] == 25.0
    with pytest.raises(KeyError):
        c.override("train.no_such_knob=1")
    with pytest.raises(TypeError):
        c.override("sample.batch_size=2.5")


@pytest.mark.parametrize("override,error", [
    ("mesh.fsdp=True", NotImplementedError), ("use_wandb=True", NotImplementedError),
    ("train.int8_ref_pass=True", NotImplementedError),
    ("pretrained.model_dir=/x", NotImplementedError),
    ("activation_checkpoint=dots", NotImplementedError),
    ("activation_checkpoint=fulll", ValueError), ("use_lora=False", NotImplementedError),
    ("param_dtype=bfloat16", NotImplementedError),
])
def test_runner_refuses_unported_knobs(tmp_path, override, error):
    config = build_config(True, [f"output_dir={tmp_path}", override])
    with pytest.raises(error):
        online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert not any(tmp_path.iterdir())  # refused before any work


def test_runner_refuses_a_run_where_validation_would_fire(tmp_path):
    config = build_config(True, [f"output_dir={tmp_path}", "validation_steps=2"])
    with pytest.raises(NotImplementedError, match="validation"):
        online_runner.run_online_pso(config, num_epochs=2, device="cpu")
    with pytest.raises(NotImplementedError):
        online_runner.run_online_pso(config, sampler="dmd", num_epochs=1, device="cpu")


def test_runner_tiny_epoch_logs_saves_and_resumes(tmp_path):
    config = build_config(True, [f"output_dir={tmp_path}", "run_name=r", "checkpointing_steps=1"])
    state, history, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert len(history) == 1 and state.step == 1
    assert abs(history[0]["loss"] - math.log(2.0)) < 1e-6  # fresh adapter
    run = tmp_path / "r"
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["epoch"] == 0 and "reward_mean" in rows[0]
    assert rows[1]["step"] == 1 and "time/train_s" in rows[1] and "grad_norm" in rows[1]
    assert (run / "checkpoint-1" / "state.pt").exists()

    config.resume_from = str(run)
    state2, history2, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert state2.step == 2 and len(history2) == 1
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert rows[2]["epoch"] == 1  # the epoch numbering continues
    assert (run / "checkpoint-2").exists()


def test_cli_tiny_cpu_run(tmp_path):
    main(["--tiny", "--device", "cpu", "--epochs", "1", f"output_dir={tmp_path}",
          "run_name=cli"])
    rows = (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()
    assert any("loss" in json.loads(r) for r in rows)


def test_chip_smoke_launch_counts_match_the_tiny_loop(tmp_path):
    """The launch counts chip_smoke.py expects of the online loop equal the
    kernel-wrapper calls the loop makes (counted here on the CPU, where the
    wrappers take their plain versions), with remat on and off and with the
    reference pass fused or not."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for extra in ([], ["train.fuse_ref_pass=True"], ["activation_checkpoint="]):
        config = build_config(True, [f"output_dir={tmp_path}", "run_name=c"] + extra)
        with cs.ShapeRecorder() as rec:  # one pair batch, one update of 1 x T microbatches
            _, _, pipe = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
        want = cs.expected_launches(pipe, STEPS)
        upd = cs.expected_update_launches(pipe.unet.config, T, config.train.fuse_ref_pass)
        got = {"flash_attn_fwd": sum(rec.attention.values()),
               "flash_attn_bwd_dkv": sum(rec.attention_bwd.values()),
               "flash_attn_bwd_dq": sum(rec.attention_bwd.values()),
               "gn_stats": sum(rec.gn.values()), "gn_silu_norm": sum(rec.gn.values())}
        assert got == {k: want[k] + upd[k] for k in want}, extra


def test_remat_modes_not_ported_raise():
    with pytest.raises(NotImplementedError):
        tunet.SDXLUNet(dataclasses.replace(tunet.UNetConfig.tiny(), remat="lowres"),
                       device="cpu")
    with pytest.raises(ValueError):
        tunet.SDXLUNet(dataclasses.replace(tunet.UNetConfig.tiny(), remat="bogus"),
                       device="cpu")


def test_trainer_config_refusals():
    with pytest.raises(NotImplementedError):
        OnlinePSOConfig(sampler="dmd")
    with pytest.raises(NotImplementedError):
        OnlinePSOConfig(full_finetune=True)
    with pytest.raises(ValueError):
        OnlinePSOConfig(num_steps=1)
    with pytest.raises(ValueError):
        OnlinePSOConfig(num_steps=4, num_train_timesteps=4)


def test_sample_pairs_packs_the_jax_samples_layout():
    pipe = SDXLPipeline.random(lora_rank=RANK, dtype=torch.float32, resolution=16, tiny=True,
                               device="cpu")
    trainer = OnlinePSOTrainer(OnlinePSOConfig(num_steps=STEPS), pipe)
    b, gen = 2, torch.Generator().manual_seed(0)
    ids = [torch.randint(1, 998, (b, 77), generator=gen) for _ in range(3)]
    cond = pipe.encode_prompt(*ids)
    samples, images = trainer.sample_pairs(cond, gen)
    hw = pipe.latent_hw
    assert samples["latents"].shape == (b, 2, T, hw, hw, 4) == samples["next_latents"].shape
    assert samples["log_probs"].shape == (b, 2, T) and samples["rewards"].shape == (b, 2, 1)
    assert samples["timesteps"].tolist() == [[999, 749, 499]] * b
    assert images.shape == (2 * b, 16, 16, 3)
    # transition j of a trajectory ends where transition j+1 starts
    assert torch.equal(samples["next_latents"][:, :, 0], samples["latents"][:, :, 1])
