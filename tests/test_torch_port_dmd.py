"""The port's SDXL-DMD2 path vs the JAX package, fp32 on the CPU: the DDPM
re-noise step and its log-prob, the DMD2 sampler with one tiny UNet shared
by both sides, the trainer's pair sampling with the reference's
shared-noise pattern, one DMD update against ``_update_impl``, and the new
trainer CLI.

The JAX tiny UNet is made from a seed and carried into the port with
``state_dict_from_jax``. Noise is drawn in JAX the way the reference draws
it and handed to the port. Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test
says otherwise.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.ops import ddpm_renoise as jdr
from pairwise_sample_optimization_tpu.train import online_pso as jpso
from pairwise_sample_optimization_tpu.train import sampling as jsampling
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_dmd2 import (build_config,
                                                                                   main)
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.ops import ddpm_renoise as tdr
from pairwise_sample_optimization_tpu_torch.ops.schedules import (distill_timesteps,
                                                                  make_alphas_cumprod)
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                          PSOTrainState, lora_parameters,
                                                          make_optimizer, sample_dmd_trajectories)

ATOL, RTOL = 3e-5, 2e-4
RANK, GA, BS, STEPS, CTX, HW = 2, 2, 2, 4, 5, 8
T = STEPS - 1
B = GA * BS  # prompts per update
HP = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-6,
          max_grad_norm=1.0)
AC = make_alphas_cumprod()
LATTICE = distill_timesteps(STEPS)


@pytest.fixture(autouse=True, scope="module")
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


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------- #
# the re-noise step
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def step_inputs():
    r = np.random.default_rng(0)
    x = r.standard_normal((3, HW, HW, 4)).astype(np.float32)
    eps = r.standard_normal((3, HW, HW, 4)).astype(np.float32)
    t = np.array([999, 749, 499], np.int32)
    return x, eps, t, t - 250


def test_x0_from_eps_and_distilled_logprob_match_jax(step_inputs):
    x, eps, t, t_prev = step_inputs
    _close(tdr.x0_from_eps(_t(x), _t(eps), AC, _t(t)),
           jdr.x0_from_eps(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(AC), jnp.asarray(t)))
    x_prev = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    _close(tdr.distilled_logprob(AC, _t(eps), _t(t), _t(t_prev), _t(x), _t(x_prev)),
           jdr.distilled_logprob(jnp.asarray(AC), jnp.asarray(eps), jnp.asarray(t),
                                 jnp.asarray(t_prev), jnp.asarray(x), jnp.asarray(x_prev)))


@pytest.mark.parametrize("shared", [True, False], ids=["shared_noise", "per_sample_noise"])
def test_distilled_step_matches_jax(step_inputs, shared):
    """The JAX step draws its own noise: (1, h, w, C) broadcast over the
    batch when shared, else (B, h, w, C). The same draw goes to the port."""
    x, eps, t, t_prev = step_inputs
    key = jax.random.key(3)
    want_x, want_lp = jdr.distilled_step_with_logprob(
        jnp.asarray(AC), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(t_prev), jnp.asarray(x),
        key, shared_noise=shared)
    shape = (1,) + x.shape[1:] if shared else x.shape
    noise = _t(jax.random.normal(key, shape, jnp.float32))
    got_x, got_lp = tdr.distilled_step_with_logprob(AC, _t(eps), _t(t), _t(t_prev), _t(x), noise)
    _close(got_x, want_x)
    _close(got_lp, want_lp)
    # drawn by the port itself: one sample for the whole batch when shared
    drawn, _ = tdr.distilled_step_with_logprob(AC, _t(eps), _t(t), _t(t_prev), _t(x),
                                               shared_noise=shared,
                                               generator=torch.Generator().manual_seed(0))
    a_prev = torch.as_tensor(AC[t_prev]).reshape(-1, 1, 1, 1)
    mean = torch.sqrt(a_prev) * tdr.x0_from_eps(_t(x), _t(eps), AC, _t(t))
    z = (drawn - mean) / torch.sqrt(1.0 - a_prev)
    assert torch.allclose(z[0], z[1], atol=1e-4) == shared


# ---------------------------------------------------------------------- #
# one tiny UNet on both sides
# ---------------------------------------------------------------------- #


def _np_cond(r, n):
    return {"embeds": r.standard_normal((n, CTX, 32)).astype(np.float32),
            "pooled": r.standard_normal((n, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (n, 1))}


def _random_variables(shapes, r, b_std=0.0):
    """Random weights in the flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, small biases, LoRA A gaussian with std
    1/rank and B gaussian with std ``b_std`` (0: a fresh adapter)."""

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return (r.standard_normal(shape) * b_std).astype(np.float32)
        std = {"bias": 0.02, "a": 1.0 / RANK}.get(name, 1.0 / math.sqrt(np.prod(shape[:-1])))
        return (r.standard_normal(shape) * std).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape) for k, v in node.items()}

    return walk(shapes)


def _port_unet(variables):
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=RANK), device="cpu")
    unet.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return unet


@pytest.fixture(scope="module")
def unets():
    """The JAX tiny UNet with a trained-looking adapter (B non-zero) and a
    fresh one, the port's copies, and conditioning for 2B rows."""
    model = junet.SDXLUNet(junet.UNetConfig.tiny(lora_rank=RANK))
    r = np.random.default_rng(0)
    cond = _np_cond(r, 2 * B)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, HW, HW, 4)),
                            jnp.zeros((1,)), *(jnp.asarray(v[:1]) for v in cond.values()))
    trained = _random_variables(shapes, np.random.default_rng(1), b_std=0.05)
    fresh = {"params": trained["params"],  # the same adapter with B = 0
             "lora": jax.tree_util.tree_map_with_path(
                 lambda p, a: np.zeros_like(a) if p[-1].key == "b" else a, trained["lora"])}

    def unet_apply(v, x, t, c, lora_scale):
        return model.apply(v, x, t, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    return dict(apply=unet_apply, trained=trained, fresh=fresh, cond=cond,
                port_trained=_port_unet(trained))


def _port_eps_fn(unet, cond):
    tc = {k: torch.from_numpy(v) for k, v in cond.items()}
    return lambda x, t: unet(x.permute(0, 3, 1, 2), t, tc["embeds"], tc["pooled"],
                             tc["time_ids"]).permute(0, 2, 3, 1)


def test_sample_dmd_trajectories_matches_jax(unets):
    """Shared noise drawn inside the JAX sampler (one (1, h, w, C) draw per
    step from its split keys), reproduced and handed to the port."""
    cond, v = unets["cond"], unets["trained"]
    init = np.random.default_rng(2).standard_normal((2 * B, HW, HW, 4)).astype(np.float32)
    key = jax.random.key(9)
    want = jax.jit(lambda v, c, x, k: jsampling.sample_dmd_trajectories(
        lambda x, t: unets["apply"](v, x, t, c, 1.0), jnp.asarray(AC), LATTICE, x, k,
        shared_noise=True))(v, cond, init, key)
    noise = np.stack([np.asarray(jax.random.normal(k, (1, HW, HW, 4), jnp.float32))
                      for k in jax.random.split(key, STEPS - 1)])
    with torch.no_grad():
        got = sample_dmd_trajectories(_port_eps_fn(unets["port_trained"], cond), AC, LATTICE,
                                      _t(init), transition_noise=_t(noise))
    assert got.latents.shape == (STEPS, 2 * B, HW, HW, 4)
    assert got.log_probs.shape == (STEPS - 1, 2 * B)
    assert torch.equal(got.input_latents, got.latents[:-1])  # no input scaling
    assert torch.equal(got.latents[0], _t(init))  # no init_noise_sigma scaling
    for name in ("latents", "input_latents", "log_probs", "final_latents"):
        _close(getattr(got, name), getattr(want, name))
    # the decoded latents are the deterministic x0 at the last lattice timestep
    with torch.no_grad():
        t_last = torch.full((2 * B,), int(LATTICE[-1]), dtype=torch.int32)
        eps = _port_eps_fn(unets["port_trained"], cond)(got.latents[-1], t_last)
    _close(got.final_latents, tdr.x0_from_eps(got.latents[-1], eps, AC, t_last), atol=1e-6,
           rtol=1e-6)


# ---------------------------------------------------------------------- #
# the trainer: pair sampling and one update
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def dmd_samples(unets):
    """The JAX trainer's DMD pair sampling (no decode) for B prompts, and
    the port trainer's on the same weights with the JAX draws handed over."""
    cond, v = unets["cond"], unets["trained"]
    jcfg = jpso.OnlinePSOConfig(sampler="dmd", num_steps=STEPS, train_batch_size=BS,
                                grad_accum=GA, compare="pareto", shared_noise=True)
    tx = jts.make_optimizer(**HP)
    jtrainer = jpso.OnlinePSOTrainer(jcfg, unets["apply"], tx, latent_hw=HW, donate=False)
    jcond = {k: jnp.asarray(a[:B]) for k, a in cond.items()}
    key = jax.random.key(11)
    jsamples, _ = jtrainer.sample_pairs(v, jcond, None, key)
    # the draws _sample_pairs_impl makes: init, then one (S-1, 2, 1, h, w, C) draw
    k_init, k_step = jax.random.split(key)
    init = jax.random.normal(k_init, (2 * B, HW, HW, 4), jnp.float32)
    _, k_tn = jax.random.split(k_step)
    tn = jax.random.normal(k_tn, (T, 2, 1, HW, HW, 4), jnp.float32)
    step_noise = np.asarray(jnp.broadcast_to(tn, (T, 2, B, HW, HW, 4))).reshape(
        T, 2 * B, HW, HW, 4)

    pipe = SDXLPipeline.random(lora_rank=RANK, dtype=torch.float32, resolution=16, tiny=True,
                               device="cpu")
    pipe.unet = unets["port_trained"]
    trainer = OnlinePSOTrainer(OnlinePSOConfig(sampler="dmd", num_steps=STEPS,
                                               compare="pareto"), pipe)
    tcond = {k: torch.from_numpy(a[:B]) for k, a in cond.items()}
    tcond["reward_ids"] = torch.randint(1, 998, (B, 77), generator=torch.Generator().manual_seed(0))
    samples, images = trainer.sample_pairs(tcond, init_noise=_t(init), step_noise=_t(step_noise))
    drawn, _ = trainer.sample_pairs(tcond, torch.Generator().manual_seed(5))
    return dict(jtrainer=jtrainer, tx=tx, jsamples=jsamples, samples=samples, drawn=drawn,
                images=images, trainer=trainer, tcond=tcond)


def test_trainer_dmd_pair_sampling_matches_jax(dmd_samples):
    got, want = dmd_samples["samples"], dmd_samples["jsamples"]
    for k in ("latents", "next_latents", "input_latents", "log_probs"):
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])
    for k in ("step_indices", "timesteps"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["timesteps"].tolist() == [[999, 749, 499]] * B
    assert got["rewards"].shape == (B, 2, 1) and dmd_samples["images"].shape == (2 * B, 16, 16, 3)


@pytest.mark.parametrize("which", ["jax_draws", "port_draws"])
def test_trainer_shared_noise_pattern(dmd_samples, which):
    """The transition noise recovered from the stored transitions, (x_next -
    mean) / std under the sampling policy: within a trajectory side every
    prompt has the same noise, and the two sides differ."""
    s = dmd_samples["samples" if which == "jax_draws" else "drawn"]
    trainer = dmd_samples["trainer"]
    cond = {k: v for k, v in dmd_samples["tcond"].items() if k != "reward_ids"}
    for j in range(T):
        t = s["timesteps"][:, j]
        z = []
        for side in range(2):
            x = s["latents"][:, side, j]
            with torch.no_grad():
                eps = trainer.pipe.unet_eps(s["input_latents"][:, side, j], t, cond, 1.0)
            a_prev = torch.as_tensor(AC[(t - 250).long()]).reshape(-1, 1, 1, 1)
            mean = torch.sqrt(a_prev) * tdr.x0_from_eps(x, eps, AC, t)
            z.append((s["next_latents"][:, side, j] - mean) / torch.sqrt(1.0 - a_prev))
        for side in range(2):
            _close(z[side][1:], z[side][:1].expand_as(z[side][1:]), atol=2e-4, rtol=2e-4)
        assert (z[0][0] - z[1][0]).abs().mean() > 0.5  # the sides' draws differ


@pytest.mark.parametrize("adapter", ["fresh", "trained"])
def test_dmd_update_matches_jax_update_impl(unets, dmd_samples, adapter):
    """One DMD update (strict-dominance preference, log-probs recomputed
    towards t - step_ratio) against the JAX ``_update_impl``: loss,
    grad_norm, ratio_win and the LoRA after the step."""
    variables = unets[adapter]
    samples = dict(dmd_samples["samples"])
    samples["rewards"] = torch.from_numpy(
        np.random.default_rng(4).standard_normal((B, 2, 1)).astype(np.float32))
    cond = {k: torch.from_numpy(v[:B]) for k, v in unets["cond"].items()}
    per_update = lambda tree: {k: v.reshape((GA, BS) + v.shape[1:]) for k, v in tree.items()}
    jstate = jts.PSOTrainState.create(variables["lora"], dmd_samples["tx"])
    jnew, jm = dmd_samples["jtrainer"]._update(
        jstate, variables["params"], {k: jnp.asarray(v.numpy()) for k, v in
                                      per_update(samples).items()},
        {k: jnp.asarray(v.numpy()) for k, v in per_update(cond).items()}, jax.random.key(5))

    unet = _port_unet(variables)
    trainer = OnlinePSOTrainer(OnlinePSOConfig(sampler="dmd", num_steps=STEPS,
                                               train_batch_size=BS, grad_accum=GA,
                                               compare="pareto"),
                               SDXLPipeline(unet=unet, vae=None, te1=None, te2=None))
    lora = lora_parameters(unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **HP))
    m = trainer.update(state, per_update(samples), per_update(cond))
    if adapter == "fresh":  # policy = reference: the on-policy anchor
        assert abs(m["loss"] - math.log(2.0)) < 1e-3
        assert abs(float(jm["loss"]) - math.log(2.0)) < 1e-3
    else:
        assert abs(m["loss"] - math.log(2.0)) > 1e-4
    for key in ("loss", "grad_norm", "ratio_win"):
        _close(np.float32(m[key]), jm[key])
    want = state_dict_from_jax({"params": {}, "lora": jnew.lora}, "unet", n_levels=2)
    assert set(want) == set(state.lora)
    for k, v in want.items():
        _close(state.lora[k], v)


# ---------------------------------------------------------------------- #
# config and CLI
# ---------------------------------------------------------------------- #


def test_dmd_config_mirrors_jax():
    from pairwise_sample_optimization_tpu.configs import sdxl_dmd_dpo as jcfg

    j, c = jcfg.get_config(), build_config()
    for key in ("resolution", "num_steps", "batch_size", "num_batches_per_epoch",
                "shared_noise"):
        assert c.sample[key] == j.sample[key], key
    for key in ("batch_size", "distilled_train_steps", "lora_rank",
                "gradient_accumulation_steps", "fuse_ref_pass", "beta", "learning_rate"):
        assert c.train[key] == j.train[key], key
    assert c.run_name == "SDXL_DMD4_PS_lorarank16_lr1e-05_beta50.0"
    assert "fused_groupnorm" not in c.kernels and c.vae_decode_chunk == j.vae_decode_chunk == 0


def test_dmd_cli_tiny_cpu_epoch(tmp_path):
    main(["--tiny", "--device", "cpu", "--epochs", "1", f"output_dir={tmp_path}",
          "run_name=dmd"])
    rows = [json.loads(r) for r in (tmp_path / "dmd" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 1 and abs(losses[0] - math.log(2.0)) < 1e-3  # fresh adapter
    assert (tmp_path / "dmd" / "checkpoint-1" / "state.pt").exists()


def test_chip_smoke_launch_counts_match_the_tiny_dmd_loop(tmp_path):
    """The launch counts chip_smoke.py expects of the DMD2 loop equal the
    kernel-wrapper calls the loop makes (counted here on the CPU, where the
    wrappers take their plain versions): 4 UNet forwards a pair batch (3
    transitions and the final x0), the unfused reference pass in the update."""
    import importlib.util
    from pathlib import Path

    from pairwise_sample_optimization_tpu_torch.cli import online_runner

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    config = build_config(True, [f"output_dir={tmp_path}", "run_name=c"])
    assert not config.train.fuse_ref_pass
    with cs.ShapeRecorder() as rec:  # one pair batch, one update of 1 x T microbatches
        _, _, pipe = online_runner.run_online_pso(config, sampler="dmd", num_epochs=1,
                                                  device="cpu")
    want = cs.expected_launches(pipe, STEPS)
    upd = cs.expected_update_launches(pipe.unet.config, T, False, 2 * config.train.batch_size,
                                      pipe.latent_hw)
    got = {"flash_attn_fwd": sum(rec.attention.values()),
           "flash_attn_bwd_pre": sum(rec.attention_bwd.values()),
           "flash_attn_bwd": sum(rec.attention_bwd.values()),
           "flash_attn_bwd_post": sum(n for (qs, ks, _), n in rec.attention_bwd.items()
                                      if cs.bwd_needs_post(qs, ks[1])),
           "gn_stats": sum(rec.gn.values()), "gn_silu_norm": sum(rec.gn.values()),
           **rec.int8_launches()}
    assert got == {k: want[k] + upd[k] for k in want}
