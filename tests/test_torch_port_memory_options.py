"""The port's memory options of the online trainer vs the JAX package, fp32
on the CPU with the tiny models: full finetuning (``use_lora=False``: one
update against JAX ``OnlinePSOTrainer(full_finetune=True)``, its train
state saved, restored and resumed, the runner end to end with the
auxiliary towers offloaded), the selective remat modes (gradients equal to
no remat; ``dots`` re-runs no weight product), weights stored in another
dtype than the compute dtype (bf16 storage against JAX ``param_dtype``;
fp32 masters computing as bf16 weights), the chunked VAE decode, the exact
GELU against JAX ``set_gelu_exact``, and the DreamBooth CLI's remat modes.

JAX params are drawn with numpy in ``jax.eval_shape``'s shapes and carried
into the port with ``state_dict_from_jax``. Tolerance: ATOL 3e-5 / RTOL
2e-4 unless a test says otherwise.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pairwise_sample_optimization_tpu.models import layers as jlayers
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.train import online_pso as jpso
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.checkpoints import (latest_checkpoint,
                                                                restore_train_state,
                                                                save_train_state,
                                                                state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.cli import online_runner
from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as db_cli
from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import build_config
from pairwise_sample_optimization_tpu_torch.models import layers as tlayers
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.ops.schedules import make_euler_ancestral_schedule
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                          PSOTrainState, all_parameters,
                                                          lora_parameters, make_optimizer,
                                                          sample_turbo_trajectories)
from pairwise_sample_optimization_tpu_torch.utils.png import write_png

ATOL, RTOL = 3e-5, 2e-4
GA, BS, STEPS, CTX = 2, 2, 4, 5
T = STEPS - 1
B = GA * BS
# A learning rate at which one AdamW step (~lr per element) moves every
# weight well past ATOL. AdamW's first step is g / (|g| + eps): where the
# clipped gradient is below eps (~1e-5 of the median |g| here: sums that
# cancel, whose last bits JAX and torch reduce in other orders) it is
# anything from 0 to lr, so eps is 1e-6, not optax's 1e-8, and those
# elements move by ~lr * g / eps instead.
HP = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=1e-2,
          max_grad_norm=1.0)
SELECTIVE = ("full", "resnets", "dots", "lowres", "lowres_dots")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _draw(shapes, r, b_std=0.0):
    """Params in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, small biases, LoRA A gaussian with std
    1/rank and B gaussian with std ``b_std``."""

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return (r.standard_normal(shape) * b_std).astype(np.float32)
        std = {"bias": 0.02, "a": 1.0 / shape[-1]}.get(name, 1.0 / math.sqrt(np.prod(shape[:-1])))
        return (r.standard_normal(shape) * std).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape) for k, v in node.items()}

    return walk(shapes)


def _cond(r, n):
    return {"embeds": r.standard_normal((n, CTX, 32)).astype(np.float32),
            "pooled": r.standard_normal((n, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (n, 1))}


def _jax_unet(rank, seed=0, b_std=0.0, **cfg):
    model = junet.SDXLUNet(dataclasses.replace(junet.UNetConfig.tiny(lora_rank=rank), **cfg))
    r = np.random.default_rng(seed)
    c = _cond(r, 1)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,)), *(jnp.asarray(v) for v in c.values()))
    return model, _draw(shapes, r, b_std)


def _port_unet(variables, rank, **cfg):
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=rank, **cfg), device="cpu")
    unet.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return unet


def _per_update(tree):
    return {k: v.reshape((GA, BS) + v.shape[1:]) for k, v in tree.items()}


@pytest.fixture(scope="module")
def full_setup():
    """The JAX tiny UNet without LoRA, its port, one batch of transitions the
    UNet samples itself, and a jitted JAX full-finetuning update."""
    model, variables = _jax_unet(0)
    r = np.random.default_rng(1)
    cond = {k: torch.from_numpy(v) for k, v in _cond(r, B).items()}
    unet = _port_unet(variables, 0)
    cond2 = {k: torch.cat([v, v]) for k, v in cond.items()}
    with torch.no_grad():
        traj = sample_turbo_trajectories(
            lambda x, t: unet(x.permute(0, 3, 1, 2), t, cond2["embeds"], cond2["pooled"],
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

    def unet_apply(v, x, t, c, lora_scale):
        return model.apply(v, x, t, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    jcfg = jpso.OnlinePSOConfig(num_steps=STEPS, train_batch_size=BS, grad_accum=GA,
                                full_finetune=True)
    tx = jts.make_optimizer(**HP)
    jtrainer = jpso.OnlinePSOTrainer(jcfg, unet_apply, tx, donate=False)
    return dict(variables=variables, samples=samples, cond=cond, jtrainer=jtrainer, tx=tx)


def _full_trainer(variables):
    """The port's full-finetuning trainer and state over a fresh tiny UNet."""
    unet = _port_unet(variables, 0)
    pipe = SDXLPipeline(unet=unet, vae=None, te1=None, te2=None,
                        reference_unet=tunet.frozen_copy(unet))
    trainer = OnlinePSOTrainer(OnlinePSOConfig(num_steps=STEPS, train_batch_size=BS,
                                               grad_accum=GA, full_finetune=True), pipe)
    params = all_parameters(unet)
    return trainer, PSOTrainState.create(params, make_optimizer(params, **HP, per_tensor=True))


def test_full_finetune_update_matches_jax(full_setup):
    """One update that trains every UNet weight: the loss (log 2: policy and
    reference start equal), grad_norm and every weight after the AdamW step
    as JAX's; the frozen reference copy bit-unchanged and not trained."""
    s = full_setup
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in _per_update(s["samples"]).items()}
    jcond = {k: jnp.asarray(v.numpy()) for k, v in _per_update(s["cond"]).items()}
    params = s["variables"]["params"]
    jstate = jax.jit(lambda p: jts.PSOTrainState.create(p, s["tx"]))(params)
    jnew, jm = s["jtrainer"]._update(jstate, params, jbatch, jcond, jax.random.key(5))
    trainer, state = _full_trainer(s["variables"])
    ref = trainer.pipe.reference_unet
    ref_before = {k: v.clone() for k, v in ref.state_dict().items()}
    before = {k: v.detach().clone() for k, v in state.lora.items()}
    m = trainer.update(state, _per_update(s["samples"]), _per_update(s["cond"]))
    assert abs(m["loss"] - math.log(2.0)) < 1e-6
    for key in ("loss", "grad_norm", "ratio_win"):
        _close(np.float32(m[key]), jm[key])
    want = state_dict_from_jax({"params": jnew.lora}, "unet", n_levels=2)
    assert set(want) == set(state.lora) and len(want) > 100
    for k, v in want.items():
        _close(state.lora[k], v)
    moved = sum(bool((state.lora[k] - before[k]).abs().max() > 10 * ATOL) for k in before)
    assert moved == len(before)  # every weight, biases and norms too
    assert all(torch.equal(v, ref_before[k]) for k, v in ref.state_dict().items())
    assert not any(p.requires_grad or p.grad is not None for p in ref.parameters())


def test_full_finetune_state_saves_restores_and_resumes(full_setup, tmp_path):
    """The whole-UNet train state (weights, the per-tensor AdamW's moments,
    the count) written after one update and restored into a fresh trainer:
    its second update equals the one the first trainer makes, bit for bit."""
    s = full_setup
    batch, cond = _per_update(s["samples"]), _per_update(s["cond"])
    trainer, state = _full_trainer(s["variables"])
    trainer.update(state, batch, cond)
    path = save_train_state(str(tmp_path), state.step, state, {"epoch": 0})
    trainer2, state2 = _full_trainer(s["variables"])
    assert restore_train_state(latest_checkpoint(str(tmp_path)), state2) == {"epoch": 0}
    assert path.endswith("checkpoint-1") and state2.step == 1 and state2.tx.count == 1
    for k in state.lora:
        assert torch.equal(state2.lora[k], state.lora[k])
    m1 = trainer.update(state, batch, cond)
    m2 = trainer2.update(state2, batch, cond)
    assert m1 == m2 and state2.step == 2
    for k in state.lora:
        assert torch.equal(state2.lora[k], state.lora[k]), k
    lora_state = PSOTrainState.create(*(lambda p: (p, make_optimizer(p)))(
        lora_parameters(_port_unet(_jax_unet(2)[1], 2))))
    with pytest.raises(KeyError):  # a LoRA state does not take a whole-UNet checkpoint
        restore_train_state(path, lora_state)


def _micro_grads(unet, full=False):
    """Gradients of one tiny microbatch's loss-like sum through the UNet
    (policy pass with grad) of the LoRA, or of every weight."""
    r = np.random.default_rng(7)
    c = {k: torch.from_numpy(v) for k, v in _cond(r, 2).items()}
    x = torch.from_numpy(r.standard_normal((2, 4, 8, 8)).astype(np.float32))
    params = all_parameters(unet) if full else lora_parameters(unet)
    out = unet(x, torch.tensor([999, 499]), c["embeds"], c["pooled"], c["time_ids"])
    (out.square().sum() + out.sum()).backward()
    return out.detach(), {k: p.grad.clone() for k, p in params.items()}


@pytest.fixture(scope="module")
def remat_vars():
    """Tiny UNet weights with a LoRA (B non-zero) and without one."""
    return {"lora": _jax_unet(2, b_std=0.05)[1], "full": _jax_unet(0, seed=3)[1]}


@pytest.mark.parametrize("mode", SELECTIVE)
def test_remat_mode_gradients_equal_no_remat(remat_vars, mode):
    """Every remat mode gives the forward and the LoRA gradients (and, with
    every weight trained, all gradients) of no remat, bit for bit: remat
    re-runs the same arithmetic."""
    for v, rank, full in ((remat_vars["lora"], 2, False), (remat_vars["full"], 0, True)):
        want_out, want = _micro_grads(_port_unet(v, rank), full)
        got_out, got = _micro_grads(_port_unet(v, rank, remat=mode), full)
        assert torch.equal(got_out, want_out)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want), mode


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_reruns_no_weight_product_in_the_backward(remat_vars):
    """Counted at the dispatcher over the backward of one pass: ``full``
    recomputes the weight products (``aten.mm`` / ``aten.addmm``) and the
    convolutions; ``dots`` saved the weight products, so its backward runs
    exactly the ``aten.mm`` of no remat and no ``addmm``, and recomputes the
    convolutions and batched products; ``resnets`` recomputes no attention
    (``aten.bmm`` as no remat)."""
    counts = {}
    for mode in ("", "full", "dots", "resnets"):
        unet = _port_unet(remat_vars["lora"], 2, remat=mode)
        lora_parameters(unet)
        r = np.random.default_rng(7)
        c = {k: torch.from_numpy(v) for k, v in _cond(r, 2).items()}
        x = torch.from_numpy(r.standard_normal((2, 4, 8, 8)).astype(np.float32))
        loss = unet(x, torch.tensor([999, 499]), c["embeds"], c["pooled"],
                    c["time_ids"]).square().sum()
        with _OpCount() as op:
            loss.backward()
        counts[mode] = op.counts
    get = lambda mode, op: counts[mode].get(f"aten.{op}", 0)
    assert get("full", "mm") > get("", "mm") and get("full", "addmm") > 0
    assert get("dots", "mm") == get("", "mm") and get("dots", "addmm") == get("", "addmm") == 0
    assert get("dots", "convolution") == get("full", "convolution") > get("", "convolution")
    assert get("dots", "bmm") == get("full", "bmm") > get("", "bmm") == get("resnets", "bmm")


def test_bf16_storage_computes_as_jax_param_dtype():
    """Weights stored in bf16, computing in fp32: the UNet as JAX's with
    ``param_dtype=bfloat16`` (the same bf16 values), which casts them at
    use as the port's layers do."""
    model, variables = _jax_unet(4, b_std=0.05, param_dtype=jnp.bfloat16)
    rounded = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
                           variables)
    jvars = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), rounded)
    unet = _port_unet(rounded, 4).set_param_dtype(torch.bfloat16)
    assert all(p.dtype == (torch.float32 if ".lora." in n else torch.bfloat16)
               for n, p in unet.named_parameters())
    r = np.random.default_rng(2)
    c = _cond(r, 3)
    x = r.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 499, 17], np.int32)
    want = jax.jit(model.apply)(jvars, jnp.asarray(x), jnp.asarray(t),
                                *(jnp.asarray(v) for v in c.values()))
    with torch.no_grad():
        got = unet(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   *(torch.from_numpy(v) for v in c.values()))
    assert got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1), want)


def test_fp32_masters_compute_as_their_bf16_weights():
    """A bf16-computing UNet whose weights are fp32 masters holding bf16
    values gives, bit for bit, what the same UNet with bf16 weights gives
    (every weight is cast at use), and ``frozen_copy`` of it is that bf16
    UNet without LoRA."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(tunet.UNetConfig.tiny(lora_rank=0), dtype=torch.bfloat16)
    bf16 = tunet.SDXLUNet(cfg, device="cpu")
    tlayers.init_random_(bf16, torch.Generator().manual_seed(4))
    masters = tunet.SDXLUNet(cfg, device="cpu")
    masters.load_state_dict(bf16.state_dict())
    masters.set_param_dtype(torch.float32)
    assert all(p.dtype == torch.float32 for p in masters.parameters())
    ref = tunet.frozen_copy(masters)
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in ref.parameters())
    r = np.random.default_rng(3)
    c = {k: torch.from_numpy(v) for k, v in _cond(r, 2).items()}
    x = torch.from_numpy(r.standard_normal((2, 4, 8, 8)).astype(np.float32))
    t = torch.tensor([999, 17])
    with torch.no_grad():
        outs = [m(x, t, c["embeds"], c["pooled"], c["time_ids"]) for m in (bf16, masters, ref)]
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])


def test_decode_chunk_is_bit_equal_to_the_whole_batch():
    """``decode_chunk`` latents a VAE call give each chunk's images of one
    call, bit for bit, in order, and the whole batch's within 1e-6: the
    CPU's convolutions and products pick their kernels by batch size (the
    decoder's ``conv_in`` at batch 1 differs from batch 4 by 7e-7), so a
    chunk of 1 is not bit-equal to a batch of 4 here. A chunk that does not
    divide the batch is refused (the JAX package asserts it)."""
    pipe = SDXLPipeline.random(tiny=True, resolution=16, lora_rank=0, dtype=torch.float32,
                               device="cpu", with_scorer=False)
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 2, 2, 4))
                         .astype(np.float32))
    with torch.no_grad():
        whole = pipe.decode(z)
        for chunk in (1, 2, 4, 8):
            pipe.decode_chunk = chunk
            got = pipe.decode(z)
            pipe.decode_chunk = 0
            parts = [pipe.decode(z[i:i + chunk]) for i in range(0, 4, chunk)]
            assert torch.equal(got, torch.cat(parts)), chunk
            _close(got, whole.numpy(), atol=1e-6, rtol=0)
        pipe.decode_chunk = 3
        with pytest.raises(ValueError, match="does not divide"):
            pipe.decode(z)


def test_gelu_exact_flips_the_flavor_as_jax():
    """``set_gelu_exact`` makes bf16 take the exact erf GELU, as JAX
    ``set_gelu_exact`` does; fp32 takes it either way. A bf16 GEGLU then
    computes erf's GELU."""
    geglu = tlayers.GEGLU(8, 16, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32))
    x = x.to(torch.bfloat16)
    try:
        for force in (False, True):
            tlayers.set_gelu_exact(force)
            jlayers.set_gelu_exact(force)
            for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                assert (tlayers.gelu_approximate(tdt) == "tanh") == jlayers._gelu_approx(jdt)
            with torch.no_grad():
                hidden, gate = geglu.proj(x).chunk(2, dim=-1)
                want = hidden * F.gelu(gate, approximate="none" if force else "tanh")
                assert torch.equal(geglu(x), want)
        assert tlayers.gelu_approximate(torch.bfloat16) == "none"
    finally:
        tlayers.set_gelu_exact(False)
        jlayers.set_gelu_exact(False)


def test_runner_full_finetune_with_offload_end_to_end(tmp_path):
    """``use_lora=False`` with ``offload_aux_during_update`` through the
    runner: the first loss log 2, every UNet weight trained and the
    reference copy unchanged, the offload logged (a no-op move on the CPU),
    a checkpoint holding the whole UNet and no LoRA file; resumed from it,
    the second epoch equals the uninterrupted run's, bit for bit."""
    over = [f"output_dir={tmp_path}", "use_lora=False", "offload_aux_during_update=True",
            "train.learning_rate=1e-3", "checkpointing_steps=1"]
    config = build_config(True, over + ["run_name=a"])
    state, history, pipe = online_runner.run_online_pso(config, num_epochs=2, device="cpu")
    assert abs(history[0]["loss"] - math.log(2.0)) < 1e-6 and state.step == 2
    assert set(state.lora) == {n for n, _ in pipe.unet.named_parameters()}
    assert not any(".lora." in n for n in state.lora)
    ref = pipe.reference_unet.state_dict()
    fresh = SDXLPipeline.random(tiny=True, resolution=16, lora_rank=0, dtype=torch.float32,
                                seed=config.seed, device="cpu", with_scorer=False).unet
    assert all(torch.equal(v, ref[k]) for k, v in fresh.state_dict().items())
    assert all(not torch.equal(p, ref[k]) for k, p in state.lora.items())
    run = tmp_path / "a"
    rows = [json.loads(r) for r in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(r["offload_bytes"] > 0 and "time/offload_s" in r and "time/reload_s" in r
               for r in rows if "loss" in r)
    assert not list(run.glob("lora-*")) and (run / "checkpoint-2").exists()

    config = build_config(True, over + ["run_name=b"])
    online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    config.resume_from = str(tmp_path / "b")
    resumed, history_b, _ = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert resumed.step == 2 and history_b == history[1:]
    for k, p in state.lora.items():
        assert torch.equal(resumed.lora[k], p), k


@pytest.mark.parametrize("override", [
    "param_dtype=bfloat16", "activation_checkpoint=dots", "vae_decode_chunk=2",
    "kernels.gelu_exact=True"])
def test_runner_takes_the_memory_knobs(tmp_path, override):
    """Each knob runs a tiny epoch (a fresh adapter: loss log 2);
    ``param_dtype=bfloat16`` stores the UNet's weights in bf16 (the
    adapter stays fp32), with every weight trained too."""
    config = build_config(True, [f"output_dir={tmp_path}", "run_name=k", override])
    _, history, pipe = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
    assert abs(history[0]["loss"] - math.log(2.0)) < 1e-6
    if override == "param_dtype=bfloat16":
        assert {p.dtype for n, p in pipe.unet.named_parameters() if ".lora." not in n} == {
            torch.bfloat16}
        config = build_config(True, [f"output_dir={tmp_path}", "run_name=f", override,
                                     "use_lora=False"])
        state, history, pipe = online_runner.run_online_pso(config, num_epochs=1, device="cpu")
        assert {p.dtype for p in state.lora.values()} == {torch.bfloat16}
        assert math.isfinite(history[0]["loss"]) and pipe.reference_unet is not None
    else:
        key, value = override.split("=")
        want = {"activation_checkpoint": lambda: pipe.unet.config.remat == "dots",
                "vae_decode_chunk": lambda: pipe.decode_chunk == 2,
                "kernels.gelu_exact": lambda: tlayers.gelu_approximate(torch.bfloat16) == "none"}
        assert want[key](), override
    tlayers.set_gelu_exact(False)


def test_dreambooth_cli_takes_a_selective_remat_mode(tmp_path):
    """``--gradient_checkpointing --gradient_checkpointing_mode dots``
    reaches the UNet and trains one step."""
    d = tmp_path / "instance"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(d / f"{i}.png"), rng.integers(0, 256, (40, 36, 3)).astype(np.uint8))
    state, history, pipe = db_cli.main([
        "--tiny", "--device", "cpu", "--instance_data_dir", str(d), "--instance_prompt",
        "a photo of sks dog", "--class_prompt", "a photo of dog", "--output_dir",
        str(tmp_path / "out"), "--rank", "2", "--num_negatives", "2", "--sample_batch_size", "2",
        "--max_train_steps", "1", "--gradient_checkpointing", "--gradient_checkpointing_mode",
        "dots", "--skip_validation"])
    assert pipe.unet.config.remat == "dots" and state.step == 1
    assert math.isfinite(history[0]["loss"])
