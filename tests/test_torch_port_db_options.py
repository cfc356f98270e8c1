"""The port's DreamBooth options against the JAX package, fp32 on the CPU
with the tiny models: DoRA (``models/layers.py::LoRALinear``), the CLIP
text towers' LoRA, the optimizers (``train/prodigy.py``,
``train/quantized_adam.py``, bf16 first moments, the CLI's multi-group
factory), the DoRA and text-encoder-LoRA updates, the diffusers and kohya
exports, and a CLI run with every option that resumes to the state of an
uninterrupted one.

JAX params are drawn with numpy in ``jax.eval_shape``'s shapes and carried
into the port with ``state_dict_from_jax``; the JAX trainer's random draws
are handed to the port's update; optimizer inputs are numpy draws.
Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test says otherwise.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy

from pairwise_sample_optimization_tpu.checkpoints import convert as jconv
from pairwise_sample_optimization_tpu.checkpoints import lora_safetensors as jls
from pairwise_sample_optimization_tpu.cli import train_pso_sdxl_turbo_dreambooth as jcli
from pairwise_sample_optimization_tpu.models import clip as jclip
from pairwise_sample_optimization_tpu.models import layers as jlayers
from pairwise_sample_optimization_tpu.models import sdxl_text as jtext
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.train import dreambooth_pso as jdbp
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu.train.prodigy import prodigy as jprodigy
from pairwise_sample_optimization_tpu.train.quantized_adam import adam8bit as jadam8bit
from pairwise_sample_optimization_tpu_torch.checkpoints import (KOHYA_FILE, LORA_FILE,
                                                                export_kohya_lora_safetensors,
                                                                export_sdxl_lora_safetensors,
                                                                import_lora_safetensors, load_file,
                                                                save_file, state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.checkpoints.torch_names import (clip_text_param_map,
                                                                            unet_param_map)
from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as cli
from pairwise_sample_optimization_tpu_torch.models import clip as tclip
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.models.layers import LoRALinear
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.train import (DreamBoothPSOConfig,
                                                          DreamBoothPSOTrainer, PSOTrainState,
                                                          lora_parameters, make_optimizer)
from pairwise_sample_optimization_tpu_torch.train.prodigy import Prodigy
from pairwise_sample_optimization_tpu_torch.train.quantized_adam import Adam8bit
from pairwise_sample_optimization_tpu_torch.utils.png import write_png

ATOL, RTOL = 3e-5, 2e-4
RANK, GA, B, HW, CTX = 2, 2, 2, 8, 5
HP = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-4,
          max_grad_norm=1.0)
NO_CLIP = math.inf  # the optimizers alone: the JAX transformations have no clip


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


def _random_variables(shapes, seed, lora_b_std=0.05):
    """Weights in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, small biases, LoRA A gaussian with std
    1/rank, B gaussian with std ``lora_b_std``, DoRA magnitudes uniform in
    [0.8, 1.2]."""
    r = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "magnitude":
            return r.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "b":
            return (r.standard_normal(shape) * lora_b_std).astype(np.float32)
        if name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or len(shape) < 2 or "embedding" in name:
            std = 0.02
        else:
            std = 1.0 / math.sqrt(np.prod(shape[:-1]))
        return (r.standard_normal(shape) * std).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape) for k, v in node.items()}

    return walk(shapes)


def _ids(rng, shape, vocab=1000):
    ids = rng.integers(1, vocab - 1, size=shape + (77,)).astype(np.int32)
    flat = ids.reshape(-1, 77)
    flat[np.arange(flat.shape[0]), rng.integers(5, 70, size=flat.shape[0])] = vocab - 1
    return ids


# ---------------------------------------------------------------------- #
# DoRA
# ---------------------------------------------------------------------- #


def _dora_pair(seed=0, rank=3, b_std=0.3):
    """The JAX ``LoRADense(use_dora=True)`` and the port's ``LoRALinear``
    with the same numpy-drawn weights (in 5, out 6)."""
    layer = jlayers.LoRADense(6, lora_rank=rank, use_dora=True, dtype=jnp.float32)
    shapes = jax.eval_shape(layer.init, jax.random.key(0), jnp.zeros((1, 5)))
    v = _random_variables(shapes, seed, lora_b_std=b_std)
    port = LoRALinear(5, 6, lora_rank=rank, use_dora=True, dtype=torch.float32)
    p, lo = v["params"], v["lora"]
    port.load_state_dict({"weight": torch.from_numpy(p["kernel"].T.copy()),
                          "bias": torch.from_numpy(p["bias"]),
                          "lora.down.weight": torch.from_numpy(lo["a"].T.copy()),
                          "lora.up.weight": torch.from_numpy(lo["b"].T.copy()),
                          "lora.magnitude": torch.from_numpy(lo["magnitude"])})
    return layer, v, port


def test_dora_linear_forward_and_grads_match_jax():
    layer, v, port = _dora_pair()
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 4, 5)).astype(np.float32)
    w = r.standard_normal((2, 4, 6)).astype(np.float32)

    def loss(lora):
        return jnp.sum(layer.apply({"params": v["params"], "lora": lora}, x, 0.7) * w)

    y_j = layer.apply(v, x, 0.7)
    g_j = jax.grad(loss)(v["lora"])
    y = port(torch.from_numpy(x), 0.7)
    (y * torch.from_numpy(w)).sum().backward()
    _close(y, y_j)
    _close(port.lora.down.weight.grad.T, g_j["a"])
    _close(port.lora.up.weight.grad.T, g_j["b"])
    _close(port.lora.magnitude.grad, g_j["magnitude"])
    assert float(port.lora.magnitude.grad.abs().max()) > 1e-3


def test_dora_at_static_scale_0_is_the_base_layer():
    layer, v, port = _dora_pair(seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32))
    base = torch.nn.functional.linear(x, port.weight, port.bias)
    assert torch.equal(port(x, 0), base) and torch.equal(port(x, 0.0), base)
    _close(layer.apply(v, x.numpy(), 0.0), base)
    assert not torch.allclose(port(x, 1.0), base, atol=1e-3)  # the adapter does act


def test_dora_at_init_is_the_base_layer_and_its_magnitude_the_row_norms():
    port = LoRALinear(5, 6, lora_rank=3, use_dora=True, dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32))
    _close(port(x), torch.nn.functional.linear(x, port.weight, port.bias), atol=1e-6, rtol=1e-6)
    want = jconv.refresh_dora_magnitudes({"s": {"kernel": port.weight.detach().numpy().T}},
                                         {"s": {"magnitude": np.zeros(6, np.float32)}})
    _close(port.lora.magnitude, want["s"]["magnitude"], atol=1e-6, rtol=1e-6)


def test_dora_refuses_a_per_sample_scale_as_jax_does():
    layer, v, port = _dora_pair(seed=5)
    x = np.zeros((2, 5), np.float32)
    with pytest.raises(ValueError, match="scalar lora_scale"):
        port(torch.from_numpy(x), torch.ones(2))
    with pytest.raises(ValueError, match="scalar lora_scale"):
        layer.apply(v, x, jnp.ones((2,)))
    port(torch.from_numpy(x), torch.tensor(0.5))  # a 0-d tensor is a scalar


def test_dora_magnitudes_are_refreshed_after_from_torch_dir(tmp_path):
    """A diffusers directory written from other random towers: every
    DoRA magnitude (UNet and both text encoders) equals the loaded weight's
    row norms, as the JAX package's ``refresh_dora_magnitudes`` makes them,
    so the adapters are no-ops at step 0."""
    src = SDXLPipeline.random(tiny=True, lora_rank=0, dtype=torch.float32, seed=7, device="cpu",
                              with_scorer=False)
    for folder, module in (("unet", src.unet), ("vae", src.vae), ("text_encoder", src.te1),
                           ("text_encoder_2", src.te2)):
        (tmp_path / folder).mkdir()
        save_file(module.state_dict(), str(tmp_path / folder / "model.safetensors"))
    pipe = SDXLPipeline.from_torch_dir(str(tmp_path), lora_rank=RANK, dtype=torch.float32,
                                       tiny=True, device="cpu", with_scorer=False,
                                       te_lora_rank=RANK, use_dora=True)
    dora = lambda tower: [m for m in tower.modules() if isinstance(m, LoRALinear) and m.use_dora]
    assert len(dora(pipe.te1)) == len(dora(pipe.te2)) == 2 * 4  # q, k, v, out of 2 layers
    layers = dora(pipe.unet) + dora(pipe.te1) + dora(pipe.te2)
    for m in layers:
        want = jconv.refresh_dora_magnitudes({"s": {"kernel": m.weight.detach().numpy().T}},
                                             {"s": {"magnitude": np.zeros(1, np.float32)}})
        _close(m.lora.magnitude, want["s"]["magnitude"], atol=1e-6, rtol=1e-6)
    ids = torch.from_numpy(_ids(np.random.default_rng(0), (2,)).astype(np.int64))
    out = pipe.te2(ids)["projected"]
    with torch.no_grad():
        for m in layers:
            m.lora.up.weight.normal_(0, 0.1)
    assert not torch.allclose(pipe.te2(ids)["projected"], out, atol=1e-4)
    for m in layers:
        m.lora.up.weight.data.zero_()
    _close(pipe.te2(ids)["projected"], out, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------- #
# the CLIP text towers' LoRA
# ---------------------------------------------------------------------- #


def _te_configs(dora=False):
    """The tiny pipeline's two text encoders (widths 16 + 16), LoRA rank
    ``RANK``: (JAX configs, port configs)."""
    j1 = dataclasses.replace(jclip.CLIPTextConfig.tiny(), width=16, heads=2, lora_rank=RANK,
                             lora_use_dora=dora)
    j2 = dataclasses.replace(j1, projection_dim=16)
    t1 = dataclasses.replace(tclip.CLIPTextConfig.tiny(torch.float32), width=16, heads=2,
                             lora_rank=RANK, lora_use_dora=dora)
    t2 = dataclasses.replace(t1, projection_dim=16)
    return (j1, j2), (t1, t2)


def _te_towers(dora, seed):
    (j1, j2), (t1, t2) = _te_configs(dora)
    out = []
    for jcfg, tcfg, s in ((j1, t1, seed), (j2, t2, seed + 1)):
        model = jclip.CLIPTextTower(jcfg)
        shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 77), jnp.int32))
        v = _random_variables(shapes, s)
        tower = tclip.CLIPTextTower(tcfg, device="cpu")
        tower.load_state_dict(state_dict_from_jax(v, "clip_text"), strict=True)
        out.append((model, v, tower))
    return out


@pytest.mark.parametrize("dora", [False, True])
def test_clip_text_tower_with_lora_matches_jax(dora):
    (model, v, tower), _ = _te_towers(dora, 10)
    r = np.random.default_rng(2)
    ids = _ids(r, (3,))
    w_proj = r.standard_normal((3, 16)).astype(np.float32)
    w_pen = r.standard_normal((3, 77, 16)).astype(np.float32)

    def loss(lora):
        out = model.apply({"params": v["params"], "lora": lora}, jnp.asarray(ids))
        return jnp.sum(out["projected"] * w_proj) + jnp.sum(out["penultimate"] * w_pen)

    out_j = jax.jit(model.apply)(v, jnp.asarray(ids))
    grads_j = jax.jit(jax.grad(loss))(v["lora"])
    lora = lora_parameters(tower)
    out = tower(torch.from_numpy(ids).long())
    for k in ("penultimate", "last_hidden_state", "pooled", "projected"):
        _close(out[k], out_j[k])
    (torch.sum(out["projected"] * torch.from_numpy(w_proj))
     + torch.sum(out["penultimate"] * torch.from_numpy(w_pen))).backward()
    want = state_dict_from_jax({"params": {}, "lora": grads_j}, "clip_text")
    assert set(want) == set(lora) and len(lora) == 2 * 4 * (3 if dora else 2)
    for k, g in want.items():
        _close(lora[k].grad, g)


# ---------------------------------------------------------------------- #
# optimizers
# ---------------------------------------------------------------------- #

SHAPES = {"w.lora.down.weight": (17, 20), "w.lora.up.weight": (300,), "u.lora.magnitude": (5,)}


def _opt_inputs(seed, steps=5, shapes=SHAPES):
    r = np.random.default_rng(seed)
    params = {k: (r.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.standard_normal(s) * r.choice([1e-3, 0.1, 3.0])).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    return params, grads


def _run_jax(tx, params, grads):
    tree = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(tree)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, tree)
        tree = optax.apply_updates(tree, updates)
    return tree, state


def _run_port(make, params, grads):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tx = make(ps)
    for g in grads:
        tx.step(ps, {k: torch.from_numpy(v) for k, v in g.items()})
    return ps, tx


@pytest.mark.parametrize("knobs", [
    dict(decouple=True, use_bias_correction=True, safeguard_warmup=True, weight_decay=1e-2),
    dict(decouple=False, use_bias_correction=True, safeguard_warmup=False, weight_decay=0.1),
    dict(decouple=True, use_bias_correction=False, safeguard_warmup=False, weight_decay=0.0),
    dict(decouple=True, use_bias_correction=False, safeguard_warmup=True, weight_decay=1e-3,
         beta3=0.9, d_coef=2.0),
], ids=["cli-defaults", "coupled-decay", "plain", "warmup-beta3"])
def test_prodigy_five_steps_match_jax(knobs):
    params, noise = _opt_inputs(0)
    # a steady direction plus noise: the distance travelled grows, and with it d
    grads = [{k: noise[0][k] + 0.1 * g[k] for k in g} for g in noise]
    tree, state = _run_jax(jprodigy(learning_rate=1.0, **knobs), params, grads)
    ps, tx = _run_port(lambda p: Prodigy(p, learning_rate=1.0, max_grad_norm=NO_CLIP, **knobs),
                       params, grads)
    # d grows from d0 within 5 steps unless the bias correction and the
    # warmup safeguard both slow it (the CLI's defaults)
    cli_defaults = knobs["use_bias_correction"] and knobs["safeguard_warmup"]
    assert float(state.d) == np.float32(1e-6) if cli_defaults else float(state.d) > 1.2e-6
    _close(tx.d, state.d)
    _close(tx.numerator, state.numerator)
    for k in params:
        _close(ps[k], tree[k])


def test_adam8bit_five_steps_int8_state_bit_equal_to_jax():
    params, grads = _opt_inputs(1)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    tree, state = _run_jax(jadam8bit(1e-2, **hp), params, grads)
    ps, tx = _run_port(lambda p: Adam8bit([{"params": p, "lr": 1e-2, "weight_decay": 1e-2}],
                                          max_grad_norm=NO_CLIP), params, grads)
    for k in params:
        mu_q, mu_s, nu_q, nu_s = tx.tensor_state(k)
        want = (state.mu[k].q, state.mu[k].scale, state.nu[k].q, state.nu[k].scale)
        for got, w in zip((mu_q, mu_s, nu_q, nu_s), want):
            assert got.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=k)
        _close(ps[k], tree[k], atol=1e-6, rtol=0)
    assert tx.mu_q.dtype == torch.int8 and tx.mu_q.shape == (2 + 2 + 1, 256)


def test_bf16_first_moments_match_optax_adamw_mu_dtype():
    params, grads = _opt_inputs(2)
    tree, state = _run_jax(optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
                                       mu_dtype=jnp.bfloat16), params, grads)
    ps, tx = _run_port(lambda p: make_optimizer(p, learning_rate=1e-2, weight_decay=1e-2,
                                                max_grad_norm=NO_CLIP, state_dtype="bfloat16"),
                       params, grads)
    adam = state[0]
    start = 0
    for k in params:
        n = params[k].size
        mu = tx.mu[start:start + n].view(params[k].shape)
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(mu.float().numpy(), np.asarray(adam.mu[k], np.float32))
        _close(tx.nu[start:start + n].view(params[k].shape), adam.nu[k])
        _close(ps[k], tree[k])
        start += n


def _factory_args(*extra):
    argv = ["--instance_data_dir", "x", "--instance_prompt", "a sks dog", "--max_grad_norm",
            "0.05", "--lr_warmup_steps", "2", *extra]
    return cli.parse_args(argv), jcli.parse_args(argv)


@pytest.mark.parametrize("kind, extra", [
    ("FlatAdamW", ["--text_encoder_lr", "3e-4", "--adam_weight_decay_text_encoder", "1e-2",
                   "--lr_scheduler", "polynomial", "--lr_power", "2.0"]),
    ("Adam8bit", ["--use_8bit_adam", "--text_encoder_lr", "5e-5", "--lr_scheduler", "cosine"]),
    ("Prodigy", ["--optimizer", "prodigy", "--learning_rate", "1.0", "--lr_scheduler", "linear"]),
], ids=["adamw-two-groups", "adam8bit-two-groups", "prodigy-scheduled"])
def test_dreambooth_optimizer_factory_matches_jax(kind, extra):
    """The JAX CLI's ``_make_optimizer`` over {unet, te1, te2} (the clip
    engaged on some steps) against ``make_dreambooth_optimizer`` over the
    same tensors under the train state's names."""
    args, jargs = _factory_args("--train_text_encoder", *extra)
    shapes = {"unet": {"a": (6, 4), "b": (300,)}, "te1": {"a": (3, 5)}, "te2": {"a": (7,)}}
    names = {("unet", "a"): "m.lora.down.weight", ("unet", "b"): "m.lora.up.weight",
             ("te1", "a"): "te1.q.lora.down.weight", ("te2", "a"): "te2.q.lora.up.weight"}
    flat_shapes = {names[(t, k)]: s for t, d in shapes.items() for k, s in d.items()}
    params, grads = _opt_inputs(3, shapes=flat_shapes)
    nest = lambda d: {t: {k: jnp.asarray(d[names[(t, k)]]) for k in shapes[t]} for t in shapes}
    tx = jcli._make_optimizer(jargs, total_steps=5)
    tree = nest(params)
    state = tx.init(tree)
    for g in grads:
        updates, state = tx.update(nest(g), state, tree)
        tree = optax.apply_updates(tree, updates)
    ps, ptx = _run_port(lambda p: cli.make_dreambooth_optimizer(args, p, total_steps=5),
                        params, grads)
    assert type(ptx).__name__ == kind
    for (t, k), name in names.items():
        _close(ps[name], tree[t][k])


# ---------------------------------------------------------------------- #
# the DoRA and text-encoder-LoRA updates
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def te_setup():
    """Random tiny UNet (+ DoRA) and text towers (+ LoRA / DoRA), a batch of
    latents and token ids, and the JAX update's draws."""
    r = np.random.default_rng(20)
    batch = {"instance_latents": r.standard_normal((GA, B, HW, HW, 4)).astype(np.float32),
             "negative_latents": r.standard_normal((GA, B, HW, HW, 4)).astype(np.float32),
             "input_ids_one": _ids(r, (GA, B)), "input_ids_two": _ids(r, (GA, B)),
             "cond": {"embeds": r.standard_normal((GA, B, CTX, 32)).astype(np.float32),
                      "pooled": r.standard_normal((GA, B, 16)).astype(np.float32),
                      "time_ids": np.tile(np.float32([512, 512, 0, 0, 512, 512]), (GA, B, 1))},
             "time_ids_win": np.tile(np.float32([600, 520, 44, 0, 32, 32]), (GA, B, 1)),
             "time_ids_lose": np.tile(np.float32([32, 32, 0, 0, 32, 32]), (GA, B, 1))}
    key = jax.random.key(9)
    idx, noise = [], []
    for k in jax.random.split(key, GA):  # the draws of the JAX update's scan
        k_t, k_n = jax.random.split(k)
        idx.append(np.asarray(jdbp.sample_lattice_timesteps(k_t, B, 1000, 4)))
        noise.append(np.asarray(jax.random.normal(k_n, (B, HW, HW, 4), jnp.float32)))
    return dict(batch=batch, key=key, idx=np.stack(idx), noise=np.stack(noise))


@pytest.mark.parametrize("dora, te, loss_type", [(True, False, "pso"), (False, True, "pso_db"),
                                                 (False, True, "pso")],
                         ids=["dora-pso-unfused", "te-pso_db", "te-pso-fused"])
def test_update_with_dora_or_text_encoder_lora_matches_jax(te_setup, dora, te, loss_type):
    """The reference pass of ``pso`` with text-encoder LoRA takes the live
    adapters' conditioning (the JAX package's choice); DoRA runs the
    reference as its own forward at a static scale of 0."""
    s = te_setup
    jcfg_u = dataclasses.replace(junet.UNetConfig.tiny(lora_rank=RANK), lora_use_dora=dora)
    model = junet.SDXLUNet(jcfg_u)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, HW, HW, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, CTX, 32)), jnp.zeros((1, 16)),
                            jnp.zeros((1, 6)))
    uv = _random_variables(shapes, 0)
    unet = tunet.SDXLUNet(dataclasses.replace(tunet.UNetConfig.tiny(lora_rank=RANK),
                                              lora_use_dora=dora), device="cpu")
    unet.load_state_dict(state_dict_from_jax(uv, "unet", n_levels=2), strict=True)

    def unet_apply(v, x, t, c, lora_scale):
        return model.apply(v, x, t, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    cfg = dict(loss_type=loss_type, fuse_ref_pass=not dora, grad_accum=GA,
               train_text_encoder=te)
    dropped = ("cond",) if te else ("input_ids_one", "input_ids_two")
    batch = {k: v for k, v in s["batch"].items() if k not in dropped}
    jlora, jparams = uv["lora"], uv["params"]
    pipe = SDXLPipeline(unet=unet, vae=None, te1=None, te2=None, resolution=32)
    lora = lora_parameters(unet)
    encode = None
    if te:
        (m1, v1, pipe.te1), (m2, v2, pipe.te2) = _te_towers(dora, 30)

        def encode(te_params, te_loras, i1, i2):
            embeds, pooled = jtext.encode_sdxl_prompt(
                m1, {"params": te_params["te1"], "lora": te_loras["te1"]},
                m2, {"params": te_params["te2"], "lora": te_loras["te2"]}, i1, i2)
            return {"embeds": embeds, "pooled": pooled,
                    "time_ids": jtext.compute_time_ids(i1.shape[0], 32)}

        jlora = {"unet": uv["lora"], "te1": v1["lora"], "te2": v2["lora"]}
        jparams = {"unet": uv["params"], "te1": v1["params"], "te2": v2["params"]}
        for which in ("te1", "te2"):
            lora.update({f"{which}.{k}": p
                         for k, p in lora_parameters(getattr(pipe, which)).items()})
    tx = jts.make_optimizer(**HP)
    jtrainer = jdbp.DreamBoothPSOTrainer(jdbp.DreamBoothPSOConfig(**cfg), unet_apply, tx,
                                         encode_prompt=encode)
    jnew, jaux = jax.jit(jtrainer._update_impl)(jts.PSOTrainState.create(jlora, tx), jparams,
                                                jax.tree.map(jnp.asarray, batch), s["key"])
    state = PSOTrainState.create(lora, make_optimizer(lora, **HP))
    before = {k: p.detach().clone() for k, p in lora.items()}
    tree = lambda x: ({k: tree(v) for k, v in x.items()} if isinstance(x, dict)
                      else torch.from_numpy(x).long() if x.dtype == np.int32
                      else torch.from_numpy(x))
    metrics = DreamBoothPSOTrainer(DreamBoothPSOConfig(**cfg), pipe).update(
        state, tree(batch), torch.from_numpy(s["idx"]).long(), torch.from_numpy(s["noise"]))
    for k in ("loss", "win_loss", "lose_loss", "implicit_acc"):
        _close(np.float32(metrics[k]), jaux[k])
    want = state_dict_from_jax({"params": {}, "lora": jnew.lora["unet"] if te else jnew.lora},
                               "unet", n_levels=2)
    if te:
        for which in ("te1", "te2"):
            want.update({f"{which}.{k}": v for k, v in state_dict_from_jax(
                {"params": {}, "lora": jnew.lora[which]}, "clip_text").items()})
    assert set(want) == set(state.lora)
    for k, v in want.items():
        _close(state.lora[k], v)
    moved = {k.split(".")[0] for k in want if not torch.equal(state.lora[k], before[k])}
    assert moved == ({"te1", "te2", "down_blocks", "mid_block", "up_blocks"} if te
                     else {"down_blocks", "mid_block", "up_blocks"})


# ---------------------------------------------------------------------- #
# exports
# ---------------------------------------------------------------------- #


def _jax_lora_tree(module, shapes, site_map, prefix=""):
    """A JAX 'lora' collection in ``shapes`` holding the port module's
    adapter values (a, b transposed; magnitudes as they are)."""
    sd = {k: v.detach() for k, v in module.named_parameters() if ".lora." in k}

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            key = site_map(path + ("kernel",))[0][:-len("weight")]
            key += {"a": "lora.down.weight", "b": "lora.up.weight", "magnitude": "lora.magnitude"}[k]
            out[k] = sd[prefix + key].numpy().T
        return out

    return walk(shapes, ())


def test_diffusers_and_kohya_exports_are_bit_equal_to_jax_and_read_back(tmp_path):
    pipe = SDXLPipeline.random(tiny=True, lora_rank=RANK, dtype=torch.float32, seed=3,
                               lora_b_std=0.05, device="cpu", with_scorer=False,
                               te_lora_rank=RANK, use_dora=True)
    ushapes = jax.eval_shape(
        junet.SDXLUNet(dataclasses.replace(junet.UNetConfig.tiny(lora_rank=RANK),
                                           lora_use_dora=True)).init,
        jax.random.key(0), jnp.zeros((1, HW, HW, 4)), jnp.zeros((1,)), jnp.zeros((1, CTX, 32)),
        jnp.zeros((1, 16)), jnp.zeros((1, 6)))["lora"]
    (j1, j2), _ = _te_configs(dora=True)
    trees = {"unet": _jax_lora_tree(pipe.unet, ushapes,
                                    lambda p: unet_param_map(p, n_levels=2))}
    for which, jcfg in (("te1", j1), ("te2", j2)):
        shapes = jax.eval_shape(jclip.CLIPTextTower(jcfg).init, jax.random.key(0),
                                jnp.zeros((1, 77), jnp.int32))["lora"]
        trees[which] = _jax_lora_tree(getattr(pipe, which), shapes, clip_text_param_map)
    modules = {"unet": pipe.unet, "te1": pipe.te1, "te2": pipe.te2}
    for port_fn, jax_fn, name in (
            (export_sdxl_lora_safetensors, jls.export_sdxl_lora_safetensors, LORA_FILE),
            (export_kohya_lora_safetensors, jls.export_kohya_lora_safetensors, KOHYA_FILE)):
        got = port_fn(modules, str(tmp_path / name))
        want = jax_fn(trees, n_levels=2)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        back = st_load_numpy(str(tmp_path / name))  # the safetensors package reads the file
        assert set(back) == set(want) and all(np.array_equal(back[k], want[k]) for k in want)
    kohya = st_load_numpy(str(tmp_path / KOHYA_FILE))
    alphas = [k for k in kohya if k.endswith(".alpha")]
    assert alphas and all(kohya[k].shape == () and kohya[k] == RANK for k in alphas)
    assert any(k.startswith("lora_te2_") and k.endswith(".dora_scale") for k in kohya)
    diffusers = load_file(str(tmp_path / LORA_FILE))
    assert {k.split(".")[0] for k in diffusers} == {"unet", "text_encoder", "text_encoder_2"}
    # the import takes magnitudes and the text-encoder prefixes (diffusers and peft keys)
    fresh = SDXLPipeline.random(tiny=True, lora_rank=RANK, dtype=torch.float32, seed=9,
                                device="cpu", with_scorer=False, te_lora_rank=RANK,
                                use_dora=True)
    peft = {k.replace("lora_magnitude_vector", "lora_magnitude_vector.weight"): v
            for k, v in diffusers.items()}
    import_lora_safetensors(str(tmp_path / LORA_FILE), fresh.unet)
    import_lora_safetensors(peft, fresh.te1, prefix="text_encoder.")
    import_lora_safetensors(diffusers, fresh.te2, prefix="text_encoder_2.")
    for which in ("unet", "te1", "te2"):
        a, b = lora_parameters(getattr(pipe, which)), lora_parameters(getattr(fresh, which))
        assert all(torch.equal(a[k], b[k]) for k in a), which


# ---------------------------------------------------------------------- #
# the CLI with every option
# ---------------------------------------------------------------------- #


def test_cli_with_every_option_resumes_to_the_uninterrupted_state(tmp_path):
    """DoRA, text-encoder LoRA, Prodigy (``--use_8bit_adam`` has no effect
    beside it, as in the JAX CLI), the kohya export: 2 steps in one run
    equal 1 step, then a resume from checkpoint-1, then 1 step."""
    inst = tmp_path / "instance"
    inst.mkdir()
    r = np.random.default_rng(0)
    for i, (h, w) in enumerate(((44, 38), (38, 46))):
        write_png(str(inst / f"{i}.png"), r.integers(0, 256, (h, w, 3)).astype(np.uint8))

    def argv(out, steps, *extra):
        return ["--tiny", "--device", "cpu", "--instance_data_dir", str(inst),
                "--instance_prompt", "a photo of sks dog", "--class_prompt", "a photo of dog",
                "--output_dir", str(tmp_path / out), "--rank", str(RANK), "--num_negatives", "3",
                "--sample_batch_size", "2", "--gradient_accumulation_steps", "2",
                "--skip_validation", "--checkpointing_steps", "1", "--loss_type", "pso",
                "--use_dora", "--train_text_encoder", "--optimizer", "prodigy",
                "--learning_rate", "1.0", "--use_8bit_adam", "--output_kohya_format",
                "--max_train_steps", str(steps), *extra]

    whole, history, _ = cli.main(argv("whole", 2))
    assert isinstance(whole.tx, Prodigy) and math.isfinite(float(whole.tx.d))
    assert abs(history[0]["loss"] - 0.5 * history[0]["lose_loss"] - math.log(2.0)) < 1e-6
    cli.main(argv("split", 1))
    resumed, history2, _ = cli.main(argv("split", 2, "--resume_from_checkpoint", "latest"))
    assert resumed.step == whole.step == 2 and len(history2) == 1
    assert history2[0]["loss"] == history[1]["loss"]
    assert set(resumed.lora) == set(whole.lora)
    assert any(k.startswith("te2.") and k.endswith(".lora.magnitude") for k in whole.lora)
    for k, p in whole.lora.items():
        assert torch.equal(resumed.lora[k], p), k
    for k in ("d", "numerator", "m", "s", "p0"):
        assert torch.equal(getattr(resumed.tx, k), getattr(whole.tx, k)), k
    for name in (LORA_FILE, KOHYA_FILE):
        a, b = (load_file(str(tmp_path / run / "lora-2" / name)) for run in ("whole", "split"))
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), name
    diffusers = load_file(str(tmp_path / "split" / "lora-2" / LORA_FILE))
    assert {k.split(".")[0] for k in diffusers} == {"unet", "text_encoder", "text_encoder_2"}
    assert len(diffusers) == len(whole.lora)
