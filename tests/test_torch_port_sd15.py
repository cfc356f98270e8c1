"""The port's SD1.x family against the JAX package, fp32 on the CPU.

The fixed-head SD1.x UNet (``UNetConfig.sd15`` and the tiny config of
``tests/test_sd15_and_ddim_sampler.py``), ``ops/ddim.py``, the CFG-DDIM
rollout, the attention's plain versions at the SD1.5 head dims (40, 80,
160) against the Pallas kernels in interpret mode, and the schedulers
against ``tests/fixtures/scheduler_goldens.npz``. JAX params are drawn with
numpy in ``jax.eval_shape``'s shapes and carried into the port with
``state_dict_from_jax``; each JAX apply is jitted once; explicit noise is
drawn in JAX from the keys the JAX samplers split. Tolerance: ATOL 3e-5 /
RTOL 2e-4 unless stated (the goldens: their own test's 2e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.checkpoints import unet_param_map as j_unet_param_map
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.ops import ddim as jddim
from pairwise_sample_optimization_tpu.ops import flash_attention as jfa
from pairwise_sample_optimization_tpu.ops import schedules as jsch
from pairwise_sample_optimization_tpu.train import sampling as jsampling
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.checkpoints.torch_names import unet_param_map
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.ops import ddim_step_with_logprob
from pairwise_sample_optimization_tpu_torch.ops import ddpm_renoise as tdr
from pairwise_sample_optimization_tpu_torch.ops import euler_ancestral as tea
from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
from pairwise_sample_optimization_tpu_torch.ops import kernel_lib
from pairwise_sample_optimization_tpu_torch.ops import schedules as tsch
from pairwise_sample_optimization_tpu_torch.parallel.tp import shard_unet_tp
from pairwise_sample_optimization_tpu_torch.train.sampling import sample_ddim_cfg_trajectories

ATOL, RTOL = 3e-5, 2e-4
B = 2
FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "scheduler_goldens.npz"))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_sd15(lib, lora_rank=0, **kw):
    """``tests/test_sd15_and_ddim_sampler.py::_tiny_sd15``'s config in
    either package (``lib`` is the JAX or the port's ``models.unet``)."""
    dtype = jnp.float32 if lib is junet else torch.float32
    return lib.UNetConfig(block_out_channels=(16, 32), transformer_layers=(1, 0),
                          mid_transformer_layers=1, layers_per_block=1, fixed_num_heads=4,
                          cross_attention_dim=16, use_text_time=False, norm_groups=8,
                          lora_rank=lora_rank, dtype=dtype, **kw)


def _four_levels(lib, **kw):
    """A 4-level SD1.x config with an attention-free last level (the
    assembly test's widths), tiny."""
    return dataclasses.replace(_tiny_sd15(lib, **kw), block_out_channels=(16, 24, 32, 32),
                               transformer_layers=(1, 1, 1, 0), cross_attention_dim=24)


def _random_params(shapes, seed):
    """Params in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, biases and embeddings small, LoRA A
    gaussian with std 1/rank and B gaussian with std 0.2 (a live adapter)."""
    r = np.random.default_rng(seed)

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            std = 0.2
        elif name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or len(shape) < 2 or "embedding" in name:
            std = 0.02
        else:
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return (r.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(cfg_j, cfg_t, hw, ctx_len, seed):
    """(jitted JAX apply, variables, port UNet, inputs x (B, hw, hw, 4), t, ctx)."""
    model = junet.SDXLUNet(cfg_j)
    r = np.random.default_rng(seed)
    inputs = (r.standard_normal((B, hw, hw, 4)).astype(np.float32),
              np.array([981, 13], np.int32),
              r.standard_normal((B, ctx_len, cfg_j.cross_attention_dim)).astype(np.float32))
    shapes = jax.eval_shape(model.init, jax.random.key(0), *map(jnp.asarray, inputs))
    variables = _random_params(dict(shapes), seed)
    port = tunet.SDXLUNet(cfg_t, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, "unet",
                                             n_levels=len(cfg_t.block_out_channels)), strict=True)
    return jax.jit(model.apply), variables, port, inputs


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def lora_pair():
    return _pair(_tiny_sd15(junet, lora_rank=4), _tiny_sd15(tunet, lora_rank=4), 8, 5, 0)


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_tiny_sd15_unet_with_lora_matches_jax(lora_pair, scale):
    apply, variables, port, (x, t, ctx) = lora_pair
    want = apply(variables, *map(jnp.asarray, (x, t, ctx)), lora_scale=scale)
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), lora_scale=scale)
    _close(got.permute(0, 2, 3, 1), want)
    assert not hasattr(port, "add_embedding")


def test_four_level_sd15_unet_without_lora_matches_jax():
    """The tiny config at four levels, the last without attention and its up
    path in reverse (``up_blocks.{3 - i}``, ``n_levels=4``), no LoRA."""
    apply, variables, port, (x, t, ctx) = _pair(_four_levels(junet), _four_levels(tunet), 8, 6, 1)
    assert "lora" not in variables and not any(".lora." in k for k in port.state_dict())
    assert {k.split(".")[1] for k in port.state_dict() if k.startswith("up_blocks")} == {
        "0", "1", "2", "3"}
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    _close(got.permute(0, 2, 3, 1), apply(variables, *map(jnp.asarray, (x, t, ctx))))


def test_tiny_sd15_unet_under_remat_matches_jax(lora_pair):
    """Under the "lowres" remat mode (decided per level) the forward with
    gradients on equals JAX's, and its LoRA gradients equal those without
    remat."""
    apply, variables, plain, (x, t, ctx) = lora_pair
    port = tunet.SDXLUNet(_tiny_sd15(tunet, lora_rank=4, remat="lowres"), device="cpu")
    port.load_state_dict(plain.state_dict())
    want = apply(variables, *map(jnp.asarray, (x, t, ctx)))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, 4, 8, 8)).astype(
        np.float32))
    grads = []
    for unet in (port, plain):
        out = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
        _close(out.permute(0, 2, 3, 1), want)
        lora = [p for n, p in unet.named_parameters() if ".lora." in n]
        grads.append(torch.autograd.grad((out * g).sum(), lora))
    for a, b in zip(*grads):
        _close(a, b.numpy(), atol=1e-6, rtol=1e-5)


def test_heads_for_fixed_heads_and_tp_slicing():
    """``heads_for`` as JAX's; SD1.5's 8 heads give head dims 40, 80 and 160;
    tensor parallelism slices whole heads of a fixed-head UNet as it does
    SDXL's (4 of 8 on each of 2 model ranks)."""
    for lib_cfg in (_tiny_sd15, _four_levels):
        cj, ct = lib_cfg(junet), lib_cfg(tunet)
        for ch in (16, 24, 32):
            assert ct.heads_for(ch) == cj.heads_for(ch)
    sd15 = tunet.UNetConfig.sd15()
    assert [sd15.heads_for(c) for c in sd15.block_out_channels] == [(8, 40), (8, 80), (8, 160),
                                                                    (8, 160)]
    assert tunet.UNetConfig.sdxl().heads_for(640) == junet.UNetConfig.sdxl().heads_for(640) == (
        10, 64)
    assert sd15.mid_depth == 1 and tunet.UNetConfig.sdxl().mid_depth == 10
    unet = tunet.SDXLUNet(dataclasses.replace(_four_levels(tunet, lora_rank=2),
                                              fixed_num_heads=8), device="cpu")
    shard_unet_tp(unet, 0, 2, None)
    attn = [m for m in unet.modules() if m.__class__.__name__ == "Attention"]
    assert attn and all(m.heads == 4 for m in attn)
    assert {m.head_dim for m in attn} == {2, 3, 4}


def test_sd15_parameter_count_and_names_match_jax():
    """``UNetConfig.sd15()`` on the meta device holds exactly JAX's
    ``eval_shape`` parameters: the same count (~860 M), and
    ``unet_param_map(n_levels=4)`` names every JAX leaf as a port tensor of
    the same number of elements (no ``add_embedding``)."""
    model = junet.SDXLUNet(junet.UNetConfig.sd15())
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, 768)))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    n_jax = sum(int(np.prod(a.shape)) for _, a in leaves)
    port = tunet.SDXLUNet(tunet.UNetConfig.sd15(), device="meta")
    sd = port.state_dict()
    assert sum(p.numel() for p in port.parameters()) == n_jax
    assert 0.75e9 < n_jax < 1.0e9
    names = {}
    for path, a in leaves:
        key, _ = unet_param_map(tuple(k.key for k in path), n_levels=4)
        assert key == j_unet_param_map(tuple(k.key for k in path), n_levels=4)[0]
        names[key] = int(np.prod(a.shape))
    assert names == {k: v.numel() for k, v in sd.items()}
    assert not any(k.startswith("add_embedding") for k in sd)
    assert {k.split(".")[1] for k in sd if k.startswith("up_blocks")} == {"0", "1", "2", "3"}


def test_text_time_inputs_are_required_exactly_where_used():
    sd15 = tunet.SDXLUNet(_tiny_sd15(tunet), device="cpu")
    x, t, ctx = torch.zeros((1, 4, 8, 8)), torch.zeros((1,)), torch.zeros((1, 5, 16))
    with pytest.raises(ValueError, match="no text_time"):
        sd15(x, t, ctx, torch.zeros((1, 16)), torch.zeros((1, 6)))
    sdxl = tunet.SDXLUNet(tunet.UNetConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="needs pooled_text_embeds"):
        sdxl(x, t, torch.zeros((1, 5, 32)))


def test_ddim_step_matches_jax_over_its_options():
    """prediction_type x clip_sample x eta in {0, 1} x a negative
    prev_timestep (with and without final_alpha_cumprod), each with the
    noise given (drawn in JAX from the key the JAX step draws from) and with
    prev_sample given."""
    ac = jsch.make_alphas_cumprod()
    np.testing.assert_array_equal(ac, tsch.make_alphas_cumprod())
    r = np.random.default_rng(4)
    x, out, stored = (r.standard_normal((B, 4, 4, 3)).astype(np.float32) for _ in range(3))
    cases = 0
    for pred in ("epsilon", "sample", "v_prediction"):
        for clip in (False, True):
            for eta in (0.0, 1.0):
                for tp, fac in (((749, 249), None), ((-1, 249), None), ((-1, -1), 0.5)):
                    t, tp = np.array([999, 499], np.int32), np.array(tp, np.int32)
                    kw = dict(eta=eta, prediction_type=pred, clip_sample=clip,
                              final_alpha_cumprod=fac)
                    key = jax.random.key(cases)
                    jx, jlp = jddim.ddim_step_with_logprob(ac, out, t, tp, x, key=key, **kw)
                    noise = jax.random.normal(key, x.shape, dtype=jnp.float32)
                    tx, tlp = ddim_step_with_logprob(
                        ac, torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(tp),
                        torch.from_numpy(x), noise=torch.from_numpy(np.asarray(noise)), **kw)
                    _close(tx, jx)
                    _close(tlp, jlp)
                    _, jlp = jddim.ddim_step_with_logprob(ac, out, t, tp, x, prev_sample=stored,
                                                          **kw)
                    _, tlp = ddim_step_with_logprob(
                        ac, torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(tp),
                        torch.from_numpy(x), prev_sample=torch.from_numpy(stored), **kw)
                    _close(tlp, jlp)
                    cases += 1
    assert cases == 36
    with pytest.raises(ValueError, match="exactly one"):
        ddim_step_with_logprob(ac, torch.zeros(1, 2), torch.ones(1, dtype=torch.long),
                               torch.zeros(1, dtype=torch.long), torch.zeros(1, 2))
    with pytest.raises(ValueError, match="prediction_type"):
        ddim_step_with_logprob(ac, torch.zeros(1, 2), torch.ones(1, dtype=torch.long),
                               torch.zeros(1, dtype=torch.long), torch.zeros(1, 2),
                               noise=torch.zeros(1, 2), prediction_type="x0")


def _golden_turbo():
    jsched, tsched = jsch.make_euler_ancestral_schedule(4), tsch.make_euler_ancestral_schedule(4)
    x = FIX["x"] * np.float32(tsched.init_noise_sigma)
    noise = jax.random.normal(jax.random.key(7), x.shape, dtype=jnp.float32)
    assert np.asarray(jsched.init_noise_sigma) == tsched.init_noise_sigma
    return tea.turbo_step_with_logprob(
        tsched, torch.from_numpy(FIX["eps"]), torch.tensor([0, 2]), torch.from_numpy(x),
        torch.from_numpy(np.asarray(noise))), "turbo"


def _golden_distilled():
    noise = jax.random.normal(jax.random.key(9), (1,) + FIX["x"].shape[1:], dtype=jnp.float32)
    return tdr.distilled_step_with_logprob(
        tsch.make_alphas_cumprod(), torch.from_numpy(FIX["eps"]), torch.tensor([999, 499]),
        torch.tensor([749, 249]), torch.from_numpy(FIX["x"]),
        torch.from_numpy(np.asarray(noise))), "dist"


def _golden_ddim():
    noise = jax.random.normal(jax.random.key(11), FIX["x"].shape, dtype=jnp.float32)
    return ddim_step_with_logprob(
        tsch.make_alphas_cumprod(), torch.from_numpy(FIX["eps"]), torch.tensor([999, 499]),
        torch.tensor([749, 249]), torch.from_numpy(FIX["x"]),
        noise=torch.from_numpy(np.asarray(noise)), eta=1.0), "ddim"


@pytest.mark.parametrize("step", [_golden_turbo, _golden_distilled, _golden_ddim],
                         ids=["turbo", "distilled", "ddim"])
def test_scheduler_steps_match_the_goldens(step):
    """The port's steps against the frozen fixture, each step's noise drawn
    as the JAX step draws it from the golden test's key; that test's
    tolerances (``tests/test_scheduler_goldens.py``)."""
    (xp, lp), prefix = step()
    np.testing.assert_allclose(xp.numpy(), FIX[f"{prefix}_xprev"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lp.numpy(), FIX[f"{prefix}_logprob"], rtol=2e-5)


def test_ddim_cfg_rollout_matches_jax(lora_pair):
    """3 CFG-DDIM steps (guidance 7.5, one UNet call at twice the batch a
    step) on the tiny SD1.x UNet; the noise drawn from the JAX sampler's own
    ``jax.random.split(key, S)``: latents and log-probs as JAX's, and each
    log-prob recomputed from the stored transition."""
    apply, variables, port, (x0, _, ctx) = lora_pair
    ac, ts, g = jsch.make_alphas_cumprod(), np.array([801, 401, 1], np.int32), 7.5
    uncond = np.zeros_like(ctx)

    def eps_j(x, t):
        both = apply(variables, jnp.concatenate([x, x]), jnp.tile(t, 2),
                     jnp.concatenate([jnp.asarray(uncond), jnp.asarray(ctx)]))
        u, c = jnp.split(both, 2)
        return u + g * (c - u)

    ctx_t = torch.from_numpy(np.concatenate([uncond, ctx]))

    def eps_t(x, t):
        with torch.no_grad():
            u, c = port(torch.cat([x, x]), torch.cat([t, t]), ctx_t).chunk(2)
        return u + g * (c - u)

    key = jax.random.key(5)
    want = jsampling.sample_ddim_cfg_trajectories(eps_j, ac, jnp.asarray(ts), jnp.asarray(x0),
                                                  key)
    noise = np.stack([np.asarray(jax.random.normal(k, x0.shape, dtype=jnp.float32))
                      for k in jax.random.split(key, len(ts))]).transpose(0, 1, 4, 2, 3)
    got = sample_ddim_cfg_trajectories(eps_t, tsch.make_alphas_cumprod(), ts, _nchw(x0),
                                       torch.from_numpy(np.ascontiguousarray(noise)))
    assert got.latents.shape == (len(ts) + 1, B, 4, 8, 8) and got.log_probs.shape == (len(ts), B)
    _close(got.latents.permute(0, 1, 3, 4, 2), want.latents)
    _close(got.log_probs, want.log_probs)
    _close(got.final_latents.permute(0, 2, 3, 1), want.final_latents)
    prev = [int(t) for t in ts[1:]] + [-1]
    for j, t in enumerate(ts):
        tt = torch.full((B,), int(t))
        _, lp = ddim_step_with_logprob(ac, eps_t(got.latents[j], tt), tt, torch.full((B,), prev[j]),
                                       got.latents[j], prev_sample=got.latents[j + 1])
        _close(lp, got.log_probs[j].numpy(), atol=1e-4, rtol=1e-4)


@pytest.fixture
def interpret():
    jfa.set_interpret(True)
    yield
    jfa.set_interpret(False)


def _jax_vjp(fn, primals, cotangent):
    """(fn's output, its cotangents for ``cotangent``) at ``primals``, traced
    and compiled as one jitted call (eagerly, the Pallas kernels' interpret
    mode dispatches op by op)."""
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    return jax.jit(run)(tuple(map(jnp.asarray, primals)), jnp.asarray(cotangent))


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("skv", ["full", 77])
def test_attention_plain_versions_match_the_pallas_kernels(interpret, d, skv):
    """The forward's and the backward's plain versions (what CPU tensors
    take, and what the card's kernels are held against) at the SD1.5 head
    dims, self-attention and 77-key cross-attention, against the JAX Pallas
    forward and its two backward kernels (``jax.vjp`` of the custom VJP)."""
    sq = 128
    skv = sq if skv == "full" else skv
    r = np.random.default_rng(d + skv)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((1, sq, 2, d), (1, skv, 2, d), (1, skv, 2, d)))
    do = r.standard_normal((1, sq, 2, d)).astype(np.float32)
    o_j, grads_j = _jax_vjp(jfa.flash_attention, (q, k, v), do)
    o_t, lse_t = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    _close(o_t, o_j)
    lse_x = jax.nn.logsumexp(jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d), axis=-1)
    _close(lse_t, lse_x)
    grads_t = tfa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), o_t, lse_t,
                                      torch.from_numpy(do))
    for got, want in zip(grads_t, grads_j):
        _close(got, want)


def test_lora_gradient_matches_jax_grad(lora_pair):
    """The plain autograd gradient of the tiny SD1.x LoRA UNet (through the
    attention's plain backward) against ``jax.grad`` over the LoRA
    collection, tensor by tensor."""
    _, variables, port, (x, t, ctx) = lora_pair
    model = junet.SDXLUNet(_tiny_sd15(junet, lora_rank=4))
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(lora):
        out = model.apply({"params": variables["params"], "lora": lora},
                          *map(jnp.asarray, (x, t, ctx)))
        return jnp.sum(out * g)

    want = state_dict_from_jax({}, "unet", n_levels=2,
                               lora=jax.jit(jax.grad(loss))(variables["lora"]))
    named = dict(port.named_parameters())
    lora = [n for n in named if ".lora." in n]
    out = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    got = torch.autograd.grad((out * _nchw(g)).sum(), [named[n] for n in lora])
    assert set(lora) == set(want)
    for n, gr in zip(lora, got):
        assert gr.abs().max() > 0, n
        _close(gr, want[n].numpy())


def test_new_head_dims_route_to_the_two_kernel_backward(monkeypatch):
    """On a non-CPU tensor the backward at head dims 40, 80 and 160 launches
    the pre kernel, then in bf16 the one-kernel backward of the
    ``flash_attn_bwd`` library (and its post kernel where ``bwd_plan``
    gives an accumulator: at 160, kv 77 is more than a block's 64 keys) and
    in fp32 the two-kernel path of ``flash_attn_bwd_fma`` (no accumulator,
    no post kernel), counted by head dim; head dim 48 raises before any
    launch (meta tensors stand in for CUDA ones). The test keeps the name it
    had while bf16 took the two-kernel path too."""
    for name, sigs in (("flash_attn_bwd_fma", tfa._BWD_FMA_SIGNATURES),
                       ("flash_attn_bwd", tfa._BWD_SIGNATURES)):
        src = (kernel_lib.CSRC / kernel_lib.SOURCES[name]).read_text()
        entry = src[src.index('extern "C" {'):]
        params = entry[entry.index("int flash_attn_bwd("):]
        assert params[:params.index(")")].count(",") + 1 == len(sigs["flash_attn_bwd"])
    fma = (kernel_lib.CSRC / kernel_lib.SOURCES["flash_attn_bwd_fma"]).read_text()
    assert "bfloat16" not in fma and "dtype == 1" in fma  # fp32 instances only
    calls, libs = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append(name) or 0

    monkeypatch.setattr(kernel_lib, "load", lambda name, sigs: libs.append(name) or Lib())
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(tfa, "_sm_count", lambda index: 132)  # an H100's
    q = torch.empty((2, 64, 2, 48), device="meta")
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.flash_attention_fwd(q, q, q)
    monkeypatch.setattr(tfa, "_check", lambda *a: None)  # the device checks: meta tensors
    kernel_lib.reset_launch_counts()
    want_calls, want_libs = [], []
    for d in (40, 80, 160):
        for dt in (torch.bfloat16, torch.float32):
            q = torch.empty((2, 64, 2, d), device="meta", dtype=dt)
            k = torch.empty((2, 77, 2, d), device="meta", dtype=dt)
            lse = torch.empty((2, 2, 64), device="meta")
            tfa.flash_attention_fwd(q, k, k)
            tfa.flash_attention_bwd(q, k, k, torch.empty_like(q), lse, torch.empty_like(q))
            post = dt == torch.bfloat16 and d == 160
            want_calls += ["flash_attn_fwd", "flash_attn_bwd_pre", "flash_attn_bwd"]
            want_calls += ["flash_attn_bwd_post"] * post
            main = "flash_attn_bwd" if dt == torch.bfloat16 else "flash_attn_bwd_fma"
            want_libs += ["flash_attn_fwd", "flash_attn_bwd", main] + ["flash_attn_bwd"] * post
    assert calls == want_calls
    assert libs == want_libs
    assert kernel_lib.head_dim_launches == {(n, d): 2 for n in ("flash_attn_fwd",
                                                               "flash_attn_bwd")
                                            for d in (40, 80, 160)}
    assert kernel_lib.launch_counts["flash_attn_bwd_post"] == 1
    kernel_lib.reset_launch_counts()
    assert not kernel_lib.head_dim_launches
