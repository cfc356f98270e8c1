"""Port ops vs the JAX package, on the CPU: schedules, the Euler-ancestral
step and log-prob, and the plain versions of the two kernel-bearing ops
(flash attention, GroupNorm+SiLU) against the Pallas kernels in interpret
mode. Inputs are made with numpy from a seed and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.ops import euler_ancestral as jea
from pairwise_sample_optimization_tpu.ops import flash_attention as jfa
from pairwise_sample_optimization_tpu.ops import fused_groupnorm as jfg
from pairwise_sample_optimization_tpu.ops import schedules as jsch
from pairwise_sample_optimization_tpu_torch.ops import euler_ancestral as tea
from pairwise_sample_optimization_tpu_torch.ops import schedules as tsch
from pairwise_sample_optimization_tpu_torch.ops.attention import dot_product_attention
from pairwise_sample_optimization_tpu_torch.ops.flash_attention import (
    flash_attention_fwd,
    flash_attention_plain,
)
from pairwise_sample_optimization_tpu_torch.ops.fused_groupnorm import fused_groupnorm_silu
from pairwise_sample_optimization_tpu_torch.ops.group_norm import group_norm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret():
    jfa.set_interpret(True)
    jfg.set_interpret(True)
    yield
    jfa.set_interpret(False)
    jfg.set_interpret(False)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_euler_ancestral_schedule_exact(steps):
    a = jsch.make_euler_ancestral_schedule(steps)
    b = tsch.make_euler_ancestral_schedule(steps)
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), getattr(b, name))


def test_turbo_timesteps_and_tables_exact():
    assert tsch.make_euler_ancestral_schedule(4).timesteps.tolist() == [999, 749, 499, 249]
    np.testing.assert_array_equal(jsch.make_alphas_cumprod(), tsch.make_alphas_cumprod())
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(jsch.distill_timesteps(n), tsch.distill_timesteps(n))


def test_turbo_step_and_logprob_match_jax():
    sched_j = jsch.make_euler_ancestral_schedule(4)
    sched_t = tsch.make_euler_ancestral_schedule(4)
    r = _rng(0)
    b, shape = 3, (3, 8, 8, 4)
    x = r.standard_normal(shape).astype(np.float32) * 5
    eps = r.standard_normal(shape).astype(np.float32)
    idx = np.array([0, 1, 2], np.int32)
    key = jax.random.key(5)
    x_prev_j, lp_j = jea.turbo_step_with_logprob(sched_j, jnp.asarray(eps), jnp.asarray(idx),
                                                 jnp.asarray(x), key)
    # the same draw the JAX step makes internally, handed to the port
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    x_prev_t, lp_t = tea.turbo_step_with_logprob(
        sched_t, torch.from_numpy(eps), torch.from_numpy(idx).long(), torch.from_numpy(x),
        torch.from_numpy(noise))
    np.testing.assert_allclose(x_prev_t.numpy(), np.asarray(x_prev_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-6, rtol=0)
    # recompute path on the stored transition
    rec_j = jea.turbo_logprob(sched_j, jnp.asarray(eps), jnp.asarray(idx), jnp.asarray(x),
                              x_prev_j)
    rec_t = tea.turbo_logprob(sched_t, torch.from_numpy(eps), torch.from_numpy(idx).long(),
                              torch.from_numpy(x), x_prev_t)
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rec_t.numpy(), lp_t.numpy(), atol=1e-6, rtol=0)
    xin_j = jea.scale_model_input(sched_j, jnp.asarray(x), jnp.asarray(idx))
    xin_t = tea.scale_model_input(sched_t, torch.from_numpy(x), torch.from_numpy(idx).long())
    np.testing.assert_allclose(xin_t.numpy(), np.asarray(xin_j), atol=1e-6, rtol=1e-6)


def test_turbo_logprob_gradient_flows_through_mean_only():
    sched = tsch.make_euler_ancestral_schedule(4)
    r = _rng(1)
    x = torch.from_numpy(r.standard_normal((2, 4, 4, 4)).astype(np.float32))
    eps = torch.from_numpy(r.standard_normal((2, 4, 4, 4)).astype(np.float32)).requires_grad_()
    x_prev = torch.from_numpy(r.standard_normal((2, 4, 4, 4)).astype(np.float32)).requires_grad_()
    lp = tea.turbo_logprob(sched, eps, torch.tensor([0, 1]), x, x_prev)
    lp.sum().backward()
    assert eps.grad is not None and eps.grad.abs().sum() > 0
    assert x_prev.grad is None


@pytest.mark.parametrize(
    "b,sq,skv,h,d",
    [
        (2, 128, 128, 2, 64),  # self-attention
        (2, 128, 77, 2, 64),  # cross-attention, kv not a multiple of 128
        (1, 257, 257, 2, 80),  # ViT-H/14: 257 tokens, d = 80
        (1, 256, 256, 1, 512),  # VAE mid-block: one head, d = 512
    ],
)
def test_attention_plain_matches_jax_flash(interpret, b, sq, skv, h, d):
    r = _rng(sq + skv + d)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d)))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = dot_product_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    # the LSE the backward will need, against the JAX kernel's residual
    o_j, lse_j = jfa._fwd(
        *(jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], d)
          for a in (np.pad(q, ((0, 0), (0, (-sq) % 128), (0, 0), (0, 0))),
                    np.pad(k, ((0, 0), (0, (-skv) % 128), (0, 0), (0, 0))),
                    np.pad(v, ((0, 0), (0, (-skv) % 128), (0, 0), (0, 0))))),
        1.0 / np.sqrt(d), skv)
    o_t, lse_t = flash_attention_fwd(tq, tk, tv)
    assert lse_t.shape == (b, h, sq) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.reshape(b * h, sq).numpy(),
                               np.asarray(lse_j)[:, 0, :sq], atol=2e-3, rtol=2e-3)


def test_causal_attention_masks_the_future():
    r = _rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 6, 2, 8)).astype(np.float32))
               for _ in range(3))
    full = dot_product_attention(q, k, v, causal=True)
    cut = dot_product_attention(q[:, :3], k[:, :3], v[:, :3], causal=True)
    np.testing.assert_allclose(full[:, :3].numpy(), cut.numpy(), atol=1e-6)


@pytest.mark.parametrize("b,h,w,c,groups", [(2, 8, 8, 128, 32), (2, 8, 8, 64, 8)])
def test_gn_silu_plain_matches_jax_fused(interpret, b, h, w, c, groups):
    r = _rng(c + groups)
    x = (r.standard_normal((b, h, w, c)) * 2 + 0.5).astype(np.float32)
    scale = (r.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (r.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(jfg.fused_groupnorm_silu(jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(bias), groups))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for got in (fused_groupnorm_silu(xt, torch.from_numpy(scale), torch.from_numpy(bias), groups),
                group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), groups,
                           act="silu")):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=2e-4, rtol=2e-4)


def test_gn_plain_bf16_uses_clamped_one_pass_stats():
    from pairwise_sample_optimization_tpu.ops.group_norm import group_norm as jgn

    r = _rng(9)
    x = (r.standard_normal((2, 4, 4, 32)) * 3 + 1).astype(np.float32)
    want = np.asarray(jgn(jnp.asarray(x, jnp.bfloat16), jnp.ones(32), jnp.zeros(32), 8,
                          act="silu").astype(jnp.float32))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
    got = group_norm(xt, torch.ones(32), torch.zeros(32), 8, act="silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1), want, atol=3e-2)


def test_flash_plain_is_fp32_math_on_bf16_inputs():
    r = _rng(11)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 16, 2, 64)).astype(np.float32))
               for _ in range(3))
    o16, lse16 = flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16())
    o32, _ = flash_attention_plain(q.bfloat16().float(), k.bfloat16().float(),
                                   v.bfloat16().float())
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    np.testing.assert_allclose(o16.float().numpy(), o32.bfloat16().float().numpy(), atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,groups", [((2, 64, 8, 8), 32), ((2, 128, 64, 64), 32),
                                          ((1, 32, 16, 16), 8)])
def test_gn_stats_and_norm_plain_versions_compose_to_group_norm(dtype, tol, shape, groups):
    from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg

    r = _rng(shape[1])
    x = torch.from_numpy((r.standard_normal(shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    w = torch.from_numpy((r.standard_normal(shape[1]) * 0.1 + 1).astype(np.float32))
    b = torch.from_numpy((r.standard_normal(shape[1]) * 0.1).astype(np.float32))
    partial = tfg.group_stats_plain(x, groups)
    splits, _ = tfg._splits(shape[0] * groups, x.numel() // (shape[0] * groups))
    assert partial.shape == (shape[0] * groups, splits, 2)
    mean, var = tfg.stats_from_partial(partial, x, groups)
    xf = x.float().reshape(shape[0] * groups, -1)
    np.testing.assert_allclose(mean.numpy(), xf.mean(-1).numpy(), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), xf.var(-1, unbiased=False).numpy(), atol=1e-4,
                               rtol=1e-4)
    got = tfg.group_norm_silu_from_stats_plain(x, partial, w, b, groups, 1e-6)
    want = group_norm(x, w, b, groups, 1e-6, act="silu")
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=tol)
