"""Gradients of the port's kernel-bearing ops vs the JAX package, fp32 on
the CPU: the flash-attention autograd Function (its plain forward and
``flash_attention_bwd_plain`` on CPU tensors) against ``jax.vjp`` of the
Pallas flash attention in interpret mode, the plain backward against torch
autograd of the plain forward, and the GroupNorm+SiLU Function against
``jax.vjp`` of the Pallas ``fused_groupnorm_silu``. Inputs are made with
numpy from a seed and handed to both. Tolerance: ATOL 3e-5 / RTOL 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.ops import flash_attention as jfa
from pairwise_sample_optimization_tpu.ops import fused_groupnorm as jfg
from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa
from pairwise_sample_optimization_tpu_torch.ops import fused_groupnorm as tfg
from pairwise_sample_optimization_tpu_torch.ops.group_norm import group_norm_plain

ATOL, RTOL = 3e-5, 2e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
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


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _attention_inputs(seed, b, sq, skv, h, d):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d), (b, sq, h, d))]


@pytest.mark.parametrize("skv", [77, 128], ids=["kv77_masked", "kv_eq_sq"])
def test_attention_function_grads_match_jax_vjp(interpret, skv):
    q, k, v, do = _attention_inputs(skv, 2, 128, skv, 2, 64)
    o_j, vjp = jax.vjp(jfa.flash_attention, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_t = tfa.flash_attention(tq, tk, tv)
    _close(o_t, o_j)
    for got, w in zip(torch.autograd.grad(o_t, (tq, tk, tv), torch.from_numpy(do)), want):
        _close(got, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_matches_autograd_of_plain_forward(dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _attention_inputs(5, 2, 40, 77, 3, 64))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = tfa.flash_attention_plain(q, k, v)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                                        lse.detach(), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        if dtype == torch.float32:
            _close(g, w)
        else:  # both round once from fp32 to bf16; allow one bf16 ulp
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), atol=1e-2,
                                       rtol=8e-3)


def test_attention_function_saves_lse_without_a_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in _attention_inputs(6, 1, 16, 16, 2, 64))
    q.requires_grad_()
    o, lse = tfa.FlashAttentionFunction.apply(q, k, v, 0.125)
    assert not lse.requires_grad and o.requires_grad
    (g,) = torch.autograd.grad(o, (q,), do)
    want = tfa.flash_attention_bwd_plain(q.detach(), k, v, o.detach(), lse, do, 0.125)[0]
    _close(g, want)


@pytest.mark.parametrize("b,h,w,c,groups", [(2, 8, 8, 64, 8), (1, 4, 4, 128, 32)])
def test_gn_silu_function_grads_match_jax_vjp(interpret, b, h, w, c, groups):
    r = np.random.default_rng(c + groups)
    x = (r.standard_normal((b, h, w, c)) * 2 + 0.5).astype(np.float32)
    scale = (r.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (r.standard_normal(c) * 0.1).astype(np.float32)
    gy = r.standard_normal((b, h, w, c)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x_, s_, b_: jfg.fused_groupnorm_silu(x_, s_, b_, groups),
                       *map(jnp.asarray, (x, scale, bias)))
    want = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y_t = tfg.fused_groupnorm_silu(xt, st, bt, groups)
    _close(y_t.permute(0, 2, 3, 1), y_j)
    gx, gs, gb = torch.autograd.grad(y_t, (xt, st, bt),
                                     torch.from_numpy(gy.transpose(0, 3, 1, 2).copy()))
    _close(gx.permute(0, 2, 3, 1), want[0])
    _close(gs, want[1])
    _close(gb, want[2])


def test_gn_silu_function_grads_only_what_is_asked():
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 16, 4, 4)).astype(np.float32)).requires_grad_()
    w, b = torch.ones(16), torch.zeros(16)  # frozen affine
    y = tfg.FusedGroupNormSiLU.apply(x, w, b, 4, 1e-5)
    gy = torch.ones_like(y)
    (gx,) = torch.autograd.grad(y, (x,), gy)
    xr = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(group_norm_plain(xr, w, b, 4, act="silu"), (xr,), gy)
    _close(gx, want)
