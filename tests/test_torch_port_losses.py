"""The port's PSO losses, comparators, optimizer and LR schedules vs the
JAX package (``train/losses.py``, ``train/train_state.py``), fp32 on the
CPU. Inputs are made with numpy from a seed and handed to both; random
draws the JAX side makes from a key are handed to the port explicitly.
Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pairwise_sample_optimization_tpu.train import losses as jl
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.train import losses as tl
from pairwise_sample_optimization_tpu_torch.train import train_state as tts

ATOL, RTOL = 3e-5, 2e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("clamp_mode", ["ratio", "logratio", "none"])
def test_pso_pairwise_loss_and_grads_match_jax(clamp_mode):
    r = np.random.default_rng(0)
    lp = [r.standard_normal(8).astype(np.float32) * 0.1 for _ in range(4)]
    prefer = np.array([[-1, 1], [1, -1]] * 4, np.float32)
    args = dict(beta=50.0, eps=0.1, clamp_mode=clamp_mode)
    loss_j, g_j = jax.value_and_grad(
        lambda a, b: jl.pso_pairwise_loss(a, lp[1], b, lp[3], jnp.asarray(prefer), **args),
        argnums=(0, 1))(jnp.asarray(lp[0]), jnp.asarray(lp[2]))
    a, b = _t(lp[0]).requires_grad_(), _t(lp[2]).requires_grad_()
    loss_t = tl.pso_pairwise_loss(a, _t(lp[1]), b, _t(lp[3]), _t(prefer), **args)
    _close(loss_t, loss_j)
    for got, want in zip(torch.autograd.grad(loss_t, (a, b)), g_j):
        _close(got, want)


def test_pso_loss_is_log2_when_policy_equals_reference():
    lp = torch.randn(6)
    prefer = torch.tensor([[-1.0, 1.0]] * 6)
    for mode in ("ratio", "logratio", "none"):
        loss = tl.pso_pairwise_loss(lp, lp, lp, lp, prefer, 50.0, 0.1, clamp_mode=mode)
        assert abs(loss.item() - np.log(2.0)) < 1e-7


def test_pso_loss_rejects_unknown_clamp_mode():
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="clamp_mode"):
        tl.pso_pairwise_loss(z, z, z, z, torch.ones(2, 2), 1.0, 0.1, clamp_mode="bogus")


@pytest.mark.parametrize("m", [1, 3])
def test_sample_compare_matches_jax_including_ties(m):
    r = np.random.default_rng(m)
    ra = r.integers(0, 3, (16, m)).astype(np.float32)  # small integers: many ties
    rb = r.integers(0, 3, (16, m)).astype(np.float32)
    key = jax.random.key(7)
    want = jl.sample_compare(jnp.asarray(ra), jnp.asarray(rb), key)
    axis = np.array(jax.random.randint(key, (16,), 0, m))  # the draw the JAX side makes
    got = tl.sample_compare(_t(ra), _t(rb), axis=torch.from_numpy(axis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tie = ra[np.arange(16), axis] == rb[np.arange(16), axis]
    assert tie.any() and (got.numpy()[tie] == [-1.0, 1.0]).all()  # ties go to trajectory 1


def test_sample_compare_draws_its_axis_from_the_generator():
    ra, rb = torch.zeros(32, 4), torch.ones(32, 4)
    ra[:, 2] = 2.0  # on axis 2 trajectory 0 wins, elsewhere trajectory 1
    got = tl.sample_compare(ra, rb, torch.Generator().manual_seed(0))
    again = tl.sample_compare(ra, rb, torch.Generator().manual_seed(0))
    assert torch.equal(got, again)
    assert {tuple(r) for r in got.tolist()} == {(1.0, -1.0), (-1.0, 1.0)}


@pytest.mark.parametrize("m", [1, 2])
def test_pareto_compare_matches_jax_including_ties(m):
    r = np.random.default_rng(10 + m)
    ra = r.integers(0, 2, (32, m)).astype(np.float32)
    rb = r.integers(0, 2, (32, m)).astype(np.float32)
    want = jl.pareto_compare(jnp.asarray(ra), jnp.asarray(rb))
    got = tl.pareto_compare(_t(ra), _t(rb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).all(axis=1).any()  # a non-dominated pair gives a zero row


@pytest.mark.parametrize("scale,clipped", [(1e-3, False), (10.0, True)],
                         ids=["below_max_norm", "above_max_norm"])
def test_clip_and_adamw_step_match_make_optimizer(scale, clipped):
    r = np.random.default_rng(1)
    params = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (r.standard_normal(v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    norm = np.sqrt(sum((g ** 2).sum() for g in grads[0].values()))
    assert (norm >= 1.0) == clipped
    hp = dict(learning_rate=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-2,
              max_grad_norm=1.0)
    tx = jts.make_optimizer(**hp)
    state_j = jts.PSOTrainState.create(jax.tree.map(jnp.asarray, params), tx)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    state_t = tts.PSOTrainState.create(tparams, tts.make_optimizer(tparams, **hp))
    for g in grads:  # three steps: bias correction and moments past the first step
        state_j = state_j.apply_gradients(jax.tree.map(jnp.asarray, g), tx)
        state_t.apply_gradients({k: _t(v) for k, v in g.items()})
    assert state_t.step == int(state_j.step) == 3
    for k in params:
        _close(state_t.lora[k], state_j.lora[k], atol=1e-6, rtol=1e-5)


def test_global_norm_matches_optax():
    r = np.random.default_rng(2)
    tree = {"a": r.standard_normal((7, 3)).astype(np.float32), "b": r.standard_normal(11)}
    want = optax.global_norm(jax.tree.map(jnp.asarray, tree))
    _close(tts.global_norm([_t(v) for v in tree.values()]), want)


def test_unported_optimizer_knobs_raise():
    p = {"a": torch.nn.Parameter(torch.zeros(2))}
    with pytest.raises(NotImplementedError, match="8-bit"):
        tts.make_optimizer(p, use_8bit=True)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tts.make_optimizer(p, state_dtype="bfloat16")


@pytest.mark.parametrize("name", tts.LR_SCHEDULES)
def test_lr_schedules_match_jax(name):
    kw = dict(learning_rate=3e-4, warmup_steps=5, total_steps=40, power=2.0, lr_end=1e-6)
    sched_j = jts.make_lr_schedule(name, **kw)
    factor = tts.make_lr_schedule(name, **kw)
    for step in (0, 1, 3, 5, 6, 17, 39, 40, 55):
        _close(kw["learning_rate"] * factor(step), sched_j(step), atol=1e-10, rtol=1e-5)


def test_lr_schedule_drives_the_optimizer_as_lambda_lr():
    p = {"a": torch.nn.Parameter(torch.zeros(3))}
    factor = tts.make_lr_schedule("linear", 1e-2, warmup_steps=2, total_steps=6)
    opt = tts.make_optimizer(p, learning_rate=1e-2, schedule=factor)
    seen = []
    for _ in range(4):
        seen.append(opt.adamw.param_groups[0]["lr"])
        opt.step(p, {"a": torch.ones(3)})
    _close(np.array(seen), 1e-2 * np.array([factor(s) for s in range(4)]), atol=1e-12)
