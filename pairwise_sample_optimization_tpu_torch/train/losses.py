"""PSO preference construction and the pairwise loss.

Counterpart of the JAX package's ``train/losses.py``:

- ``sample_compare``: per-sample random reward axis, ties go to
  trajectory 1;
- ``pareto_compare``: strict dominance, ties give a zero row (no gradient);
- ``pso_pairwise_loss``: -log sigmoid(beta * log(clamp(pi / pi_ref)) * pref),
  mean over the batch, with the three clamp modes;
- ``dreambooth_pso_loss``: the offline (DreamBooth) objective on per-sample
  denoising losses, logistic (``pso``) or hinge (``pso_db``), plus the prior
  term.

A preference row is the sign each trajectory's log-ratio carries in the
loss: [-1, +1] prefers trajectory 1, [+1, -1] trajectory 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_PREFER_1 = (-1.0, 1.0)
_PREFER_0 = (1.0, -1.0)


def _rows(cond, like):
    a = torch.tensor(_PREFER_1, dtype=torch.float32, device=like.device)
    b = torch.tensor(_PREFER_0, dtype=torch.float32, device=like.device)
    return torch.where(cond[:, None], a, b)


def sample_compare(rewards_a, rewards_b, generator: Optional[torch.Generator] = None,
                   axis=None):
    """(B, M) multi-reward pair -> (B, 2) preference of {-1, +1}.

    For each sample one of the M reward axes is drawn uniformly from
    ``generator`` (or taken from the (B,) ``axis`` tensor); the higher
    reward on that axis wins, and a tie goes to trajectory 1."""
    b, m = rewards_a.shape
    if axis is None:
        axis = torch.randint(0, m, (b,), generator=generator,
                             device=generator.device if generator is not None else "cpu")
    axis = axis.to(rewards_a.device).long()[:, None]
    ra = torch.take_along_dim(rewards_a, axis, dim=1)[:, 0]
    rb = torch.take_along_dim(rewards_b, axis, dim=1)[:, 0]
    return _rows(ra <= rb, ra)


def pareto_compare(rewards_a, rewards_b):
    """Strict Pareto dominance over M axes; non-dominated pairs -> zeros."""
    if rewards_a.ndim == 1:
        rewards_a, rewards_b = rewards_a[:, None], rewards_b[:, None]
    a_dom = (rewards_a <= rewards_b).all(1) & (rewards_a < rewards_b).any(1)
    b_dom = (rewards_b <= rewards_a).all(1) & (rewards_b < rewards_a).any(1)
    rows = _rows(a_dom, rewards_a)
    return torch.where((a_dom | b_dom)[:, None], rows, torch.zeros_like(rows))


def pso_pairwise_loss(logp_0, ref_logp_0, logp_1, ref_logp_1, prefer, beta: float, eps: float,
                      clamp_mode: str = "ratio"):
    """-log sigmoid(beta*(log r0)*pref0 + beta*(log r1)*pref1), mean over B.

    ``clamp_mode``: "ratio" clamps exp(logp - ref) to [1-eps, 1+eps] before
    the log (reference parity); "logratio" clips the log-ratio to
    [log(1-eps), log(1+eps)]; "none" leaves the DPO logits unclamped."""
    d0 = logp_0 - ref_logp_0
    d1 = logp_1 - ref_logp_1
    if clamp_mode == "ratio":
        d0 = torch.log(torch.clamp(torch.exp(d0), 1.0 - eps, 1.0 + eps))
        d1 = torch.log(torch.clamp(torch.exp(d1), 1.0 - eps, 1.0 + eps))
    elif clamp_mode == "logratio":
        lo, hi = math.log1p(-eps), math.log1p(eps)
        d0 = torch.clamp(d0, lo, hi)
        d1 = torch.clamp(d1, lo, hi)
    elif clamp_mode != "none":
        raise ValueError(f"unknown clamp_mode {clamp_mode}")
    inner = beta * d0 * prefer[:, 0] + beta * d1 * prefer[:, 1]
    return -F.logsigmoid(inner).mean()


def dreambooth_pso_loss(model_losses_w, model_losses_l, ref_losses_w, ref_losses_l,
                        beta: float, loss_type: str = "pso", neg_defactor: float = 1.0,
                        prior_loss_weight: float = 0.0):
    """(B,) denoising losses of the winners (instance images) and losers
    (self-generated), the policy's and (for ``pso``) the frozen reference's
    -> (loss, logits); ``logits > 0`` is the implicit-preference accuracy.

    ``pso``: -log sigmoid(beta (ref_diff - model_diff)); ``pso_db``:
    relu(1 - beta (-model_diff)), where diff = loss_w - neg_defactor loss_l.
    A ``prior_loss_weight`` > 0 adds that weight times mean(model_losses_l)."""
    model_diff = model_losses_w - neg_defactor * model_losses_l
    if loss_type == "pso":
        if ref_losses_w is None or ref_losses_l is None:
            raise ValueError("loss_type 'pso' needs reference losses")
        logits = (ref_losses_w - neg_defactor * ref_losses_l) - model_diff
        loss = -F.logsigmoid(beta * logits).mean()
    elif loss_type == "pso_db":
        logits = -model_diff
        loss = F.relu(1.0 - beta * logits).mean()
    else:
        raise ValueError(f"unknown loss_type {loss_type}")
    if prior_loss_weight > 0.0:
        loss = loss + prior_loss_weight * model_losses_l.mean()
    return loss, logits
