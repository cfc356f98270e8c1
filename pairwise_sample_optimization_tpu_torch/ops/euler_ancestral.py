"""Euler-ancestral (VE-SDE) transition with its Gaussian log-density.

Semantics of the JAX package's ``ops/euler_ancestral.py``:
- computation in float32 whatever the input dtype;
- x0 = x - sigma * eps, mean = x + (x - x0)/sigma * (sigma_down - sigma),
  in that expanded form so float32 rounding matches;
- log-density is the mean (not sum) over non-batch dims;
- the realized transition is detached.

Torch cannot reproduce JAX's threefry draws, so the stochastic step takes
its unit-normal ``noise`` explicitly.
"""

from __future__ import annotations

import torch

from .gaussian import bcast as _bcast, gaussian_logprob_mean as _gaussian_logprob_mean
from .schedules import EulerAncestralSchedule


def _table(arr, step_index: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=torch.float32, device=step_index.device)[step_index]


def turbo_step_stats(schedule: EulerAncestralSchedule, step_index: torch.Tensor):
    """Per-sample (sigma, sigma_up, sigma_down) for a batch of step indices."""
    return (
        _table(schedule.sigmas, step_index),
        _table(schedule.sigma_up, step_index),
        _table(schedule.sigma_down, step_index),
    )


def _prev_mean(schedule, eps, step_index, x_t):
    x_t = x_t.float()
    eps = eps.float()
    sigma, sigma_up, sigma_down = turbo_step_stats(schedule, step_index)
    sigma_b = _bcast(sigma, x_t.ndim)
    pred_x0 = x_t - sigma_b * eps
    derivative = (x_t - pred_x0) / sigma_b
    mean = x_t + derivative * _bcast(sigma_down - sigma, x_t.ndim)
    return mean, sigma_up


def turbo_step_with_logprob(
    schedule: EulerAncestralSchedule,
    eps: torch.Tensor,
    step_index: torch.Tensor,
    x_t: torch.Tensor,
    noise: torch.Tensor,
):
    """Sample x_{t-1} = mean + sigma_up * noise and return its log density.

    Args:
      eps: UNet epsilon prediction, (B, ...).
      step_index: (B,) int64 indices into the schedule tables.
      x_t: current (unscaled) latents, (B, ...).
      noise: unit-normal draw shaped like ``x_t``.
    Returns: (x_prev float32, logprob (B,) float32).
    """
    mean, sigma_up = _prev_mean(schedule, eps, step_index, x_t)
    sigma_up_b = _bcast(sigma_up, mean.ndim)
    x_prev = mean + noise.float() * sigma_up_b
    logprob = _gaussian_logprob_mean(x_prev, mean, sigma_up_b)
    return x_prev.detach(), logprob


def turbo_logprob(
    schedule: EulerAncestralSchedule,
    eps: torch.Tensor,
    step_index: torch.Tensor,
    x_t: torch.Tensor,
    x_prev: torch.Tensor,
):
    """Log density of a stored transition under the current model."""
    mean, sigma_up = _prev_mean(schedule, eps, step_index, x_t)
    sigma_up_b = _bcast(sigma_up, mean.ndim)
    return _gaussian_logprob_mean(x_prev.float(), mean, sigma_up_b)


def scale_model_input(
    schedule: EulerAncestralSchedule, x_t: torch.Tensor, step_index: torch.Tensor
) -> torch.Tensor:
    """Euler input scaling x / sqrt(sigma^2 + 1)."""
    sigma = _table(schedule.sigmas, step_index)
    return x_t / _bcast(torch.sqrt(sigma**2 + 1.0), x_t.ndim)
