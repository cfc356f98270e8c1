"""DDPM re-noise transition for distilled (DMD2-style) samplers.

Semantics of the JAX package's ``ops/ddpm_renoise.py``: the distilled
model jumps to x0, and the transition to the next lattice timestep is the
DDPM forward process around sqrt(abar_prev) * x0 with std
sqrt(1 - abar_prev). Computed in float32 whatever the input dtype; the
log-density is the mean (not sum) over non-batch dims; the realized
transition is detached.

The reference draws the transition noise with shape (1, C, H, W), one
sample shared by the batch. ``shared_noise=True`` reproduces that when the
step draws its own noise; ``noise`` given explicitly overrides the draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from .gaussian import bcast as _bcast, gaussian_logprob_mean as _gaussian_logprob_mean


def _take(alphas_cumprod, timestep: torch.Tensor) -> torch.Tensor:
    """alphas_cumprod[timestep] as fp32 on the timesteps' device. The table
    is host numpy (``ops.schedules.make_alphas_cumprod``) or a tensor."""
    table = torch.as_tensor(alphas_cumprod, dtype=torch.float32, device=timestep.device)
    return table[timestep.long()]


def x0_from_eps(sample, eps, alphas_cumprod, timestep):
    """x0 = (x_t - sqrt(1 - abar_t) eps) / sqrt(abar_t)."""
    a = _bcast(_take(alphas_cumprod, timestep), sample.ndim)
    return (sample - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)


def _prev_mean_std(alphas_cumprod, eps, timestep, prev_timestep, x_t):
    x_t = x_t.float()
    eps = eps.float()
    pred_x0 = x0_from_eps(x_t, eps, alphas_cumprod, timestep)
    a_prev = _take(alphas_cumprod, prev_timestep)
    mean = _bcast(torch.sqrt(a_prev), x_t.ndim) * pred_x0
    return mean, torch.sqrt(1.0 - a_prev)  # std (B,)


def distilled_step_with_logprob(alphas_cumprod, eps, timestep, prev_timestep, x_t,
                                noise: Optional[torch.Tensor] = None,
                                shared_noise: bool = True,
                                generator: Optional[torch.Generator] = None):
    """Re-noise to ``prev_timestep``: x_prev ~ N(sqrt(abar_prev) x0, 1 - abar_prev).

    Args:
      timestep / prev_timestep: (B,) int lattice timesteps.
      noise: unit-normal transition noise broadcastable to x_t's shape
        ((B, h, w, C), or (1, h, w, C) shared by the batch); drawn from
        ``generator`` when None: one (1, h, w, C) sample broadcast over the
        batch if ``shared_noise``, else one per sample.
    Returns: (x_prev float32, logprob (B,) float32).
    """
    mean, std = _prev_mean_std(alphas_cumprod, eps, timestep, prev_timestep, x_t)
    if noise is None:
        shape = (1,) + tuple(mean.shape[1:]) if shared_noise else tuple(mean.shape)
        noise = torch.randn(shape, generator=generator, device=mean.device,
                            dtype=torch.float32)
    std_b = _bcast(std, mean.ndim)
    x_prev = mean + std_b * noise.float()
    return x_prev.detach(), _gaussian_logprob_mean(x_prev, mean, std_b)


def distilled_logprob(alphas_cumprod, eps, timestep, prev_timestep, x_t, x_prev):
    """Log density of a stored transition under the current model (the
    update's recompute, with ``prev_timestep = timestep - step_ratio``)."""
    mean, std = _prev_mean_std(alphas_cumprod, eps, timestep, prev_timestep, x_t)
    return _gaussian_logprob_mean(x_prev.float(), mean, _bcast(std, mean.ndim))
