"""DDIM reverse step with its Gaussian log-density (the SD1.x family).

Semantics of the JAX package's ``ops/ddim.py::ddim_step_with_logprob``:
- computation in float32 whatever the input dtype;
- ``epsilon``, ``sample`` and ``v_prediction`` parameterizations, an
  optional clip of the predicted x0 to [-1, 1];
- the eta-scaled variance (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev);
- a negative ``prev_timestep`` takes ``final_alpha_cumprod``
  (``alphas_cumprod[0]`` by default), as diffusers does;
- the log-density is the mean over non-batch dims, the realized transition
  detached, the std floored at 1e-12 (eta = 0 makes the step
  deterministic).

Torch cannot reproduce JAX's threefry draws, so the stochastic step takes
its unit-normal ``noise`` explicitly; a stored transition is recomputed by
passing ``prev_sample`` instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ddpm_renoise import _take
from .gaussian import bcast as _bcast, gaussian_logprob_mean as _gaussian_logprob_mean

PREDICTION_TYPES = ("epsilon", "sample", "v_prediction")
STD_FLOOR = 1e-12


def ddim_step_with_logprob(
    alphas_cumprod,
    model_output: torch.Tensor,
    timestep: torch.Tensor,
    prev_timestep: torch.Tensor,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    prev_sample: Optional[torch.Tensor] = None,
    eta: float = 1.0,
    prediction_type: str = "epsilon",
    clip_sample: bool = False,
    final_alpha_cumprod: Optional[float] = None,
):
    """One DDIM reverse step x_t -> x_{t_prev} and its log density.

    Args:
      alphas_cumprod: (T,) table (``ops.schedules.make_alphas_cumprod``),
        host numpy or a tensor.
      model_output: the UNet's prediction, (B, ...).
      timestep / prev_timestep: (B,) int timesteps; a negative
        ``prev_timestep`` takes ``final_alpha_cumprod``.
      sample: x_t, (B, ...).
      noise: unit-normal draw shaped like ``sample``: x_prev = mean + std *
        noise. Exactly one of ``noise`` and ``prev_sample`` is given.
      prev_sample: a stored x_prev, whose log density is returned.
    Returns: (x_prev float32, logprob (B,) float32).
    """
    if prediction_type not in PREDICTION_TYPES:
        raise ValueError(f"unknown prediction_type: {prediction_type}")
    if (noise is None) == (prev_sample is None):
        raise ValueError("give exactly one of noise (a new step) and prev_sample (a stored one)")
    sample = sample.float()
    model_output = model_output.float()
    nd = sample.ndim
    a_t = _take(alphas_cumprod, timestep)
    fac = (_take(alphas_cumprod, torch.zeros_like(timestep)) if final_alpha_cumprod is None
           else torch.full_like(a_t, float(final_alpha_cumprod)))
    a_prev = torch.where(prev_timestep >= 0, _take(alphas_cumprod, prev_timestep.clamp(min=0)),
                         fac)
    b_t = 1.0 - a_t
    a_t_b, a_prev_b, b_t_b = (_bcast(v, nd) for v in (a_t, a_prev, b_t))

    if prediction_type == "epsilon":
        pred_x0 = (sample - torch.sqrt(b_t_b) * model_output) / torch.sqrt(a_t_b)
        eps = model_output
    elif prediction_type == "sample":
        pred_x0 = model_output
        eps = (sample - torch.sqrt(a_t_b) * pred_x0) / torch.sqrt(b_t_b)
    else:
        pred_x0 = torch.sqrt(a_t_b) * sample - torch.sqrt(b_t_b) * model_output
        eps = torch.sqrt(a_t_b) * model_output + torch.sqrt(b_t_b) * sample
    if clip_sample:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)

    variance = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
    std_b = _bcast(eta * torch.sqrt(variance.clamp(min=0.0)), nd)
    direction = torch.sqrt((1.0 - a_prev_b - std_b**2).clamp(min=0.0)) * eps
    mean = torch.sqrt(a_prev_b) * pred_x0 + direction

    if prev_sample is None:
        prev_sample = mean + std_b * noise.float()
    else:
        prev_sample = prev_sample.float()
    logprob = _gaussian_logprob_mean(prev_sample, mean, std_b.clamp(min=STD_FLOOR))
    return prev_sample.detach(), logprob
