"""SDXL-Turbo, SDXL-DMD2 and SD1.x CFG-DDIM trajectory samplers with
per-step log-probs.

Counterpart of the JAX package's ``train/sampling.py::
sample_turbo_trajectories``, ``sample_dmd_trajectories`` and
``sample_ddim_cfg_trajectories``, as Python loops. The recorded tensors
of the Turbo sampler match it:

- ``latents[t]`` for t in [0, S-1]   (current = [:-1], next = [1:])
- ``input_latents[t]`` (Euler-scaled UNet inputs) for t in [0, S-2]
- ``log_probs[t]`` for t in [0, S-2]; the last step is deterministic
  (sigma_up = 0, its log-prob NaN by design) and is dropped.

Latents keep the JAX layout (B, h, w, C). ``eps_fn(x, t) -> eps`` closes
over the UNet and the conditioning, so one sampler serves the policy and
the reference model.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.ddim import ddim_step_with_logprob
from ..ops.ddpm_renoise import distilled_step_with_logprob, x0_from_eps
from ..ops.euler_ancestral import scale_model_input, turbo_step_with_logprob
from ..ops.schedules import EulerAncestralSchedule


class Trajectory(NamedTuple):
    """Stacked along a leading step axis; batch axis second."""

    final_latents: torch.Tensor  # (B, h, w, C): feed to VAE decode
    latents: torch.Tensor  # (S, B, h, w, C): x_0 .. x_{S-1}
    input_latents: torch.Tensor  # (S-1, B, h, w, C): scaled UNet inputs
    log_probs: torch.Tensor  # (S-1, B)

    @property
    def current_latents(self):
        return self.latents[:-1]

    @property
    def next_latents(self):
        return self.latents[1:]


def sample_turbo_trajectories(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: EulerAncestralSchedule,
    init_latents: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Trajectory:
    """Full SDXL-Turbo stochastic rollout with per-step log-probs.

    ``init_latents`` (B, h, w, C) are unit-normal draws, scaled here by
    ``init_noise_sigma``. ``noise`` (S, B, h, w, C) holds each step's unit
    normal transition noise; when it is None it is drawn from ``generator``.
    """
    num_steps = schedule.num_steps
    batch = init_latents.shape[0]
    device = init_latents.device
    x = init_latents.float() * float(schedule.init_noise_sigma)
    if noise is None:
        noise = torch.randn((num_steps,) + tuple(x.shape), generator=generator,
                            device=device, dtype=torch.float32)
    xs, x_ins, logprobs = [], [], []
    for i in range(num_steps):
        idxs = torch.full((batch,), i, dtype=torch.long, device=device)
        x_in = scale_model_input(schedule, x, idxs)
        t = torch.full((batch,), int(schedule.timesteps[i]), dtype=torch.int32, device=device)
        eps = eps_fn(x_in, t)
        x_next, logprob = turbo_step_with_logprob(schedule, eps, idxs, x, noise[i])
        xs.append(x)
        x_ins.append(x_in)
        logprobs.append(logprob)
        x = x_next
    return Trajectory(
        final_latents=x,
        latents=torch.stack(xs),
        input_latents=torch.stack(x_ins[:-1]),
        log_probs=torch.stack(logprobs[:-1]),
    )


def sample_dmd_trajectories(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    alphas_cumprod,
    timesteps,
    init_latents: torch.Tensor,
    transition_noise: Optional[torch.Tensor] = None,
    shared_noise: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Trajectory:
    """SDXL-DMD2 rollout: DDPM re-noise transitions, deterministic final x0.

    ``timesteps`` is the (S,) descending lattice (``ops.schedules.
    distill_timesteps``), ``alphas_cumprod`` its table. DMD2's
    ``init_noise_sigma`` is 1, so ``init_latents`` (B, h, w, C) are used as
    they are, and the UNet sees x itself: ``input_latents`` equals
    ``latents[:-1]``. S-1 stochastic transitions record their log-probs;
    the last lattice timestep gives the deterministic x0 prediction that is
    decoded. ``transition_noise`` (S-1, B, h, w, C) (or (S-1, 1, h, w, C),
    shared by the batch) holds each transition's unit normal noise; when it
    is None each step draws from ``generator`` (one sample shared by the
    batch if ``shared_noise``).
    """
    num_steps = len(timesteps)
    batch = init_latents.shape[0]
    device = init_latents.device
    x = init_latents.float()
    xs, logprobs = [], []
    for i in range(num_steps - 1):
        t = torch.full((batch,), int(timesteps[i]), dtype=torch.int32, device=device)
        t_prev = torch.full((batch,), int(timesteps[i + 1]), dtype=torch.int32, device=device)
        eps = eps_fn(x, t)
        nz = None if transition_noise is None else transition_noise[i]
        x_next, logprob = distilled_step_with_logprob(alphas_cumprod, eps, t, t_prev, x, nz,
                                                      shared_noise, generator)
        xs.append(x)
        logprobs.append(logprob)
        x = x_next
    t_last = torch.full((batch,), int(timesteps[-1]), dtype=torch.int32, device=device)
    pred_x0 = x0_from_eps(x, eps_fn(x, t_last).float(), alphas_cumprod, t_last)
    latents = torch.stack(xs + [x])  # x_0 .. x_{S-1}
    return Trajectory(
        final_latents=pred_x0,
        latents=latents,
        input_latents=latents[:-1],
        log_probs=torch.stack(logprobs),
    )


def sample_ddim_cfg_trajectories(
    eps_cfg_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    alphas_cumprod,
    timesteps,
    init_latents: torch.Tensor,
    noise: torch.Tensor,
    eta: float = 1.0,
) -> Trajectory:
    """SD1.x DDIM rollout with log-probs (the reference's
    ``pipeline_with_logprob.py`` heritage path). ``eps_cfg_fn(x, t)`` is the
    CFG-combined epsilon (the caller mixes the unconditional and conditional
    predictions); every step is stochastic (eta-scaled), so all S
    transitions carry log-probs and the last step's prev timestep is -1
    (``final_alpha_cumprod``).

    ``timesteps`` is the (S,) descending lattice, ``init_latents`` the
    starting latents (used as they are, in the layout ``eps_cfg_fn`` takes:
    (B, C, h, w) for the UNet) and ``noise`` (S,) + their shape, each step's
    unit-normal draw. Returns S+1 ``latents`` (current = [:-1], next =
    [1:]), ``input_latents`` = ``latents[:-1]``, (S, B) ``log_probs`` and the
    last latents as ``final_latents``.
    """
    num_steps = len(timesteps)
    batch = init_latents.shape[0]
    device = init_latents.device
    x = init_latents.float()
    prev_ts = [int(t) for t in timesteps[1:]] + [-1]
    xs, logprobs = [], []
    for i in range(num_steps):
        t = torch.full((batch,), int(timesteps[i]), dtype=torch.int32, device=device)
        tp = torch.full((batch,), prev_ts[i], dtype=torch.int32, device=device)
        x_next, logprob = ddim_step_with_logprob(alphas_cumprod, eps_cfg_fn(x, t), t, tp, x,
                                                 noise=noise[i], eta=eta)
        xs.append(x)
        logprobs.append(logprob)
        x = x_next
    latents = torch.stack(xs + [x])  # x_0 .. x_S
    return Trajectory(
        final_latents=x,
        latents=latents,
        input_latents=latents[:-1],
        log_probs=torch.stack(logprobs),
    )
