"""Noise-schedule tables for the few-step distilled samplers (numpy).

Own copy of the JAX package's ``ops/schedules.py`` table builders (which
are pure numpy there too): scaled-linear betas over 1000 train steps,
trailing spacing, so the 4-step SDXL-Turbo timesteps are
[999, 749, 499, 249]. Tables stay host numpy; samplers move what they
index to the device once per call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear", "squaredcos_cap_v2"
    timestep_spacing: str = "trailing"


def _betas(cfg: NoiseScheduleConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(n, dtype=np.float64)
        f = lambda s: np.cos((s / n + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.minimum(1.0 - f(t + 1) / f(t), 0.999)
    raise ValueError(f"unknown beta_schedule: {cfg.beta_schedule}")


def make_alphas_cumprod(cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> np.ndarray:
    """(T,) cumulative alpha-bar table in float32."""
    return np.cumprod(1.0 - _betas(cfg)).astype(np.float32)


def distill_timesteps(num_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """DMD2 fixed timestep lattice, descending: e.g. n=4 -> [999,749,499,249]."""
    step_ratio = num_train_timesteps // num_steps
    return (np.round(np.arange(num_steps, 0, -1, dtype=np.float64) * step_ratio) - 1).astype(
        np.int32
    )


class EulerAncestralSchedule(NamedTuple):
    """Static tables for an S-step Euler-ancestral (VE-SDE) sampler.

    ``sigmas`` has S+1 entries (last is 0); ``sigma_up``/``sigma_down`` are
    the ancestral split per step:
        sigma_up^2   = sigma_to^2 (sigma_from^2 - sigma_to^2) / sigma_from^2
        sigma_down^2 = sigma_to^2 - sigma_up^2
    """

    timesteps: np.ndarray  # (S,) int32, descending
    sigmas: np.ndarray  # (S+1,) float32
    sigma_up: np.ndarray  # (S,) float32; 0 at the last (deterministic) step
    sigma_down: np.ndarray  # (S,) float32
    init_noise_sigma: np.ndarray  # scalar float32

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_euler_ancestral_schedule(
    num_inference_steps: int,
    cfg: NoiseScheduleConfig = NoiseScheduleConfig(),
) -> EulerAncestralSchedule:
    n = cfg.num_train_timesteps
    betas = _betas(cfg)
    alphas_cumprod = np.cumprod(1.0 - betas)
    sigmas_full = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

    if cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        timesteps = (np.round(np.arange(n, 0, -step_ratio)) - 1).astype(np.int32)
    elif cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, n - 1, num_inference_steps, dtype=np.float64)[::-1]
        timesteps = np.round(timesteps).astype(np.int32)
    elif cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio)[::-1].astype(np.int32)
    else:
        raise ValueError(f"unknown timestep_spacing: {cfg.timestep_spacing}")

    sigmas = np.interp(timesteps.astype(np.float64), np.arange(n), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]])

    s_from, s_to = sigmas[:-1], sigmas[1:]
    sigma_up_sq = s_to**2 * (s_from**2 - s_to**2) / s_from**2
    sigma_up = np.sqrt(sigma_up_sq)
    sigma_down = np.sqrt(s_to**2 - sigma_up_sq)

    if cfg.timestep_spacing in ("trailing", "linspace"):
        init_noise_sigma = sigmas.max()
    else:
        init_noise_sigma = np.sqrt(sigmas.max() ** 2 + 1)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return EulerAncestralSchedule(
        timesteps=np.asarray(timesteps, dtype=np.int32),
        sigmas=f32(sigmas),
        sigma_up=f32(sigma_up),
        sigma_down=f32(sigma_down),
        init_noise_sigma=f32(init_noise_sigma),
    )
