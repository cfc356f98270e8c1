"""Offline (DreamBooth) PSO: the user's instance images win, images the
model generated for the class prompt lose; a Diffusion-DPO-style loss on
the difference of their denoising losses.

Counterpart of the JAX package's ``train/dreambooth_pso.py`` for the
UNet's LoRA (or DoRA) and, with ``train_text_encoder``, the text encoders':

- the win and lose halves share their timesteps and their noise;
- the timesteps are the distilled lattice ``stride * (u mod 4) + stride - 1``
  read from the scheduler's descending table, so the trained timesteps are
  ``T - 1 - idx`` (``descending_table``; ``False`` uses the lattice values
  directly);
- three scheduler spaces: ``euler_edm`` (sigma-space noising
  ``x0 + sigma n``, input ``x_t / sqrt(sigma^2 + 1)``, the x0 prediction as
  target, weighting sigma^-2 clipped at ``snr_clip``), ``edm`` (Karras
  sigmas, EDM's c_in / c_skip / c_out with ``sigma_data``, the fractional
  UNet timestep ``c_noise = 0.25 ln sigma``, weighting 1) and ``ddpm``
  (``sqrt(abar) x0 + sqrt(1 - abar) n``, the epsilon or velocity target,
  weighting 1), each for epsilon and v prediction;
- per-sample weighted MSE, ``losses.dreambooth_pso_loss`` (``pso`` needs
  the frozen reference: one fused call at twice the batch with per-sample
  LoRA scales [1, 1, 0, 0], or a separate grad-free call at a static scale
  of 0, the form DoRA needs);
- ``train_text_encoder``: each microbatch encodes its prompts from token ids
  (``input_ids_one`` / ``input_ids_two``) through the text encoders' live
  adapters, with gradients. The ``pso`` reference pass takes that same
  conditioning (the JAX package's choice): only its UNet runs at scale 0;
- ``grad_accum`` microbatches: their gradients summed, divided by
  ``grad_accum``, then one optimizer step.

Randomness is explicit: :meth:`DreamBoothPSOTrainer.update` takes each
microbatch's lattice indices and noise (:func:`sample_lattice_timesteps`
and ``torch.randn`` draw them from a generator; a test hands in the JAX
package's draws).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.schedules import NoiseScheduleConfig, make_alphas_cumprod, make_karras_sigmas
from .losses import dreambooth_pso_loss
from .train_state import PSOTrainState

SCHEDULER_SPACES = ("euler_edm", "edm", "ddpm")


@dataclasses.dataclass(frozen=True)
class DreamBoothPSOConfig:
    loss_type: str = "pso_db"  # "pso" | "pso_db"
    beta: float = 5.0
    neg_defactor: float = 1.0
    prior_loss_weight: float = 0.5
    distill_train_timesteps: int = 4  # lattice points
    num_train_timesteps: int = 1000
    scheduler_space: str = "euler_edm"  # "euler_edm" | "edm" | "ddpm"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction"
    descending_table: bool = True  # lattice values index the descending timestep table
    sigma_data: float = 0.5  # EDM's c_in / c_skip / c_out constant
    grad_accum: int = 1
    train_text_encoder: bool = False
    snr_clip: float = 1e8  # cap of the sigma^-2 weighting
    fuse_ref_pass: bool = True  # pso: policy and reference in one call at twice the batch

    def __post_init__(self):
        if self.scheduler_space not in SCHEDULER_SPACES:
            raise ValueError(f"unknown scheduler_space {self.scheduler_space!r}")
        if self.prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown prediction_type {self.prediction_type!r}")
        if self.loss_type not in ("pso", "pso_db"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")


def make_sigma_table(cfg: NoiseScheduleConfig = NoiseScheduleConfig()) -> np.ndarray:
    """(T,) VE sigma table sqrt((1 - abar) / abar), float32."""
    ac = make_alphas_cumprod(cfg)
    return np.sqrt((1.0 - ac) / ac).astype(np.float32)


def sample_lattice_timesteps(batch: int, num_train_timesteps: int, lattice_points: int,
                             generator: Optional[torch.Generator] = None,
                             device="cpu") -> torch.Tensor:
    """(batch,) lattice indices from ``generator``: uniform integers in
    [0, T) folded onto the lattice ({249, 499, 749, 999} for 4 points of
    1000)."""
    u = torch.randint(0, num_train_timesteps, (batch,), generator=generator, device=device)
    stride = num_train_timesteps // lattice_points
    return stride * (u % lattice_points) + stride - 1


class DreamBoothPSOTrainer:
    """The update for one pipeline (``pipeline.SDXLPipeline``: its
    ``unet_eps``, and its ``encode_prompt_train`` with
    ``train_text_encoder``)."""

    def __init__(self, config: DreamBoothPSOConfig, pipeline,
                 schedule_config: NoiseScheduleConfig = NoiseScheduleConfig()):
        self.config = config
        self.pipe = pipeline
        sigmas = (make_karras_sigmas(config.num_train_timesteps)
                  if config.scheduler_space == "edm" else make_sigma_table(schedule_config))
        self.sigmas = torch.from_numpy(sigmas)
        self.alphas_cumprod = torch.from_numpy(make_alphas_cumprod(schedule_config))

    # ------------------------------------------------------------------ #
    # scheduler spaces
    # ------------------------------------------------------------------ #

    def noise_and_precondition(self, latents, noise, t_eff):
        """-> (UNet input, UNet timestep, noisy latents, target, weighting,
        post); ``post(pred, noisy)`` maps the UNet's output into the target's
        space. fp32; latents and noise (B, h, w, c), ``t_eff`` (B,) ints."""
        cfg = self.config
        dev = latents.device
        if cfg.scheduler_space in ("euler_edm", "edm"):
            sig_b = self.sigmas.to(dev)[t_eff]
            sig = sig_b.reshape(-1, 1, 1, 1)
            noisy = latents + sig * noise
            target = latents
            if cfg.scheduler_space == "euler_edm":
                inp = noisy / torch.sqrt(sig ** 2 + 1.0)
                t_cond = t_eff.float()
                weighting = torch.clamp(sig ** -2.0, max=cfg.snr_clip)
                if cfg.prediction_type == "epsilon":
                    post = lambda pred, x_t: pred * (-sig) + x_t
                else:
                    post = lambda pred, x_t: (pred * (-sig / torch.sqrt(sig ** 2 + 1.0))
                                              + x_t / (sig ** 2 + 1.0))
            else:
                sd = cfg.sigma_data
                inp = noisy / torch.sqrt(sig ** 2 + sd ** 2)
                t_cond = 0.25 * torch.log(sig_b)  # c_noise: a fractional timestep
                weighting = torch.ones_like(sig)
                c_skip = sd ** 2 / (sig ** 2 + sd ** 2)
                sign = 1.0 if cfg.prediction_type == "epsilon" else -1.0
                c_out = sign * sig * sd / torch.sqrt(sig ** 2 + sd ** 2)
                post = lambda pred, x_t: c_skip * x_t + c_out * pred
        else:
            abar = self.alphas_cumprod.to(dev)[t_eff].reshape(-1, 1, 1, 1)
            sa, sb = torch.sqrt(abar), torch.sqrt(1.0 - abar)
            noisy = sa * latents + sb * noise
            inp = noisy
            t_cond = t_eff.float()
            weighting = torch.ones_like(abar)
            target = noise if cfg.prediction_type == "epsilon" else sa * noise - sb * latents
            post = lambda pred, x_t: pred
        return inp, t_cond, noisy, target, weighting, post

    @staticmethod
    def weighted_mse(pred, target, weighting):
        """(B,) mean over each sample of weighting * (pred - target)^2."""
        return (weighting * (pred - target).square()).reshape(pred.shape[0], -1).mean(dim=1)

    def _per_sample_loss(self, latents, noise, t_eff, cond, lora_scale):
        inp, t_cond, noisy, target, weighting, post = self.noise_and_precondition(
            latents, noise, t_eff)
        pred = self.pipe.unet_eps(inp, t_cond, cond, lora_scale)
        return self.weighted_mse(post(pred, noisy), target, weighting)

    # ------------------------------------------------------------------ #
    # update
    # ------------------------------------------------------------------ #

    def microbatch_loss(self, micro: dict, idx, noise_half):
        """(loss, aux) of one microbatch: ``micro`` holds ``instance_latents``
        and ``negative_latents`` (b, h, w, c), the win half's conditioning (b
        rows): ``cond``, or with ``train_text_encoder`` its token ids
        ``input_ids_one`` / ``input_ids_two`` (b, 77), and optionally
        ``time_ids_win`` / ``time_ids_lose`` (b, 6); ``idx`` (b,) lattice
        indices, ``noise_half`` (b, h, w, c) shared by both halves."""
        cfg = self.config
        latents2 = torch.cat([micro["instance_latents"], micro["negative_latents"]]).float()
        if cfg.train_text_encoder:
            enc = self.pipe.encode_prompt_train(micro["input_ids_one"], micro["input_ids_two"])
            cond = {k: enc[k] for k in ("embeds", "pooled", "time_ids")}
        else:
            cond = micro["cond"]
        cond2 = {k: torch.cat([v, v]) for k, v in cond.items()}
        if "time_ids_win" in micro:
            cond2["time_ids"] = torch.cat([micro["time_ids_win"], micro["time_ids_lose"]])
        t_eff = (cfg.num_train_timesteps - 1 - idx) if cfg.descending_table else idx
        t2 = t_eff.repeat(2)
        noise2 = noise_half.float().repeat(2, 1, 1, 1)
        b2 = latents2.shape[0]
        if cfg.loss_type == "pso":
            if cfg.fuse_ref_pass:
                cat = lambda x: torch.cat([x, x])
                scale4 = torch.cat([torch.ones(b2, device=latents2.device),
                                    torch.zeros(b2, device=latents2.device)])
                per4 = self._per_sample_loss(cat(latents2), cat(noise2), cat(t2),
                                             {k: cat(v) for k, v in cond2.items()}, scale4)
                per_pol, per_ref = per4[:b2], per4[b2:].detach()
            else:
                per_pol = self._per_sample_loss(latents2, noise2, t2, cond2, 1.0)
                with torch.no_grad():
                    per_ref = self._per_sample_loss(latents2, noise2, t2, cond2, 0.0)
            mw, ml = per_pol.chunk(2)
            rw, rl = per_ref.chunk(2)
        else:
            mw, ml = self._per_sample_loss(latents2, noise2, t2, cond2, 1.0).chunk(2)
            rw = rl = None
        loss, logits = dreambooth_pso_loss(mw, ml, rw, rl, beta=cfg.beta, loss_type=cfg.loss_type,
                                           neg_defactor=cfg.neg_defactor,
                                           prior_loss_weight=cfg.prior_loss_weight)
        aux = {"loss": loss.detach(), "win_loss": mw.detach().mean(),
               "lose_loss": ml.detach().mean(),
               "implicit_acc": (logits.detach() > 0).float().mean()}
        return loss, aux

    def update(self, state: PSOTrainState, batch: dict, idx, noise) -> Dict[str, float]:
        """One optimizer step over ``grad_accum`` microbatches. Every leaf of
        ``batch`` (``instance_latents``, ``negative_latents``, ``cond``'s or
        the token ids, ``time_ids_win`` / ``time_ids_lose``), ``idx`` (ga, b)
        and ``noise`` (ga, b, h, w, c) has a leading microbatch axis. The gradients of the
        microbatch losses are summed and divided by ``grad_accum``; the
        metrics are means over the microbatches."""
        ga = self.config.grad_accum
        for p in state.lora.values():
            p.grad = None
        sums = {}
        for a in range(ga):
            micro = {k: ({c: t[a] for c, t in v.items()} if isinstance(v, dict) else v[a])
                     for k, v in batch.items()}
            loss, aux = self.microbatch_loss(micro, idx[a], noise[a])
            loss.backward()
            for k, v in aux.items():
                sums[k] = sums.get(k, 0.0) + v
        grads = {name: (p.grad / ga if p.grad is not None else torch.zeros_like(p))
                 for name, p in state.lora.items()}
        state.apply_gradients(grads)
        del grads  # read inside the optimizer's step: freed now, as JAX's die with the step
        for p in state.lora.values():
            p.grad = None
        return {k: float(v / ga) for k, v in sums.items()}
