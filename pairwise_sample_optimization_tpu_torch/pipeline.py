"""SDXL-Turbo pipeline: text encoders, LoRA UNet, VAE decoder and PickScore.

Counterpart of the JAX package's ``pipeline.py`` for the serving half of
the online-PSO loop, the composite that ``bench.py`` times:

dual CLIP text encode -> a pair of Euler-ancestral trajectories per prompt
through the LoRA UNet, recording per-step log-probs -> VAE decode ->
PickScore -> winner per pair.

Public functions keep the JAX layouts: latents (B, h, w, 4), images
(B, H, W, 3) in [-1, 1], trajectories with (S, B, ...) step axes. The
NHWC <-> NCHW permute happens at the UNet and VAE call boundaries. The
slice takes token ids; tokenizers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from .device import resolve_device
from .models.clip import CLIPTextConfig, CLIPTextTower, CLIPVisionConfig
from .models.layers import init_random_
from .models.sdxl_text import compute_time_ids, encode_sdxl_prompt
from .models.unet import SDXLUNet, UNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .ops.schedules import make_euler_ancestral_schedule
from .rewards.pickscore import PickScoreScorer
from .train.sampling import Trajectory, sample_turbo_trajectories


class PairSample(NamedTuple):
    trajectory: Trajectory  # batch 2B: trajectory 0 of every prompt, then trajectory 1
    images: torch.Tensor  # (2B, H, W, 3) in [-1, 1]
    scores: torch.Tensor  # (2B,) PickScore
    winner: torch.Tensor  # (B,) 1 where trajectory 1 scored at least as high (ties -> 1)


@dataclasses.dataclass
class SDXLPipeline:
    unet: SDXLUNet
    vae: AutoencoderKL
    te1: CLIPTextTower
    te2: CLIPTextTower
    scorer: Optional[PickScoreScorer] = None
    resolution: int = 512

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def latent_hw(self) -> int:
        return self.resolution // 2 ** (len(self.vae.config.block_out_channels) - 1)

    @classmethod
    def random(cls, lora_rank: int = 32, dtype=torch.bfloat16, resolution: int = 512,
               tiny: bool = False, seed: int = 0, lora_b_std: float = 0.0,
               device="cuda") -> "SDXLPipeline":
        """Architecture-true random weights made from ``seed``, built on
        ``device`` directly: each tower is constructed on the meta device,
        materialized there with ``to_empty`` and filled by
        ``models.layers.init_random_``. Frozen weights are ``dtype``; LoRA
        is fp32, its B gaussian with std ``lora_b_std`` (0 = a fresh no-op
        adapter). ``tiny`` gives the CPU-test configuration."""
        dev = resolve_device(device)
        if tiny:
            ucfg = UNetConfig.tiny(lora_rank=lora_rank, dtype=dtype)
            vcfg = VAEConfig.tiny(dtype=dtype)
            # TE widths sum to the UNet cross-attention dim (16 + 16 = 32)
            t1cfg = dataclasses.replace(CLIPTextConfig.tiny(dtype), width=16, heads=2)
            t2cfg = dataclasses.replace(CLIPTextConfig.tiny(dtype), width=16, heads=2,
                                        projection_dim=16)
            pcfg = (CLIPTextConfig.tiny(dtype), CLIPVisionConfig.tiny(dtype))
        else:
            ucfg = UNetConfig.sdxl(lora_rank=lora_rank, dtype=dtype)
            vcfg = VAEConfig.sdxl(dtype=dtype)
            t1cfg = CLIPTextConfig.sdxl_te1(dtype)
            t2cfg = CLIPTextConfig.sdxl_te2(dtype)
            pcfg = (CLIPTextConfig.vit_h14(dtype), CLIPVisionConfig.vit_h14(dtype))
        gen = torch.Generator(device=dev).manual_seed(seed)

        def make(module):
            module.to_empty(device=dev)
            init_random_(module, gen, lora_b_std=lora_b_std)
            return module.eval()

        unet = make(SDXLUNet(ucfg, device="meta"))
        vae = make(AutoencoderKL(vcfg, device="meta"))
        te1 = make(CLIPTextTower(t1cfg, device="meta"))
        te2 = make(CLIPTextTower(t2cfg, device="meta"))
        scorer = PickScoreScorer.random(*pcfg, seed=seed + 1, device=dev)
        return cls(unet=unet, vae=vae, te1=te1, te2=te2, scorer=scorer, resolution=resolution)

    @torch.no_grad()
    def encode_prompt(self, input_ids_one, input_ids_two, reward_ids=None) -> dict:
        """Token ids (B, 77) for each text encoder -> conditioning dict:
        ``embeds`` (B, 77, 2048), ``pooled`` (B, 1280), ``time_ids`` (B, 6)
        and ``reward_ids`` (the scorer's token ids; ``input_ids_one`` when
        not given)."""
        embeds, pooled = encode_sdxl_prompt(self.te1, self.te2, input_ids_one, input_ids_two)
        time_ids = compute_time_ids(embeds.shape[0], self.resolution, device=embeds.device)
        return {"embeds": embeds, "pooled": pooled, "time_ids": time_ids,
                "reward_ids": input_ids_one if reward_ids is None else reward_ids}

    def unet_eps(self, x, t, cond, lora_scale=1.0):
        """x (B, h, w, 4) -> eps (B, h, w, 4) fp32."""
        # contiguous NCHW: a permuted view would make the convs keep the
        # channels-last layout, which the GroupNorm+SiLU kernels do not take
        eps = self.unet(x.permute(0, 3, 1, 2).contiguous(), t, cond["embeds"], cond["pooled"],
                        cond["time_ids"], lora_scale=lora_scale)
        return eps.permute(0, 2, 3, 1)

    def decode(self, latents):
        """Scaled latents (B, h, w, 4) -> images (B, H, W, 3) in [-1, 1], fp32."""
        z = latents.permute(0, 3, 1, 2).contiguous()
        return self.vae.decode(z).permute(0, 2, 3, 1).float()

    def rollout(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0,
                init_noise=None, step_noise=None) -> Trajectory:
        """Turbo trajectories for ``cond``'s batch. Noise is drawn from
        ``generator`` unless given: ``init_noise`` (B, h, w, 4) and
        ``step_noise`` (S, B, h, w, 4), unit normals."""
        schedule = make_euler_ancestral_schedule(num_steps)
        b = cond["embeds"].shape[0]
        if init_noise is None:
            init_noise = torch.randn((b, self.latent_hw, self.latent_hw,
                                      self.unet.config.in_channels),
                                     generator=generator, device=self.device)
        eps_fn = lambda x, t: self.unet_eps(x, t, cond, lora_scale)
        return sample_turbo_trajectories(eps_fn, schedule, init_noise, noise=step_noise,
                                         generator=generator)

    @torch.no_grad()
    def generate(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0):
        """Turbo txt2img: images (B, H, W, 3) in [-1, 1]."""
        return self.decode(self.rollout(cond, generator, num_steps, lora_scale).final_latents)

    @torch.no_grad()
    def sample_pairs(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0,
                     init_noise=None, step_noise=None, timings: Optional[dict] = None):
        """Two trajectories per prompt, decoded and scored.

        The conditioning is duplicated along the batch (trajectory 0 of
        every prompt, then trajectory 1), each trajectory with its own
        noise. ``winner[i]`` is 1 when trajectory 1 of prompt i scored at
        least as high as trajectory 0 (ties go to trajectory 1). When
        ``timings`` is a dict, the device is synchronized after each phase
        and its milliseconds recorded under ``rollout``, ``decode`` and
        ``score``.
        """
        if self.scorer is None:
            raise ValueError("sample_pairs needs a PickScore scorer")
        b = cond["embeds"].shape[0]
        pair = {k: torch.cat([v, v], dim=0) for k, v in cond.items()}
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            if timings is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t1 = time.perf_counter()
                timings[name] = (t1 - t0) * 1e3
                t0 = t1

        traj = self.rollout(pair, generator, num_steps, lora_scale, init_noise, step_noise)
        mark("rollout")
        images = self.decode(traj.final_latents)
        mark("decode")
        txt = self.scorer.text_features(cond["reward_ids"])
        scores = self.scorer.score_with_text_features(images, torch.cat([txt, txt], dim=0))
        winner = (scores[b:] >= scores[:b]).long()
        mark("score")
        return PairSample(traj, images, scores, winner)
