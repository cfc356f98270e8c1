"""SDXL pipeline: text encoders, LoRA UNet, VAE and PickScore.

Counterpart of the JAX package's ``pipeline.py`` for the serving half of
the online-PSO loop, the composite that ``bench.py`` times:

dual CLIP text encode -> a pair of trajectories per prompt through the
LoRA UNet, recording per-step log-probs -> VAE decode -> PickScore ->
winner per pair. The trajectories are SDXL-Turbo's Euler-ancestral ones or
SDXL-DMD2's DDPM re-noise ones on the fixed lattice (``sampler="dmd"``);
``generate_dmd`` is the eval protocol's DMD2 txt2img.

Public functions keep the JAX layouts: latents (B, h, w, 4), images
(B, H, W, 3) in [-1, 1], trajectories with (S, B, ...) step axes. The
NHWC <-> NCHW permute happens at the UNet and VAE call boundaries. The
pipeline takes token ids (``data.tokenizer`` makes them).

``decode_chunk`` (0: the whole batch) decodes that many latents a call, as
the JAX package's ``decode_chunk``: it bounds the VAE decoder's activation
memory at 1024^2. ``reference_unet`` is full finetuning's frozen reference
copy (``models.unet.frozen_copy``); without one the reference is
``lora_scale=0`` on ``unet``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import torch

from .checkpoints.convert import load_torch_state_dict, load_weights, tower_weight_file
from .device import resolve_device
from .models.clip import CLIPTextConfig, CLIPTextTower, CLIPVisionConfig
from .models.layers import init_weights_, refresh_dora_magnitudes_
from .models.sdxl_text import compute_time_ids, encode_sdxl_prompt
from .models.unet import SDXLUNet, UNetConfig
from .models.vae import AutoencoderKL, VAEConfig
from .ops.schedules import distill_timesteps, make_alphas_cumprod, make_euler_ancestral_schedule
from .rewards.pickscore import PickScoreScorer
from .train.sampling import Trajectory, sample_dmd_trajectories, sample_turbo_trajectories
from .utils import get_logger

logger = get_logger("pso.pipeline")

SAMPLERS = ("turbo", "dmd")


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
    decode_chunk: int = 0
    reference_unet: Optional[SDXLUNet] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def latent_hw(self) -> int:
        return self.resolution // 2 ** (len(self.vae.config.block_out_channels) - 1)

    @classmethod
    def random(cls, lora_rank: int = 32, dtype=torch.bfloat16, resolution: int = 512,
               tiny: bool = False, seed: int = 0, lora_b_std: float = 0.0,
               remat: str = "", device="cuda", with_scorer: bool = True,
               te_lora_rank: int = 0, use_dora: bool = False,
               unet_param_dtype: Optional[torch.dtype] = None,
               fast_init: bool = False) -> "SDXLPipeline":
        """Architecture-true random weights made from ``seed``, built on
        ``device`` directly: each tower is constructed on the meta device,
        materialized there with ``to_empty`` and filled by
        ``models.layers.init_random_``. Frozen weights are ``dtype``; LoRA
        is fp32, its B gaussian with std ``lora_b_std`` (0 = a fresh no-op
        adapter). ``tiny`` gives the CPU-test configuration; ``remat`` is the
        UNet's activation checkpointing (``UNetConfig.remat``);
        ``with_scorer=False`` leaves out the PickScore scorer.
        ``te_lora_rank`` puts a LoRA of that rank on both text encoders'
        attention projections (DreamBooth's text-encoder training);
        ``use_dora`` makes every adapter (UNet and text encoders) DoRA.
        ``unet_param_dtype`` stores the UNet's weights in that dtype (its
        draws are made in ``dtype`` first), computing in ``dtype``
        (``SDXLUNet.set_param_dtype``; None: stored in ``dtype``).
        ``fast_init`` fills every tower (the LoRA and the scorer too) with
        zeros instead, for benches and compile checks, as the JAX package's
        ``fast_init``: no draw is made."""
        dev = resolve_device(device)
        if tiny:
            ucfg = UNetConfig.tiny(lora_rank=lora_rank, dtype=dtype, remat=remat)
            vcfg = VAEConfig.tiny(dtype=dtype)
            # TE widths sum to the UNet cross-attention dim (16 + 16 = 32)
            t1cfg = dataclasses.replace(CLIPTextConfig.tiny(dtype), width=16, heads=2)
            t2cfg = dataclasses.replace(CLIPTextConfig.tiny(dtype), width=16, heads=2,
                                        projection_dim=16)
            pcfg = (CLIPTextConfig.tiny(dtype), CLIPVisionConfig.tiny(dtype))
        else:
            ucfg = UNetConfig.sdxl(lora_rank=lora_rank, dtype=dtype, remat=remat)
            vcfg = VAEConfig.sdxl(dtype=dtype)
            t1cfg = CLIPTextConfig.sdxl_te1(dtype)
            t2cfg = CLIPTextConfig.sdxl_te2(dtype)
            pcfg = (CLIPTextConfig.vit_h14(dtype), CLIPVisionConfig.vit_h14(dtype))
        ucfg = dataclasses.replace(ucfg, lora_use_dora=use_dora)
        t1cfg, t2cfg = (dataclasses.replace(c, lora_rank=te_lora_rank, lora_use_dora=use_dora)
                        for c in (t1cfg, t2cfg))
        gen = torch.Generator(device=dev).manual_seed(seed)

        def make(module):
            module.to_empty(device=dev)
            init_weights_(module, gen, fast_init, lora_b_std=lora_b_std)
            return module.eval()

        unet = make(SDXLUNet(ucfg, device="meta"))
        if unet_param_dtype not in (None, dtype):
            unet.set_param_dtype(unet_param_dtype)
        vae = make(AutoencoderKL(vcfg, device="meta"))
        te1 = make(CLIPTextTower(t1cfg, device="meta"))
        te2 = make(CLIPTextTower(t2cfg, device="meta"))
        scorer = (PickScoreScorer.random(*pcfg, seed=seed + 1, device=dev, fast_init=fast_init)
                  if with_scorer else None)
        return cls(unet=unet, vae=vae, te1=te1, te2=te2, scorer=scorer, resolution=resolution)

    @classmethod
    def from_torch_dir(cls, model_dir: str, lora_rank: int = 32, dtype=torch.bfloat16,
                       resolution: int = 512, tiny: bool = False, seed: int = 0,
                       remat: str = "", device="cuda", with_scorer: bool = True,
                       te_lora_rank: int = 0, use_dora: bool = False,
                       unet_param_dtype: Optional[torch.dtype] = None) -> "SDXLPipeline":
        """A local diffusers checkpoint directory: ``unet/``, ``vae/``,
        ``text_encoder/`` and ``text_encoder_2/``, each read from its first
        ``.safetensors`` or ``.bin`` file in name order (the JAX package's
        choice; a diffusers ``fp16`` variant sorts first), in any stored
        dtype, straight onto ``device``.

        The towers are built as :meth:`random` builds them (meta device,
        then ``device``), then every frozen weight is replaced strictly
        (``checkpoints.load_weights``) and cast to ``dtype``. The LoRA keeps
        its fresh draw: down-projections gaussian with std 1/r, up zero, a
        no-op adapter that still gets a gradient (what the JAX package's
        ``reinit_lora_a`` restores after its zero fill); DoRA magnitudes are
        set anew from the loaded weights, so the adapter is a no-op at step 0
        (the JAX package's ``refresh_dora_magnitudes``). Every VAE key is
        read, the encoder's and ``quant_conv`` too; read past: the text
        towers' ``position_ids``. A tower whose folder holds no
        weight file keeps its random weights, with a warning. The UNet's
        weights are read into ``unet_param_dtype`` where it is given. The PickScore
        scorer (``with_scorer``) is random: its weights are not part of a
        diffusers checkpoint."""
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"model_dir {model_dir!r} is not a directory")
        pipe = cls.random(lora_rank, dtype, resolution, tiny, seed, remat=remat, device=device,
                          with_scorer=with_scorer, te_lora_rank=te_lora_rank, use_dora=use_dora,
                          unet_param_dtype=unet_param_dtype)
        for sub, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.te1),
                            ("text_encoder_2", pipe.te2)):
            path = tower_weight_file(os.path.join(model_dir, sub))
            if path is None:
                logger.warning("no weights under %s -- its tower stays random", sub)
                continue
            unused = load_weights(module, load_torch_state_dict(path, pipe.device))
            refresh_dora_magnitudes_(module)
            logger.info("loaded %s from %s (%d keys read past)", sub, path, len(unused))
        return pipe

    @torch.no_grad()
    def encode_prompt(self, input_ids_one, input_ids_two, reward_ids=None) -> dict:
        """Token ids (B, 77) for each text encoder -> conditioning dict:
        ``embeds`` (B, 77, 2048), ``pooled`` (B, 1280), ``time_ids`` (B, 6)
        and ``reward_ids`` (the scorer's token ids; ``input_ids_one`` when
        not given). No gradients; see :meth:`encode_prompt_train`."""
        return self.encode_prompt_train(input_ids_one, input_ids_two, reward_ids)

    def encode_prompt_train(self, input_ids_one, input_ids_two, reward_ids=None) -> dict:
        """:meth:`encode_prompt` with gradients flowing into the text
        encoders' trainable adapters (DreamBooth's text-encoder LoRA)."""
        embeds, pooled = encode_sdxl_prompt(self.te1, self.te2, input_ids_one, input_ids_two)
        time_ids = compute_time_ids(embeds.shape[0], self.resolution, device=embeds.device)
        return {"embeds": embeds, "pooled": pooled, "time_ids": time_ids,
                "reward_ids": input_ids_one if reward_ids is None else reward_ids}

    def unet_eps(self, x, t, cond, lora_scale=1.0, unet=None):
        """x (B, h, w, 4) -> eps (B, h, w, 4) fp32, through ``unet`` (default:
        the pipeline's)."""
        # contiguous NCHW: a permuted view would make the convs keep the
        # channels-last layout, which the GroupNorm+SiLU kernels do not take
        eps = (unet or self.unet)(x.permute(0, 3, 1, 2).contiguous(), t, cond["embeds"],
                                  cond["pooled"], cond["time_ids"], lora_scale=lora_scale)
        return eps.permute(0, 2, 3, 1)

    def decode(self, latents):
        """Scaled latents (B, h, w, 4) -> images (B, H, W, 3) in [-1, 1], fp32,
        ``decode_chunk`` latents a call (0: all at once); a batch that
        ``decode_chunk`` does not divide is refused, as the JAX package
        asserts."""
        n, chunk = latents.shape[0], self.decode_chunk
        if chunk and n > chunk:
            if n % chunk:
                raise ValueError(f"decode_chunk {chunk} does not divide the batch of {n}")
            return torch.cat([self._decode(latents[i:i + chunk]) for i in range(0, n, chunk)])
        return self._decode(latents)

    def _decode(self, latents):
        z = latents.permute(0, 3, 1, 2).contiguous()
        return self.vae.decode(z).permute(0, 2, 3, 1).float()

    @torch.no_grad()
    def encode_images(self, images, chunk: int = 0):
        """Images (N, H, W, 3) in [-1, 1] (a tensor or array, on any device)
        -> the VAE's latent moments (mean, logvar), each (N, h, w, 4) fp32 on
        the VAE's device, encoded ``chunk`` images at a time (0: all at
        once). GroupNorm normalizes each sample on its own, so the chunks
        give what one call would."""
        images = torch.as_tensor(images)
        dev = next(self.vae.parameters()).device
        n = images.shape[0]
        step = chunk if chunk > 0 else max(n, 1)
        means, logvars = [], []
        for i in range(0, n, step):
            x = images[i:i + step].to(dev, torch.float32).permute(0, 3, 1, 2)
            mean, logvar = self.vae.encode(x.contiguous())
            means.append(mean.permute(0, 2, 3, 1))
            logvars.append(logvar.permute(0, 2, 3, 1))
        return torch.cat(means), torch.cat(logvars)

    def rollout(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0,
                init_noise=None, step_noise=None, sampler: str = "turbo",
                shared_noise: bool = True) -> Trajectory:
        """Trajectories of ``sampler`` ("turbo" or "dmd") for ``cond``'s
        batch. Noise is drawn from ``generator`` unless given, as unit
        normals: ``init_noise`` (B, h, w, 4) and ``step_noise``, Turbo's
        (S, B, h, w, 4) step noise or DMD2's (S-1, B, h, w, 4) transition
        noise (when DMD2 draws its own, one sample is shared by the batch
        if ``shared_noise``)."""
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        b = cond["embeds"].shape[0]
        if init_noise is None:
            init_noise = torch.randn((b, self.latent_hw, self.latent_hw,
                                      self.unet.config.in_channels),
                                     generator=generator, device=self.device)
        eps_fn = lambda x, t: self.unet_eps(x, t, cond, lora_scale)
        if sampler == "dmd":
            return sample_dmd_trajectories(eps_fn, make_alphas_cumprod(),
                                           distill_timesteps(num_steps), init_noise,
                                           transition_noise=step_noise,
                                           shared_noise=shared_noise, generator=generator)
        return sample_turbo_trajectories(eps_fn, make_euler_ancestral_schedule(num_steps),
                                         init_noise, noise=step_noise, generator=generator)

    def per_sample_noise(self, generators, num_steps: int = 4):
        """DMD2 noise that depends on each sample's own generator only: from
        generator i, the init draw, then the S-1 transition draws, each
        (h, w, 4) -> (init (B, h, w, 4), transitions (S-1, B, h, w, 4)).
        A sample's images then do not depend on the batch it is in."""
        shape = (self.latent_hw, self.latent_hw, self.unet.config.in_channels)
        draws = [torch.stack([torch.randn(shape, generator=g, device=self.device)
                              for _ in range(num_steps)]) for g in generators]
        draws = torch.stack(draws, dim=1)  # (S, B, h, w, 4)
        return draws[0], draws[1:]

    @torch.no_grad()
    def generate(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0):
        """Turbo txt2img: images (B, H, W, 3) in [-1, 1]."""
        return self.decode(self.rollout(cond, generator, num_steps, lora_scale).final_latents)

    @torch.no_grad()
    def generate_dmd(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0,
                     shared_noise: bool = True, sample_generators=None, init_noise=None,
                     transition_noise=None):
        """DMD2 txt2img on the fixed lattice (4 steps: [999, 749, 499, 249]),
        guidance 0: images (B, H, W, 3) in [-1, 1]. ``sample_generators``
        (one ``torch.Generator`` on the pipeline's device per sample) make
        each sample's noise a function of its own generator only (see
        :meth:`per_sample_noise`); otherwise noise comes from ``generator``
        unless given."""
        if sample_generators is not None:
            init_noise, transition_noise = self.per_sample_noise(sample_generators, num_steps)
        traj = self.rollout(cond, generator, num_steps, lora_scale, init_noise,
                            transition_noise, sampler="dmd", shared_noise=shared_noise)
        return self.decode(traj.final_latents)

    @torch.no_grad()
    def sample_pairs(self, cond, generator=None, num_steps: int = 4, lora_scale=1.0,
                     init_noise=None, step_noise=None, timings: Optional[dict] = None,
                     sampler: str = "turbo", shared_noise: bool = True):
        """Two trajectories per prompt, decoded and scored.

        The conditioning is duplicated along the batch (trajectory 0 of
        every prompt, then trajectory 1), each trajectory with its own
        noise (``rollout`` says how ``sampler``, ``step_noise`` and
        ``shared_noise`` shape it). ``winner[i]`` is 1 when trajectory 1
        of prompt i scored at least as high as trajectory 0 (ties go to
        trajectory 1). When ``timings`` is a dict, the device is
        synchronized after each phase and its milliseconds recorded under
        ``rollout``, ``decode`` and ``score``.
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

        traj = self.rollout(pair, generator, num_steps, lora_scale, init_noise, step_noise,
                            sampler, shared_noise)
        mark("rollout")
        images = self.decode(traj.final_latents)
        mark("decode")
        txt = self.scorer.text_features(cond["reward_ids"])
        scores = self.scorer.score_with_text_features(images, torch.cat([txt, txt], dim=0))
        winner = (scores[b:] >= scores[:b]).long()
        mark("score")
        return PairSample(traj, images, scores, winner)
