"""SDXL UNet2DCondition in PyTorch (NCHW, LoRA-aware attention).

Counterpart of the JAX package's ``models/unet.py``:

conv_in -> [DownBlock, CrossAttnDown(d=2), CrossAttnDown(d=10)]
        -> Mid(CrossAttn, d=10)
        -> [CrossAttnUp(d=10), CrossAttnUp(d=2), UpBlock] -> conv_out

with SDXL "text_time" micro-conditioning: the pooled text embedding and
the six sinusoidally embedded ``add_time_ids`` joined, MLP'd and added to
the timestep embedding. ``state_dict`` keys are diffusers'
``UNet2DConditionModel`` keys (plus ``*.lora.down/up.weight`` when LoRA is
on). ``lora_scale`` reaches every attention q/k/v/out projection; the DPO
reference model is ``lora_scale=0`` on the same module.

``UNetConfig.remat`` is the JAX package's remat knob: ``"full"`` wraps
every ResnetBlock and SpatialTransformer in ``torch.utils.checkpoint``
(non-reentrant) while gradients are on, as ``nn.remat`` wraps them there;
``""`` / ``"none"`` turns it off. The selective modes are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .layers import (
    Downsample,
    GroupNorm,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedMLP,
    Upsample,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    # attention depth per level (0 = plain block); the mid block takes the last
    transformer_layers: Tuple[int, ...] = (0, 2, 10)
    layers_per_block: int = 2
    head_dim: int = 64
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    pooled_embed_dim: int = 1280
    num_time_ids: int = 6
    norm_groups: int = 32
    lora_rank: int = 0
    # "full": checkpoint every ResnetBlock and SpatialTransformer; "" / "none": off
    remat: str = ""
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def add_embed_input_dim(self) -> int:
        return self.pooled_embed_dim + self.num_time_ids * self.addition_time_embed_dim

    @staticmethod
    def sdxl(lora_rank: int = 0, dtype=torch.bfloat16, remat: str = "") -> "UNetConfig":
        """Full SDXL (Turbo / DMD2 share this architecture; 2.6B params)."""
        return UNetConfig(lora_rank=lora_rank, remat=remat, dtype=dtype)

    @staticmethod
    def tiny(lora_rank: int = 0, dtype=torch.float32, remat: str = "") -> "UNetConfig":
        """2-level toy config for CPU tests."""
        return UNetConfig(
            block_out_channels=(32, 64),
            transformer_layers=(0, 1),
            layers_per_block=1,
            head_dim=8,
            cross_attention_dim=32,
            addition_time_embed_dim=8,
            pooled_embed_dim=16,
            norm_groups=8,
            lora_rank=lora_rank,
            remat=remat,
            dtype=dtype,
        )


SELECTIVE_REMAT_MODES = ("resnets", "dots", "lowres", "lowres_dots")


class SDXLUNet(nn.Module):
    def __init__(self, config: UNetConfig, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._build(config)

    def _build(self, cfg: UNetConfig):
        if cfg.remat in SELECTIVE_REMAT_MODES:
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported; use 'full' or ''")
        if cfg.remat not in ("", "none", "full"):
            raise ValueError(f"unknown remat mode {cfg.remat!r}")
        self.config = cfg
        dt = cfg.dtype
        chs = cfg.block_out_channels
        n = len(chs)
        temb = cfg.time_embed_dim

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb, cfg.norm_groups, dtype=dt)

        def transformer(depth, ch):
            return SpatialTransformer(ch, depth, ch // cfg.head_dim, cfg.head_dim,
                                      cfg.cross_attention_dim, cfg.lora_rank,
                                      cfg.norm_groups, dtype=dt)

        self.time_embedding = TimestepEmbedMLP(chs[0], temb, dtype=dt)
        self.add_embedding = TimestepEmbedMLP(cfg.add_embed_input_dim, temb, dtype=dt)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1, dtype=dt)

        skip_chs = [chs[0]]
        h_ch = chs[0]
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chs):
            blk = nn.Module()  # a diffusers block: resnets, attentions, down/upsamplers
            blk.resnets = nn.ModuleList()
            depth = cfg.transformer_layers[level]
            if depth:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(resnet(h_ch, ch))
                h_ch = ch
                if depth:
                    blk.attentions.append(transformer(depth, ch))
                skip_chs.append(ch)
            if level < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, dtype=dt)])
                skip_chs.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([resnet(chs[-1], chs[-1]), resnet(chs[-1], chs[-1])])
        self.mid_block.attentions = nn.ModuleList([transformer(cfg.transformer_layers[-1], chs[-1])])

        self.up_blocks = nn.ModuleList()
        for rev, ch in enumerate(reversed(chs)):
            level = n - 1 - rev
            depth = cfg.transformer_layers[level]
            blk = nn.Module()  # a diffusers block: resnets, attentions, down/upsamplers
            blk.resnets = nn.ModuleList()
            if depth:
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(h_ch + skip_chs.pop(), ch))
                h_ch = ch
                if depth:
                    blk.attentions.append(transformer(depth, ch))
            if level > 0:
                blk.upsamplers = nn.ModuleList([Upsample(ch, dtype=dt)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(chs[0], cfg.norm_groups, act="silu", dtype=dt)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1, dtype=dt)

    def forward(self, sample, timesteps, encoder_hidden_states, pooled_text_embeds,
                add_time_ids, lora_scale=1.0):
        """sample (B, C, h, w) latents (already input-scaled), timesteps (B,),
        encoder_hidden_states (B, 77, cross_dim), pooled (B, pooled_dim),
        add_time_ids (B, 6) -> eps (B, C, h, w) fp32."""
        cfg = self.config
        dt = cfg.dtype
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        ids_emb = timestep_embedding(add_time_ids.reshape(-1), cfg.addition_time_embed_dim)
        ids_emb = ids_emb.reshape(add_time_ids.shape[0], -1)
        add = torch.cat([pooled_text_embeds.float(), ids_emb], dim=-1)
        temb = temb + self.add_embedding(add.to(dt))
        context = encoder_hidden_states.to(dt)

        remat = cfg.remat == "full" and torch.is_grad_enabled()

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
            return block(*args)

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for blk in self.down_blocks:
            for i, res in enumerate(blk.resnets):
                h = run(res, h, temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[i], h, context, lora_scale)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = run(self.mid_block.resnets[0], h, temb)
        h = run(self.mid_block.attentions[0], h, context, lora_scale)
        h = run(self.mid_block.resnets[1], h, temb)

        for blk in self.up_blocks:
            for i, res in enumerate(blk.resnets):
                h = run(res, torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[i], h, context, lora_scale)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = self.conv_out(self.conv_norm_out(h))
        return h.float()
