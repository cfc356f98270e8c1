"""SDXL (and SD1.x) UNet2DCondition in PyTorch (NCHW, LoRA-aware attention).

Counterpart of the JAX package's ``models/unet.py``:

conv_in -> [DownBlock, CrossAttnDown(d=2), CrossAttnDown(d=10)]
        -> Mid(CrossAttn, d=10)
        -> [CrossAttnUp(d=10), CrossAttnUp(d=2), UpBlock] -> conv_out

with SDXL "text_time" micro-conditioning: the pooled text embedding and
the six sinusoidally embedded ``add_time_ids`` joined, MLP'd and added to
the timestep embedding. ``UNetConfig.sd15`` is the SD1.x family: four
levels (320, 640, 1280, 1280) with one transformer block at each of the
first three and at the mid block, 8 fixed heads (head dims 40, 80, 160),
768-wide text context and no micro-conditioning (``add_embedding`` is not
built and ``forward`` refuses the pooled embedding and time ids).
``state_dict`` keys are diffusers' ``UNet2DConditionModel`` keys (plus
``*.lora.down/up.weight`` when LoRA is on). ``lora_scale`` reaches every
attention q/k/v/out projection; the DPO
reference model is ``lora_scale=0`` on the same module.

``UNetConfig.remat`` is the JAX package's remat knob, decided per level
by :func:`remat_at` (the mid block and the up path's first stage share the
lowest level's decision). A rematerialized ResnetBlock or
SpatialTransformer runs under non-reentrant ``torch.utils.checkpoint``
while gradients are on, as ``nn.remat`` wraps it there:

- ``"full"``: every ResnetBlock and SpatialTransformer, nothing saved;
- ``"resnets"``: only the ResnetBlocks (the attention activations are kept);
- ``"dots"``: every block, saving the outputs of the weight products
  (``aten.mm`` / ``aten.addmm``: no batch dims, JAX's
  ``dots_with_no_batch_dims_saveable``) and recomputing everything else:
  batched products, convolutions, elementwise work and the attention and
  GroupNorm kernels (whose outputs are made by ``torch.empty`` and written
  through ``ctypes``, so they are never taken from a cache);
- ``"lowres"``: full remat except at the lowest-resolution level and the
  mid block, which keep everything;
- ``"lowres_dots"``: full remat at the higher levels, ``dots`` at the
  lowest level and the mid block;
- ``""`` / ``"none"``: off.

``set_param_dtype`` stores the weights in another dtype than the one the
UNet computes in (fp32 masters for full finetuning; they are cast to
``config.dtype`` at use); :func:`frozen_copy` is the separate frozen
reference that full finetuning compares against.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from .layers import (
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedMLP,
    Upsample,
    set_compute_dtype,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    # attention depth per level (0 = plain block)
    transformer_layers: Tuple[int, ...] = (0, 2, 10)
    # the mid block's attention depth; None = transformer_layers[-1] (SDXL);
    # SD1.x has an attention-free last level but an attending mid block
    mid_transformer_layers: Optional[int] = None
    layers_per_block: int = 2
    head_dim: int = 64
    # SD1.x: a fixed head count (head dim = channels / heads); None = a
    # fixed head_dim (SDXL)
    fixed_num_heads: Optional[int] = None
    cross_attention_dim: int = 2048
    # SDXL "text_time" micro-conditioning; False = SD1.x (no add_embedding)
    use_text_time: bool = True
    addition_time_embed_dim: int = 256
    pooled_embed_dim: int = 1280
    num_time_ids: int = 6
    norm_groups: int = 32
    lora_rank: int = 0
    lora_use_dora: bool = False  # DoRA on the adapted projections (peft's use_dora)
    # "" / "none" (off), "full", or a selective mode of REMAT_MODES (see remat_at)
    remat: str = ""
    dtype: torch.dtype = torch.bfloat16

    def heads_for(self, channels: int) -> Tuple[int, int]:
        """(heads, head dim) of an attention over ``channels``."""
        if self.fixed_num_heads is not None:
            return self.fixed_num_heads, channels // self.fixed_num_heads
        return channels // self.head_dim, self.head_dim

    @property
    def mid_depth(self) -> int:
        return (self.mid_transformer_layers if self.mid_transformer_layers is not None
                else self.transformer_layers[-1])

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
    def sd15(lora_rank: int = 0, dtype=torch.bfloat16, remat: str = "") -> "UNetConfig":
        """SD1.x family (the reference's legacy D3PO/DDPO pipeline path): 4
        levels, single-depth transformers, 8 fixed heads, 768 cross dim, no
        micro-conditioning (~860M params)."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280, 1280),
            transformer_layers=(1, 1, 1, 0),
            fixed_num_heads=8,
            cross_attention_dim=768,
            mid_transformer_layers=1,
            use_text_time=False,
            lora_rank=lora_rank,
            remat=remat,
            dtype=dtype,
        )

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


REMAT_MODES = ("", "none", "full", "resnets", "dots", "lowres", "lowres_dots")
# the weight products, whose outputs the "dots" policy saves
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_at(mode: str, level: int, n_levels: int) -> Tuple[bool, bool, bool]:
    """(remat the ResnetBlocks, remat the SpatialTransformers, under the dots
    policy) at ``level`` of ``n_levels`` (the mid block is the lowest
    level): the JAX package's ``_mode_at``."""
    if mode in ("", "none"):
        return False, False, False
    lowres = level == n_levels - 1
    return {"full": (True, True, False), "resnets": (True, False, False),
            "dots": (True, True, True), "lowres": (not lowres, not lowres, False),
            "lowres_dots": (True, True, lowres)}[mode]


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


class SDXLUNet(nn.Module):
    def __init__(self, config: UNetConfig, device="cuda"):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._build(config)

    def _build(self, cfg: UNetConfig):
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {cfg.remat!r}; have {REMAT_MODES}")
        self.config = cfg
        dt = cfg.dtype
        chs = cfg.block_out_channels
        n = len(chs)
        temb = cfg.time_embed_dim

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb, cfg.norm_groups, dtype=dt)

        def transformer(depth, ch):
            return SpatialTransformer(ch, depth, *cfg.heads_for(ch), cfg.cross_attention_dim,
                                      cfg.lora_rank, cfg.norm_groups, dtype=dt,
                                      use_dora=cfg.lora_use_dora)

        self.time_embedding = TimestepEmbedMLP(chs[0], temb, dtype=dt)
        if cfg.use_text_time:
            self.add_embedding = TimestepEmbedMLP(cfg.add_embed_input_dim, temb, dtype=dt)
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1, dtype=dt)

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
        if cfg.mid_depth:
            self.mid_block.attentions = nn.ModuleList([transformer(cfg.mid_depth, chs[-1])])

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
        self.conv_out = Conv2d(chs[0], cfg.out_channels, 3, padding=1, dtype=dt)

    def forward(self, sample, timesteps, encoder_hidden_states, pooled_text_embeds=None,
                add_time_ids=None, lora_scale=1.0):
        """sample (B, C, h, w) latents (already input-scaled), timesteps (B,),
        encoder_hidden_states (B, 77, cross_dim), pooled (B, pooled_dim),
        add_time_ids (B, 6) -> eps (B, C, h, w) fp32. The pooled embedding
        and the time ids are required with ``use_text_time`` and refused
        without it (SD1.x)."""
        cfg = self.config
        dt = cfg.dtype
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        given = (pooled_text_embeds is not None, add_time_ids is not None)
        if cfg.use_text_time:
            if not all(given):
                raise ValueError("text_time conditioning needs pooled_text_embeds and "
                                 "add_time_ids")
            ids_emb = timestep_embedding(add_time_ids.reshape(-1), cfg.addition_time_embed_dim)
            ids_emb = ids_emb.reshape(add_time_ids.shape[0], -1)
            add = torch.cat([pooled_text_embeds.float(), ids_emb], dim=-1)
            temb = temb + self.add_embedding(add.to(dt))
        elif any(given):
            raise ValueError("this UNet has no text_time conditioning (use_text_time=False): "
                             "pass no pooled_text_embeds or add_time_ids")
        context = encoder_hidden_states.to(dt)

        n = len(cfg.block_out_channels)
        grad = torch.is_grad_enabled()

        def run(block, level, *args):
            r_res, r_attn, dots = remat_at(cfg.remat, level, n)
            if not grad or not (r_attn if isinstance(block, SpatialTransformer) else r_res):
                return block(*args)
            kw = {"context_fn": _DOTS_CONTEXT} if dots else {}
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, **kw)

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for level, blk in enumerate(self.down_blocks):
            for i, res in enumerate(blk.resnets):
                h = run(res, level, h, temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[i], level, h, context, lora_scale)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = run(self.mid_block.resnets[0], n - 1, h, temb)
        if hasattr(self.mid_block, "attentions"):
            h = run(self.mid_block.attentions[0], n - 1, h, context, lora_scale)
        h = run(self.mid_block.resnets[1], n - 1, h, temb)

        for rev, blk in enumerate(self.up_blocks):
            for i, res in enumerate(blk.resnets):
                h = run(res, n - 1 - rev, torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = run(blk.attentions[i], n - 1 - rev, h, context, lora_scale)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = self.conv_out(self.conv_norm_out(h))
        return h.float()

    def set_param_dtype(self, dtype: torch.dtype) -> "SDXLUNet":
        """Store every weight but the LoRA adapter's in ``dtype``, computing
        in ``config.dtype`` all the same: a weight in another dtype is cast
        at use."""
        for name, p in self.named_parameters():
            if ".lora." not in name and p.dtype != dtype:
                p.data = p.data.to(dtype)
        return set_compute_dtype(self, self.config.dtype)


@torch.no_grad()
def frozen_copy(unet: SDXLUNet) -> SDXLUNet:
    """A separate copy of ``unet``'s weights in its compute dtype, without
    LoRA and without gradients: full finetuning's frozen reference, equal to
    the trained UNet at step 0 (a weight cast at use gives what the copy
    stores)."""
    cfg = dataclasses.replace(unet.config, lora_rank=0, remat="")
    ref = SDXLUNet(cfg, device="meta").to_empty(device=unet.conv_in.weight.device)
    ref.load_state_dict({k: v for k, v in unet.state_dict().items() if ".lora." not in k})
    return ref.requires_grad_(False).eval()
