"""Shared building blocks of the SDXL UNet, the VAE and the CLIP towers.

PyTorch counterparts of the JAX package's ``models/layers.py``, in NCHW,
with diffusers ``state_dict`` keys. Attention goes through
``ops.attention`` and GroupNorm(+SiLU) through ``ops.group_norm``, the
seams that reach the CUDA kernels.

LoRA stays apart from the frozen weights: ``LoRALinear`` is an
``nn.Linear`` (frozen ``weight``/``bias``) with an fp32 adapter under
``lora.down``/``lora.up`` (diffusers LoRA key layout). The frozen
reference model of LoRA training is ``lora_scale=0`` on the same module,
never a copy.

Tensor parallelism (``parallel/tp.py``) slices a ``Linear`` /
``LoRALinear`` and sets its ``tp_mode``: ``"col"`` (the layer holds some
output features) or ``"row"`` (it holds some input features: its partial
output is summed over the model group by ``reduce_from_group``, then the
bias is added once). The ``Attention`` or ``GEGLUFeedForward`` around them
gets ``tp_mode`` ``"in"``: its input (and the attention's context) passes
``copy_to_group`` once, for all the column layers and LoRA ``down``
products that read it (Megatron's ``f``). None (the default) is the plain
module.

The weighted layers (``Linear``, ``Conv2d``, ``LayerNorm``, ``GroupNorm``,
``LoRALinear``) compute in their ``compute_dtype`` whatever dtype their
weights are stored in: a weight stored in another dtype is cast at use, as
the JAX package casts its fp32 params to the compute dtype. It is None (the
weights' own dtype) until ``set_compute_dtype`` sets it, as a UNet whose
trained weights are fp32 masters needs.

Dynamic int8 (``ops/qconv.py``) reaches the layers the JAX package routes:
inside the ``int8_ref_pass`` scope, ``LoRALinear``'s base product (its bias
added afterwards in the compute dtype), ``MaybeInt8Linear``'s product (the
transformer's ``proj_in`` / ``proj_out`` and the GEGLU feed-forward's two
projections; the bias added in fp32 before the cast) and the 3x3 convs of
``ResnetBlock`` and ``Upsample``; under the int8 decode knob, those convs
where ``allow_int8`` is set (the VAE decoder's). The weights are quantized
from their compute-dtype copy. ``Int8Linear`` (JAX ``Int8Dense``) is the
CLIP vision MLP's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.group_norm import group_norm
from ..ops.qconv import decoder_conv2d, in_int8_ref_pass, int8_matmul
from ..ops.upsample import upsample2x_conv3x3
from ..parallel.collectives import copy_to_group, reduce_from_group


_GELU_FORCE_EXACT = False


def set_gelu_exact(force: bool) -> None:
    """Force the exact erf GELU in every dtype, process-wide (the
    ``kernels.gelu_exact`` config knob and the eval's ``--gelu_exact``;
    the JAX package's ``set_gelu_exact``). Runs set it when they start."""
    global _GELU_FORCE_EXACT
    _GELU_FORCE_EXACT = bool(force)


def gelu_approximate(dtype: torch.dtype) -> str:
    """GELU flavor by compute dtype, the JAX package's rule: exact erf in
    fp32, the tanh approximation in bf16, unless :func:`set_gelu_exact`
    forces erf."""
    return "tanh" if dtype == torch.bfloat16 and not _GELU_FORCE_EXACT else "none"


def at_use(t, dtype):
    """``t`` in ``dtype`` (None: as stored), cast only where it differs."""
    return t if t is None or dtype is None or t.dtype == dtype else t.to(dtype)


class CastAtUse:
    """A weighted layer whose ``weight`` and ``bias`` are cast to
    ``compute_dtype`` at use (None: used as stored)."""

    compute_dtype = None

    def weights_at_use(self):
        return at_use(self.weight, self.compute_dtype), at_use(self.bias, self.compute_dtype)


class TensorParallel:
    """A module's tensor-parallel mode (see the module docstring)."""

    tp_mode = None  # None | "in" | "col" | "row"
    tp_group = None

    def tp_input(self, x):
        """Megatron's ``f`` on the input of an "in" module (None passes)."""
        return copy_to_group(x, self.tp_group) if self.tp_mode == "in" and x is not None else x

    def tp_output(self, y, bias, dtype=None):
        """The row layer's sum over the model group (cast to ``dtype`` where
        given), then its bias."""
        y = reduce_from_group(y, self.tp_group)
        y = y if dtype is None else y.to(dtype)
        return y if bias is None else y + bias

    def int8_product(self, x, w):
        """x @ w^T in dynamic int8 without a bias: in x's dtype, or, in a
        row layer, this rank's fp32 partial on the model group's grids."""
        row = self.tp_mode == "row"
        return int8_matmul(x, w, group=self.tp_group if row else None,
                           out_dtype=torch.float32 if row else None,
                           what=f"{type(self).__name__}({w.shape[1]}, {w.shape[0]})")


class Linear(TensorParallel, CastAtUse, nn.Linear):
    def forward(self, x):
        w, b = self.weights_at_use()
        if self.tp_mode == "row":
            return self.tp_output(F.linear(x, w), b)
        return F.linear(x, w, b)


class MaybeInt8Linear(Linear):
    """A ``Linear`` (the same keys) whose product runs in dynamic int8 inside
    the ``int8_ref_pass`` scope, the bias added in fp32 before the cast:
    JAX ``DenseMaybeInt8``."""

    def forward(self, x):
        if not in_int8_ref_pass():
            return super().forward(x)
        w, b = self.weights_at_use()
        x = x.to(w.dtype)
        if self.tp_mode == "row":  # the partials summed in fp32, then the bias
            b = None if b is None else b.float()
            return self.tp_output(self.int8_product(x, w), b).to(w.dtype)
        return int8_matmul(x, w, b, what=f"MaybeInt8Linear({self.in_features}, "
                                          f"{self.out_features})")


class Int8Linear(nn.Linear):
    """An ``nn.Linear`` (the same keys) whose product is always the dynamic
    int8 matmul, the bias added in fp32 before the cast (JAX ``Int8Dense``);
    ``forward(x, int8=False)`` takes the plain product instead."""

    def forward(self, x, int8: bool = True):
        if not int8:
            return super().forward(x)
        return int8_matmul(x.to(self.weight.dtype), self.weight, self.bias,
                           what=f"Int8Linear({self.in_features}, {self.out_features})")


class Conv2d(CastAtUse, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, *self.weights_at_use())


class MaybeInt8Conv2d(Conv2d):
    """A 3x3, stride-1, pad-1 ``Conv2d`` through ``qconv.decoder_conv2d``:
    in dynamic int8 inside the ``int8_ref_pass`` scope, or under the int8
    decode knob where ``allow_int8`` is set (the VAE decoder's resnets)."""

    allow_int8 = False

    def forward(self, x):
        return decoder_conv2d(x, *self.weights_at_use(), allow_int8=self.allow_int8)


class LayerNorm(CastAtUse, nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, *self.weights_at_use(), self.eps)


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Every weighted layer of ``module`` computes in ``dtype`` from now on,
    whatever dtype its weights are stored in."""
    for m in module.modules():
        if isinstance(m, CastAtUse):
            m.compute_dtype = dtype
    return module


class _LoRAPair(nn.Module):
    def __init__(self, in_features: int, out_features: int, rank: int, dtype,
                 use_dora: bool = False):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False, dtype=dtype)
        self.up = nn.Linear(rank, out_features, bias=False, dtype=dtype)
        if use_dora:
            self.magnitude = nn.Parameter(torch.ones(out_features, dtype=dtype))


class LoRALinear(TensorParallel, CastAtUse, nn.Linear):
    """y = x W^T + b + lora_scale * (alpha / r) * (x A) B.

    ``lora_scale`` is a Python number or a per-sample (B,) tensor; a static
    Python 0 skips the adapter (the frozen-reference pass does no dead
    work). A starts gaussian with std 1/r and B at zero (peft's
    ``init_lora_weights='gaussian'``).

    ``use_dora`` (weight-decomposed LoRA, peft's ``use_dora``): a trainable
    fp32 per-output magnitude ``lora.magnitude`` (created as the row norms
    of W) rescales the merged weight to unit row norms,
    y = (x W^T + s x (A B)) * m / ||W + s (A B)^T||_row + b with
    s = lora_scale * alpha / r, the norm in fp32 and detached (peft's
    semantics). It needs a scalar ``lora_scale``; a static 0 skips the
    magnitude too.
    """

    def __init__(self, in_features, out_features, bias=True, lora_rank=0, lora_alpha=None,
                 dtype=None, lora_dtype=torch.float32, use_dora=False):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype)
        self.lora_rank = lora_rank
        self.use_dora = bool(use_dora and lora_rank)
        if lora_rank:
            alpha = lora_alpha if lora_alpha is not None else lora_rank
            self.lora_scaling = alpha / lora_rank
            self.lora = _LoRAPair(in_features, out_features, lora_rank, lora_dtype, self.use_dora)
            nn.init.normal_(self.lora.down.weight, std=1.0 / lora_rank)
            nn.init.zeros_(self.lora.up.weight)
            self.refresh_dora_magnitude_()

    @torch.no_grad()
    def refresh_dora_magnitude_(self):
        """Set the DoRA magnitude to the row norms of the frozen weight W
        it holds now (a no-op without DoRA)."""
        if self.use_dora:
            self.lora.magnitude.copy_(torch.linalg.vector_norm(self.weight.float(), dim=1))

    def forward(self, x, lora_scale=1.0):
        x = x.to(self.compute_dtype or self.weight.dtype)
        w, b = self.weights_at_use()
        row = self.tp_mode == "row"  # the bias goes on after the sum
        if in_int8_ref_pass():  # the base product alone in int8, the bias in the compute dtype
            y = self.int8_product(x, w)
            if b is not None and not row:
                y = y + b
        else:
            y = F.linear(x, w, None if row else b)
        static_zero = isinstance(lora_scale, (int, float)) and lora_scale == 0
        if self.lora_rank and not static_zero:
            per_sample = isinstance(lora_scale, torch.Tensor) and lora_scale.ndim >= 1
            if self.use_dora and per_sample:
                raise ValueError("use_dora needs a scalar lora_scale (the magnitude "
                                 "normalization acts on the weight; a per-sample scale "
                                 "cannot express it)")
            delta = F.linear(F.linear(x, self.lora.down.weight.to(x.dtype)),
                             self.lora.up.weight.to(x.dtype))
            y = self._dora(y, delta, lora_scale) if self.use_dora else y + self._scaled(
                delta, lora_scale)
        return self.tp_output(y, b, x.dtype) if row else y

    def _scaled(self, delta, lora_scale):
        if isinstance(lora_scale, torch.Tensor) and lora_scale.ndim >= 1:  # per sample
            lora_scale = lora_scale.to(delta.dtype).reshape(
                lora_scale.shape + (1,) * (delta.ndim - lora_scale.ndim))
        return delta * (lora_scale * self.lora_scaling)

    def _dora(self, y, delta, lora_scale):
        scale = lora_scale * self.lora_scaling
        with torch.no_grad():
            up, down = self.lora.up.weight.float(), self.lora.down.weight.float()
            if isinstance(scale, torch.Tensor):
                merged = self.weight.float() + scale.float() * (up @ down)
            else:
                merged = torch.addmm(self.weight.float(), up, down, alpha=float(scale))
            row_norm = torch.linalg.vector_norm(merged, dim=1).clamp_min(1e-9)
        # y = x W^T + b: the magnitude scales x W'^T only (the bias is taken
        # off and put back in the compute dtype, as the JAX layer does)
        base = y - self.bias.to(y.dtype) if self.bias is not None else y
        out = (base + delta * scale) * (self.lora.magnitude.float() / row_norm).to(y.dtype)
        return out + self.bias.to(out.dtype) if self.bias is not None else out


@torch.no_grad()
def refresh_dora_magnitudes_(module: nn.Module) -> nn.Module:
    """Every DoRA magnitude in ``module`` set to its frozen weight's row
    norms: after new base weights are in, the adapter is a no-op again."""
    for m in module.modules():
        if isinstance(m, LoRALinear):
            m.refresh_dora_magnitude_()
    return module


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal embeddings, diffusers convention (B,) -> (B, dim) fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedMLP(nn.Module):
    """Two-layer SiLU MLP lifting sinusoidal embeddings to the time channel."""

    def __init__(self, in_dim: int, out_dim: int, dtype=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim, dtype=dtype)
        self.linear_2 = Linear(out_dim, out_dim, dtype=dtype)

    def forward(self, x):
        l1 = self.linear_1
        return self.linear_2(F.silu(l1(x.to(l1.compute_dtype or l1.weight.dtype))))


class GroupNorm(CastAtUse, nn.Module):
    """Parameterized NCHW group norm dispatching through ops.group_norm."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5, act=None,
                 dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=dtype))

    def forward(self, x):
        return group_norm(x, *self.weights_at_use(), self.num_groups, self.eps, act=self.act)


class Attention(TensorParallel, nn.Module):
    """Self/cross attention with LoRA-able q/k/v/out projections.

    Input (B, S, C); optional context (B, S_kv, C_ctx) for cross attention.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int, context_dim=None,
                 lora_rank: int = 0, dtype=None, use_dora: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        kv_dim = context_dim or query_dim
        lin = lambda i, o, bias: LoRALinear(i, o, bias=bias, lora_rank=lora_rank, dtype=dtype,
                                            use_dora=use_dora)
        self.to_q = lin(query_dim, inner, False)
        self.to_k = lin(kv_dim, inner, False)
        self.to_v = lin(kv_dim, inner, False)
        self.to_out = nn.ModuleList([lin(inner, query_dim, True)])

    def forward(self, x, context=None, lora_scale=1.0):
        x, context = self.tp_input(x), self.tp_input(context)
        kv = x if context is None else context
        b, sq, sk = x.shape[0], x.shape[1], kv.shape[1]
        q = self.to_q(x, lora_scale).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(kv, lora_scale).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(kv, lora_scale).view(b, sk, self.heads, self.head_dim)
        o = dot_product_attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](o, lora_scale)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype=None):
        super().__init__()
        self.proj = MaybeInt8Linear(dim, inner * 2, dtype=dtype)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate=gelu_approximate(gate.dtype))


class GEGLUFeedForward(TensorParallel, nn.Module):
    """Transformer FF with a GEGLU gate (diffusers ``ff.net`` layout)."""

    def __init__(self, dim: int, mult: int = 4, dtype=None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner, dtype), nn.Dropout(0.0),
                                  MaybeInt8Linear(inner, dim, dtype=dtype)])

    def forward(self, x):
        x = self.tp_input(x)
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attn -> cross-attn -> GEGLU FF block (LayerNorm eps 1e-5)."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 lora_rank: int = 0, dtype=None, use_dora: bool = False):
        super().__init__()
        ln = lambda: LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.norm1 = ln()
        self.attn1 = Attention(dim, heads, head_dim, lora_rank=lora_rank, dtype=dtype,
                               use_dora=use_dora)
        self.norm2 = ln()
        self.attn2 = Attention(dim, heads, head_dim, context_dim, lora_rank=lora_rank,
                               dtype=dtype, use_dora=use_dora)
        self.norm3 = ln()
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x, context, lora_scale=1.0):
        x = x + self.attn1(self.norm1(x), lora_scale=lora_scale)
        x = x + self.attn2(self.norm2(x), context=context, lora_scale=lora_scale)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm(eps 1e-6) -> linear proj -> N transformer blocks -> linear
    proj, residual (diffusers Transformer2DModel, use_linear_projection)."""

    def __init__(self, channels: int, depth: int, heads: int, head_dim: int, context_dim: int,
                 lora_rank: int = 0, groups: int = 32, dtype=None, use_dora: bool = False):
        super().__init__()
        self.norm = GroupNorm(channels, groups, eps=1e-6, dtype=dtype)
        self.proj_in = MaybeInt8Linear(channels, channels, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim, lora_rank, dtype,
                                  use_dora)
            for _ in range(depth)
        ])
        self.proj_out = MaybeInt8Linear(channels, channels, dtype=dtype)

    def forward(self, x, context, lora_scale=1.0):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context, lora_scale)
        x = self.proj_out(x)
        # contiguous NCHW (the transposed view would carry a channels-last
        # layout into the next GroupNorm+SiLU kernel, which does not take it)
        return x.transpose(1, 2).contiguous().view(b, c, h, w) + residual


class ResnetBlock(nn.Module):
    """GN+SiLU -> conv -> (+time) -> GN+SiLU -> conv, with a 1x1 skip. The
    two 3x3 convs may run in int8 (``MaybeInt8Conv2d``; ``allow_int8``: under
    the int8 decode knob too)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels=None,
                 groups: int = 32, eps: float = 1e-5, dtype=None, allow_int8: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu", dtype=dtype)
        self.conv1 = MaybeInt8Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.time_emb_proj = (Linear(temb_channels, out_channels, dtype=dtype)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu", dtype=dtype)
        self.conv2 = MaybeInt8Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv1.allow_int8 = self.conv2.allow_int8 = allow_int8
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv (diffusers Downsample2D). The UNet pads by one on
    every side; the VAE encoder (``asymmetric=True``) pads only the bottom
    and right by one (diffusers' ``padding=0`` and ``F.pad(x, (0, 1, 0, 1))``)."""

    def __init__(self, channels: int, dtype=None, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric else 1,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample(nn.Module):
    """Nearest-2x upsample + 3x3 conv (diffusers Upsample2D), through
    ``ops.upsample`` (the subpixel rewrite, or int8 on the naive path:
    ``allow_int8`` as ``ResnetBlock``'s)."""

    def __init__(self, channels: int, dtype=None, allow_int8: bool = False):
        super().__init__()
        self.allow_int8 = allow_int8
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return upsample2x_conv3x3(x, *self.conv.weights_at_use(), allow_int8=self.allow_int8)


@torch.no_grad()
def init_zeros_(module: nn.Module) -> nn.Module:
    """Every parameter of ``module`` zero, its LoRA too: ``fast_init``'s
    towers for benches and compile checks, where the values do not matter
    (the JAX package's zero fill)."""
    for p in module.parameters():
        p.zero_()
    return module


def init_weights_(module: nn.Module, generator: torch.Generator, fast_init: bool = False,
                  **kw) -> nn.Module:
    """:func:`init_zeros_` under ``fast_init``, else :func:`init_random_`."""
    if fast_init:
        return init_zeros_(module)
    init_random_(module, generator, **kw)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator, lora_b_std: float = 0.0):
    """Random weights drawn on the module's own device from ``generator``.

    Linear and conv weights are uniform in +-1/sqrt(fan_in) (PyTorch's
    default bound) with zero biases, norms are identity, embeddings are
    gaussian with std 0.02. Those keep full-depth bf16 activations finite.
    LoRA ``down`` is gaussian with std 1/r; ``up`` is gaussian with std
    ``lora_b_std`` (0 leaves the adapter a no-op, as a fresh peft adapter);
    DoRA magnitudes are the drawn weights' row norms.
    A module with other parameters initializes them in ``init_extra_``.
    """
    adapters = set()
    for m in module.modules():
        if isinstance(m, _LoRAPair):
            adapters.update((id(m.down), id(m.up)))
            m.down.weight.normal_(0.0, 1.0 / m.down.weight.shape[0], generator=generator)
            if lora_b_std:
                m.up.weight.normal_(0.0, lora_b_std, generator=generator)
            else:
                m.up.weight.zero_()
    for m in module.modules():
        if id(m) in adapters:
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        if hasattr(m, "init_extra_"):
            m.init_extra_(generator)
    refresh_dora_magnitudes_(module)
