"""Composite-block port-fidelity anchors: flax UNet/VAE blocks vs an
independent torch (NCHW) transcription of diffusers' block semantics.

The tower-level CLIP anchors (test_torch_parity.py) pin the text/reward
path against real ``transformers`` models; diffusers itself is not
installed here, so the UNet/VAE side is anchored by re-expressing each
diffusers block's documented forward (``ResnetBlock2D``,
``Transformer2DModel`` with use_linear_projection, ``Attention`` of the
VAE mid block, ``Upsample2D``/``Downsample2D``, the full VAE
``Decoder``/``Encoder``) as plain ``torch.nn.functional`` code over a
state dict exported by ``flax_to_torch`` — the exact dict a diffusers
checkpoint load would consume (reference loads these modules via
``from_pretrained``, ``train_online_pso_sdxl_turbo.py:242-294``).

Torch forward code here is written from the diffusers architecture
definition (NCHW, torch GroupNorm/LayerNorm/SDPA) — an independent code
path from the NHWC flax modules, so a transposed kernel, wrong eps,
wrong GELU flavor, or wrong padding shows up as a numeric mismatch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ATOL, RTOL = 3e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread for the module: the suite runs several
    workers on one host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x)


def _t(sd, key):
    return torch.from_numpy(np.asarray(sd[key]))


def _nchw(x_nhwc):
    return torch.from_numpy(_np(x_nhwc).transpose(0, 3, 1, 2))


def _assert_close(got_nhwc, want_nchw):
    np.testing.assert_allclose(
        _np(got_nhwc).transpose(0, 3, 1, 2), want_nchw.numpy(), atol=ATOL, rtol=RTOL
    )


# ------------------------------------------------------------------ #
# torch functional transcriptions of the diffusers blocks
# ------------------------------------------------------------------ #


def t_gn(x, sd, p, groups, eps):
    return F.group_norm(x, groups, _t(sd, p + ".weight"), _t(sd, p + ".bias"), eps)


def t_conv(x, sd, p, stride=1, padding=1):
    return F.conv2d(
        x, _t(sd, p + ".weight"), _t(sd, p + ".bias"), stride=stride, padding=padding
    )


def t_linear(x, sd, p):
    bias = _t(sd, p + ".bias") if p + ".bias" in sd else None
    return F.linear(x, _t(sd, p + ".weight"), bias)


def t_resnet(x, sd, p, groups, eps, temb=None):
    """diffusers ResnetBlock2D (default time_embedding_norm, silu)."""
    h = F.silu(t_gn(x, sd, p + ".norm1", groups, eps))
    h = t_conv(h, sd, p + ".conv1")
    if temb is not None and p + ".time_emb_proj.weight" in sd:
        h = h + t_linear(F.silu(temb), sd, p + ".time_emb_proj")[:, :, None, None]
    h = F.silu(t_gn(h, sd, p + ".norm2", groups, eps))
    h = t_conv(h, sd, p + ".conv2")
    if p + ".conv_shortcut.weight" in sd:
        x = t_conv(x, sd, p + ".conv_shortcut", padding=0)
    return x + h


def t_vae_attention(x, sd, p, groups):
    """diffusers VAE mid-block Attention: single head, dim_head=C,
    residual connection, GroupNorm eps 1e-6."""
    r = x
    b, c, hh, ww = x.shape
    h = t_gn(x, sd, p + ".group_norm", groups, 1e-6)
    h = h.view(b, c, hh * ww).transpose(1, 2)  # (b, hw, c)
    q = t_linear(h, sd, p + ".to_q")[:, None]  # (b, 1, hw, c)
    k = t_linear(h, sd, p + ".to_k")[:, None]
    v = t_linear(h, sd, p + ".to_v")[:, None]
    o = F.scaled_dot_product_attention(q, k, v)[:, 0]
    o = t_linear(o, sd, p + ".to_out.0")
    return o.transpose(1, 2).view(b, c, hh, ww) + r


def t_mha(x, ctx, sd, p, heads):
    """diffusers Attention (transformer blocks): no qkv bias, to_out.0."""
    b, s, c = x.shape
    d = c // heads
    split = lambda t: t.view(b, -1, heads, d).transpose(1, 2)
    q = split(t_linear(x, sd, p + ".to_q"))
    k = split(t_linear(ctx, sd, p + ".to_k"))
    v = split(t_linear(ctx, sd, p + ".to_v"))
    o = F.scaled_dot_product_attention(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, c)
    return t_linear(o, sd, p + ".to_out.0")


def t_ln(x, sd, p, eps=1e-5):
    return F.layer_norm(
        x, (x.shape[-1],), _t(sd, p + ".weight"), _t(sd, p + ".bias"), eps
    )


def t_transformer_block(x, ctx, sd, p, heads):
    """diffusers BasicTransformerBlock: LN(eps 1e-5) pre-norm, self attn,
    cross attn, GEGLU ff with EXACT gelu (F.gelu default)."""
    x = x + t_mha(t_ln(x, sd, p + ".norm1"), t_ln(x, sd, p + ".norm1"), sd, p + ".attn1", heads)
    x = x + t_mha(t_ln(x, sd, p + ".norm2"), ctx, sd, p + ".attn2", heads)
    h = t_linear(t_ln(x, sd, p + ".norm3"), sd, p + ".ff.net.0.proj")
    a, gate = h.chunk(2, dim=-1)
    h = a * F.gelu(gate)
    return x + t_linear(h, sd, p + ".ff.net.2")


def t_spatial_transformer(x, ctx, sd, p, heads, depth, groups):
    """diffusers Transformer2DModel with use_linear_projection=True."""
    b, c, hh, ww = x.shape
    r = x
    h = t_gn(x, sd, p + ".norm", groups, 1e-6)
    h = h.view(b, c, hh * ww).transpose(1, 2)
    h = t_linear(h, sd, p + ".proj_in")
    for i in range(depth):
        h = t_transformer_block(h, ctx, sd, f"{p}.transformer_blocks.{i}", heads)
    h = t_linear(h, sd, p + ".proj_out")
    return h.transpose(1, 2).view(b, c, hh, ww) + r


def t_upsample(x, sd, p):
    """diffusers Upsample2D: nearest-2x interpolate + 3x3 conv."""
    return t_conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), sd, p + ".conv")


def t_vae_decoder(z, sd, groups, layers_per_block, n_levels):
    h = t_conv(z, sd, "decoder.conv_in")
    h = t_resnet(h, sd, "decoder.mid_block.resnets.0", groups, 1e-6)
    h = t_vae_attention(h, sd, "decoder.mid_block.attentions.0", groups)
    h = t_resnet(h, sd, "decoder.mid_block.resnets.1", groups, 1e-6)
    for level in range(n_levels):
        for i in range(layers_per_block + 1):
            h = t_resnet(h, sd, f"decoder.up_blocks.{level}.resnets.{i}", groups, 1e-6)
        if level < n_levels - 1:
            h = t_upsample(h, sd, f"decoder.up_blocks.{level}.upsamplers.0")
    h = F.silu(t_gn(h, sd, "decoder.conv_norm_out", groups, 1e-6))
    return t_conv(h, sd, "decoder.conv_out")


def t_vae_encoder(x, sd, groups, layers_per_block, n_levels):
    h = t_conv(x, sd, "encoder.conv_in")
    for level in range(n_levels):
        for i in range(layers_per_block):
            h = t_resnet(h, sd, f"encoder.down_blocks.{level}.resnets.{i}", groups, 1e-6)
        if level < n_levels - 1:
            # VAE Encoder builds Downsample2D with downsample_padding=0:
            # asymmetric (0,1,0,1) pad then stride-2 VALID conv
            h = F.pad(h, (0, 1, 0, 1))
            h = t_conv(
                h, sd, f"encoder.down_blocks.{level}.downsamplers.0.conv",
                stride=2, padding=0,
            )
    h = t_resnet(h, sd, "encoder.mid_block.resnets.0", groups, 1e-6)
    h = t_vae_attention(h, sd, "encoder.mid_block.attentions.0", groups)
    h = t_resnet(h, sd, "encoder.mid_block.resnets.1", groups, 1e-6)
    h = F.silu(t_gn(h, sd, "encoder.conv_norm_out", groups, 1e-6))
    return t_conv(h, sd, "encoder.conv_out")


# ------------------------------------------------------------------ #
# tests
# ------------------------------------------------------------------ #


def _export(module_cls, name, param_map, init_args, **module_kwargs):
    """Init a flax block wrapped under the map's expected module name and
    export its params to a diffusers-layout torch state dict."""
    from pairwise_sample_optimization_tpu.checkpoints import flax_to_torch

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, *args):
            return module_cls(**module_kwargs, name=name)(*args)

    wrap = Wrap()
    variables = wrap.init(jax.random.key(0), *init_args)
    sd = flax_to_torch(variables["params"], param_map)
    return wrap, variables, sd


def _randomize(variables, key):
    """Gaussian-fill every param (flax zero-init biases / ones-init norms
    would mask transpose or wiring errors)."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(key, len(leaves))
    new = [
        0.2 * jax.random.normal(k, l.shape, l.dtype) + (0.9 if l.ndim == 1 else 0.0)
        for k, l in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, new)


def _random_variables(init, *init_args, seed=3):
    """``_randomize(init(*init_args), key(seed))`` without running the init:
    the tree from ``jax.eval_shape``, filled in one jitted program (an
    eager init and fill compile every op of the module one by one)."""
    shapes = jax.eval_shape(init, *init_args)
    return jax.jit(lambda key: _randomize(shapes, key))(jax.random.key(seed))


def test_unet_resnet_block_with_temb_matches_torch():
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        unet_param_map,
    )
    from pairwise_sample_optimization_tpu.models.layers import ResnetBlock

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x, temb):
            return ResnetBlock(
                24, groups=4, eps=1e-5, dtype=jnp.float32, name="down_0_resnet_0"
            )(x, temb)

    wrap = Wrap()
    x = jax.random.normal(jax.random.key(1), (2, 6, 5, 16))
    temb = jax.random.normal(jax.random.key(2), (2, 12))
    variables = _random_variables(wrap.init, jax.random.key(0), x, temb)
    sd = flax_to_torch(variables["params"], unet_param_map)

    got = jax.jit(wrap.apply)(variables, x, temb)
    want = t_resnet(
        _nchw(x), sd, "down_blocks.0.resnets.0", groups=4, eps=1e-5,
        temb=torch.from_numpy(_np(temb)),
    )
    _assert_close(got, want)


def test_unet_spatial_transformer_matches_torch():
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        unet_param_map,
    )
    from pairwise_sample_optimization_tpu.models.layers import SpatialTransformer

    heads, head_dim, depth = 2, 8, 2
    c = heads * head_dim

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, x, ctx):
            return SpatialTransformer(
                depth=depth, heads=heads, head_dim=head_dim, groups=4,
                dtype=jnp.float32, name="down_1_attn_0",
            )(x, ctx)

    wrap = Wrap()
    x = jax.random.normal(jax.random.key(1), (2, 4, 6, c))
    ctx = jax.random.normal(jax.random.key(2), (2, 7, c))
    variables = _random_variables(wrap.init, jax.random.key(0), x, ctx)
    sd = flax_to_torch(variables["params"], unet_param_map)

    got = jax.jit(wrap.apply)(variables, x, ctx)
    want = t_spatial_transformer(
        _nchw(x), torch.from_numpy(_np(ctx)), sd,
        "down_blocks.1.attentions.0", heads=heads, depth=depth, groups=4,
    )
    _assert_close(got, want)


def test_vae_decoder_matches_torch():
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        vae_param_map,
    )
    from pairwise_sample_optimization_tpu.models.vae import AutoencoderKL, VAEConfig

    cfg = VAEConfig.tiny()
    vae = AutoencoderKL(cfg)
    z_img = jax.random.normal(jax.random.key(1), (2, 8, 8, 3))
    variables = _random_variables(vae.init, jax.random.key(0), z_img, jax.random.key(9))
    sd = flax_to_torch(variables["params"], vae_param_map)

    z = jax.random.normal(jax.random.key(2), (2, 4, 4, cfg.latent_channels))
    got = jax.jit(lambda v, z_: vae.apply(v, z_, method=vae.decode))(variables, z)

    zt = _nchw(z) / cfg.scaling_factor
    zt = t_conv(zt, sd, "post_quant_conv", padding=0)
    want = t_vae_decoder(
        zt, sd, groups=cfg.norm_groups, layers_per_block=cfg.layers_per_block,
        n_levels=len(cfg.block_out_channels),
    )
    _assert_close(got, want)


def test_vae_encoder_matches_torch():
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        vae_param_map,
    )
    from pairwise_sample_optimization_tpu.models.vae import AutoencoderKL, VAEConfig

    cfg = VAEConfig.tiny()
    vae = AutoencoderKL(cfg)
    x = jax.random.normal(jax.random.key(1), (2, 8, 8, 3))
    variables = _random_variables(vae.init, jax.random.key(0), x, jax.random.key(9))
    sd = flax_to_torch(variables["params"], vae_param_map)

    mean, logvar = jax.jit(lambda v, x_: vae.apply(v, x_, method=vae.encode))(variables, x)

    h = t_vae_encoder(
        _nchw(x), sd, groups=cfg.norm_groups,
        layers_per_block=cfg.layers_per_block,
        n_levels=len(cfg.block_out_channels),
    )
    moments = t_conv(h, sd, "quant_conv", padding=0)
    want_mean, want_logvar = moments.chunk(2, dim=1)
    _assert_close(mean, want_mean)
    _assert_close(logvar, torch.clamp(want_logvar, -30.0, 20.0))


@pytest.mark.parametrize("subpixel", [False, True])
def test_upsample_op_matches_torch_interpolate_conv(subpixel):
    """ops.upsample (both dispatch paths) == torch nearest-interpolate +
    conv — the semantics of diffusers Upsample2D."""
    from pairwise_sample_optimization_tpu.ops import upsample as ups

    torch.manual_seed(11)
    c, o = 12, 16
    tconv = torch.nn.Conv2d(c, o, 3, padding=1)
    x = torch.randn(2, c, 5, 7)
    with torch.no_grad():
        want = tconv(F.interpolate(x, scale_factor=2.0, mode="nearest"))

    kernel = jnp.asarray(tconv.weight.detach().numpy().transpose(2, 3, 1, 0))
    bias = jnp.asarray(tconv.bias.detach().numpy())
    prev = ups._USE_SUBPIXEL
    ups.set_use_subpixel(subpixel)
    try:
        got = ups.upsample2x_conv3x3(
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), kernel, bias
        )
    finally:
        ups.set_use_subpixel(prev)
    _assert_close(got, want)
