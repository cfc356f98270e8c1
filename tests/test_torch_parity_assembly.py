"""Full-assembly port-fidelity anchors: the COMPLETE UNet forward and the
end-to-end tiny chain (encode -> unet -> step -> vae -> score) vs torch.

The block-level anchors (test_torch_parity_blocks.py) pin each diffusers
block in isolation; what they cannot catch is assembly wiring — skip-
connection pop order, down/mid/up sequencing, time + add-embedding
plumbing, conv_in/out — exactly what loading a real SDXL checkpoint
exercises (reference ``train_online_pso_sdxl_turbo.py:290-294``). Here a
tiny-config UNet mirroring diffusers ``UNet2DConditionModel``'s
documented forward is hand-composed in torch functional code over the
state dict exported by ``flax_to_torch`` (the exact dict a diffusers
checkpoint load would consume), and the assembled forwards must match.

The chain test then composes REAL ``transformers`` CLIP text encoders,
the Flax UNet, the deterministic final turbo step, the Flax VAE decoder
and the PickScore scorer against an independent torch chain — the
minimum end-to-end slice of the online loop, cross-checked model by
model through the same weight-port maps production uses.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_parity_blocks import (  # noqa: E402
    _nchw,
    _np,
    _random_variables,
    t_conv,
    t_gn,
    t_linear,
    t_resnet,
    t_spatial_transformer,
    t_upsample,
    t_vae_decoder,
)

ATOL, RTOL = 1e-4, 1e-3


# ------------------------------------------------------------------ #
# torch transcription of diffusers UNet2DConditionModel (SDXL wiring)
# ------------------------------------------------------------------ #


def t_timestep_embedding(t, dim):
    """diffusers get_timestep_embedding(flip_sin_to_cos=True, shift=0)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half
    args = t.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def t_temb_mlp(x, sd, p):
    return t_linear(F.silu(t_linear(x, sd, p + ".linear_1")), sd, p + ".linear_2")


def t_unet2dcondition(sample, timesteps, ctx, pooled, time_ids, sd, cfg):
    """diffusers UNet2DConditionModel forward (SDXL "text_time" class):
    conv_in -> down blocks (resnets[+attn], downsampler) collecting one
    skip per resnet/downsampler output -> mid (res, attn, res) -> up
    blocks popping one skip per resnet (layers_per_block+1 each),
    upsampler between levels -> conv_norm_out/silu/conv_out. NCHW."""
    n_levels = len(cfg.block_out_channels)
    groups = cfg.norm_groups

    temb = t_temb_mlp(
        t_timestep_embedding(timesteps, cfg.block_out_channels[0]), sd, "time_embedding"
    )
    ids_emb = t_timestep_embedding(
        time_ids.reshape(-1), cfg.addition_time_embed_dim
    ).reshape(time_ids.shape[0], -1)
    add_embeds = torch.cat([pooled.float(), ids_emb], dim=-1)
    temb = temb + t_temb_mlp(add_embeds, sd, "add_embedding")

    h = t_conv(sample, sd, "conv_in")
    skips = [h]
    for level, ch in enumerate(cfg.block_out_channels):
        depth = cfg.transformer_layers[level]
        heads = ch // cfg.head_dim
        for i in range(cfg.layers_per_block):
            h = t_resnet(
                h, sd, f"down_blocks.{level}.resnets.{i}", groups, 1e-5, temb=temb
            )
            if depth:
                h = t_spatial_transformer(
                    h, ctx, sd, f"down_blocks.{level}.attentions.{i}",
                    heads=heads, depth=depth, groups=groups,
                )
            skips.append(h)
        if level < n_levels - 1:
            h = t_conv(
                h, sd, f"down_blocks.{level}.downsamplers.0.conv", stride=2, padding=1
            )
            skips.append(h)

    mid_ch = cfg.block_out_channels[-1]
    mid_depth = cfg.transformer_layers[-1]
    h = t_resnet(h, sd, "mid_block.resnets.0", groups, 1e-5, temb=temb)
    if mid_depth:
        h = t_spatial_transformer(
            h, ctx, sd, "mid_block.attentions.0",
            heads=mid_ch // cfg.head_dim, depth=mid_depth, groups=groups,
        )
    h = t_resnet(h, sd, "mid_block.resnets.1", groups, 1e-5, temb=temb)

    for rev, ch in enumerate(reversed(cfg.block_out_channels)):
        level = n_levels - 1 - rev  # channel stage; torch up_blocks index = rev
        depth = cfg.transformer_layers[level]
        heads = ch // cfg.head_dim
        for i in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = t_resnet(h, sd, f"up_blocks.{rev}.resnets.{i}", groups, 1e-5, temb=temb)
            if depth:
                h = t_spatial_transformer(
                    h, ctx, sd, f"up_blocks.{rev}.attentions.{i}",
                    heads=heads, depth=depth, groups=groups,
                )
        if level > 0:
            h = t_upsample(h, sd, f"up_blocks.{rev}.upsamplers.0")
    assert not skips, f"{len(skips)} unconsumed skip connections"

    h = F.silu(t_gn(h, sd, "conv_norm_out", groups, 1e-5))
    return t_conv(h, sd, "conv_out")


def _assert_close_nchw(got_nhwc, want_nchw, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        _np(got_nhwc).transpose(0, 3, 1, 2), want_nchw.numpy(), atol=atol, rtol=rtol
    )


# ------------------------------------------------------------------ #
# 1. full UNet assembly
# ------------------------------------------------------------------ #


def test_full_unet_assembly_matches_torch():
    """Assembled 3-level tiny UNet == the torch transcription: every skip
    pop, downsample/upsample position, and embedding join in one check."""
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        unet_param_map,
    )
    from pairwise_sample_optimization_tpu.models import SDXLUNet, UNetConfig

    cfg = UNetConfig(
        block_out_channels=(16, 32, 64),
        transformer_layers=(0, 1, 2),
        layers_per_block=2,
        head_dim=8,
        cross_attention_dim=24,
        addition_time_embed_dim=8,
        pooled_embed_dim=16,
        norm_groups=8,
        dtype=jnp.float32,
    )
    model = SDXLUNet(cfg)
    b = 2
    sample = jax.random.normal(jax.random.key(1), (b, 16, 16, 4))
    timesteps = jnp.asarray([7.0, 345.0])
    ctx = jax.random.normal(jax.random.key(2), (b, 6, cfg.cross_attention_dim))
    pooled = jax.random.normal(jax.random.key(3), (b, cfg.pooled_embed_dim))
    time_ids = jnp.tile(jnp.asarray([[512.0, 512, 0, 0, 512, 512]]), (b, 1))

    variables = _random_variables(
        model.init, jax.random.key(0), sample, timesteps, ctx, pooled, time_ids, seed=4
    )
    sd = flax_to_torch(
        variables["params"], functools.partial(unet_param_map, n_levels=3)
    )

    got = jax.jit(model.apply)(variables, sample, timesteps, ctx, pooled, time_ids)
    want = t_unet2dcondition(
        _nchw(sample),
        torch.from_numpy(_np(timesteps)),
        torch.from_numpy(_np(ctx)),
        torch.from_numpy(_np(pooled)),
        torch.from_numpy(_np(time_ids)),
        sd,
        cfg,
    )
    _assert_close_nchw(got, want)


def test_full_unet_assembly_matches_torch_sd15():
    """SD1.x assembly variant: 4 levels, attention-free last level but an
    attending mid block, fixed head count, no text_time conditioning —
    the wiring the legacy SD1.5 CFG pipeline path loads."""
    from pairwise_sample_optimization_tpu.checkpoints import (
        flax_to_torch,
        unet_param_map,
    )
    from pairwise_sample_optimization_tpu.models import SDXLUNet, UNetConfig

    import dataclasses

    cfg = dataclasses.replace(
        UNetConfig.sd15(dtype=jnp.float32),
        block_out_channels=(16, 24, 32, 32),
        transformer_layers=(1, 1, 1, 0),
        mid_transformer_layers=1,
        fixed_num_heads=4,
        layers_per_block=1,
        cross_attention_dim=24,
        norm_groups=8,
    )
    model = SDXLUNet(cfg)
    b = 2
    sample = jax.random.normal(jax.random.key(1), (b, 16, 16, 4))
    timesteps = jnp.asarray([13.0, 981.0])
    ctx = jax.random.normal(jax.random.key(2), (b, 6, cfg.cross_attention_dim))
    variables = _random_variables(model.init, jax.random.key(0), sample, timesteps, ctx, seed=4)
    sd = flax_to_torch(
        variables["params"], functools.partial(unet_param_map, n_levels=4)
    )
    got = jax.jit(model.apply)(variables, sample, timesteps, ctx)

    # torch side: same transcription minus add_embedding, with fixed heads
    n_levels = 4
    temb = t_temb_mlp(
        t_timestep_embedding(torch.from_numpy(_np(timesteps)), 16), sd, "time_embedding"
    )
    ctx_t = torch.from_numpy(_np(ctx))
    h = t_conv(_nchw(sample), sd, "conv_in")
    skips = [h]
    for level in range(n_levels):
        depth = cfg.transformer_layers[level]
        for i in range(cfg.layers_per_block):
            h = t_resnet(h, sd, f"down_blocks.{level}.resnets.{i}", 8, 1e-5, temb=temb)
            if depth:
                h = t_spatial_transformer(
                    h, ctx_t, sd, f"down_blocks.{level}.attentions.{i}",
                    heads=4, depth=depth, groups=8,
                )
            skips.append(h)
        if level < n_levels - 1:
            h = t_conv(
                h, sd, f"down_blocks.{level}.downsamplers.0.conv", stride=2, padding=1
            )
            skips.append(h)
    h = t_resnet(h, sd, "mid_block.resnets.0", 8, 1e-5, temb=temb)
    h = t_spatial_transformer(
        h, ctx_t, sd, "mid_block.attentions.0", heads=4, depth=1, groups=8
    )
    h = t_resnet(h, sd, "mid_block.resnets.1", 8, 1e-5, temb=temb)
    for rev in range(n_levels):
        level = n_levels - 1 - rev
        depth = cfg.transformer_layers[level]
        for i in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = t_resnet(h, sd, f"up_blocks.{rev}.resnets.{i}", 8, 1e-5, temb=temb)
            if depth:
                h = t_spatial_transformer(
                    h, ctx_t, sd, f"up_blocks.{rev}.attentions.{i}",
                    heads=4, depth=depth, groups=8,
                )
        if level > 0:
            h = t_upsample(h, sd, f"up_blocks.{rev}.upsamplers.0")
    assert not skips
    h = F.silu(t_gn(h, sd, "conv_norm_out", 8, 1e-5))
    want = t_conv(h, sd, "conv_out")
    _assert_close_nchw(got, want)


# ------------------------------------------------------------------ #
# 2. end-to-end tiny chain
# ------------------------------------------------------------------ #


def test_tiny_chain_encode_unet_step_decode_score_matches_torch():
    """ids -> dual text encode -> UNet eps -> deterministic 1-step turbo
    x0 -> VAE decode -> PickScore, flax vs an independent torch chain.

    Text encoders are REAL ``transformers`` CLIP models ported torch->flax
    (the production load direction); UNet/VAE are flax->torch exports fed
    to the functional transcriptions; the scorer is a REAL ``transformers``
    CLIPModel ported through ``load_hf_clip_dual``. The sigma constants
    come from ``make_euler_ancestral_schedule`` (independently anchored by
    the scheduler golden tests) and are shared by both sides — this test
    pins the MODEL composition, not the schedule values."""
    transformers = pytest.importorskip("transformers")
    from transformers import (
        CLIPConfig,
        CLIPModel,
        CLIPTextConfig as HFTextConfig,
        CLIPTextModelWithProjection,
        CLIPVisionConfig as HFVisionConfig,
    )

    from pairwise_sample_optimization_tpu.checkpoints import (
        clip_text_param_map,
        flax_to_torch,
        load_hf_clip_dual,
        torch_to_flax,
        unet_param_map,
        vae_param_map,
    )
    from pairwise_sample_optimization_tpu.models import SDXLUNet, UNetConfig
    from pairwise_sample_optimization_tpu.models.clip import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
    )
    from pairwise_sample_optimization_tpu.models.sdxl_text import encode_sdxl_prompt
    from pairwise_sample_optimization_tpu.models.vae import AutoencoderKL, VAEConfig
    from pairwise_sample_optimization_tpu.ops.schedules import (
        make_euler_ancestral_schedule,
    )
    from pairwise_sample_optimization_tpu.rewards import PickScoreScorer
    from pairwise_sample_optimization_tpu.rewards.preprocess import (
        CLIP_MEAN,
        CLIP_STD,
    )

    b = 2
    w1, w2, pooled_dim = 16, 24, 16

    # --- text encoders: real transformers models, ported torch -> flax ---
    def hf_text(width, seed):
        torch.manual_seed(seed)
        return CLIPTextModelWithProjection(
            HFTextConfig(
                vocab_size=100, hidden_size=width, intermediate_size=width * 4,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=77, hidden_act="quick_gelu",
                projection_dim=pooled_dim, eos_token_id=2,
            )
        ).eval()

    hf1, hf2 = hf_text(w1, 0), hf_text(w2, 1)
    ids = np.array(
        [[1, 5, 7, 99, 3, 2, 6, 8], [4, 12, 8, 9, 99, 11, 13, 10]], np.int64
    )

    def flax_text(hf, width):
        cfg = CLIPTextConfig(
            vocab_size=100, width=width, layers=2, heads=4, act="quick_gelu",
            projection_dim=pooled_dim, dtype=jnp.float32,
        )
        tower = CLIPTextTower(cfg)
        # the tree alone: every value comes from the transformers model
        variables = jax.eval_shape(tower.init, jax.random.key(0),
                                   jnp.asarray(ids.astype(np.int32)))
        sd = {k: v.numpy() for k, v in hf.state_dict().items()}
        params, _ = torch_to_flax(sd, variables["params"], clip_text_param_map)
        return tower, {"params": params}

    te1, te1_vars = flax_text(hf1, w1)
    te2, te2_vars = flax_text(hf2, w2)

    # --- UNet: 2-level tiny, cross dim = w1 + w2 (the SDXL concat) ---
    ucfg = UNetConfig(
        block_out_channels=(16, 32),
        transformer_layers=(0, 1),
        layers_per_block=1,
        head_dim=8,
        cross_attention_dim=w1 + w2,
        addition_time_embed_dim=8,
        pooled_embed_dim=pooled_dim,
        norm_groups=8,
        dtype=jnp.float32,
    )
    unet = SDXLUNet(ucfg)
    hw = 8
    time_ids = jnp.tile(jnp.asarray([[16.0, 16, 0, 0, 16, 16]]), (b, 1))
    uvars = _random_variables(
        unet.init,
        jax.random.key(0),
        jnp.zeros((1, hw, hw, 4)),
        jnp.zeros((1,)),
        jnp.zeros((1, ids.shape[1], ucfg.cross_attention_dim)),
        jnp.zeros((1, pooled_dim)),
        time_ids[:1],
        seed=5,
    )
    unet_sd = flax_to_torch(
        uvars["params"], functools.partial(unet_param_map, n_levels=2)
    )

    # --- VAE (decode side) ---
    vcfg = VAEConfig.tiny()
    vae = AutoencoderKL(vcfg)
    vvars = _random_variables(
        vae.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jax.random.key(9), seed=6
    )
    vae_sd = flax_to_torch(vvars["params"], vae_param_map)

    # --- scorer: real transformers CLIPModel ported into the flax dual ---
    torch.manual_seed(2)
    hf_clip = CLIPModel(
        CLIPConfig(
            text_config=HFTextConfig(
                vocab_size=100, hidden_size=16, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=77, hidden_act="quick_gelu",
                eos_token_id=2,
            ).to_dict(),
            vision_config=HFVisionConfig(
                image_size=16, patch_size=4, hidden_size=16, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, hidden_act="quick_gelu",
            ).to_dict(),
            projection_dim=12,
        )
    ).eval()
    scorer = PickScoreScorer(
        text_config=CLIPTextConfig(
            vocab_size=100, width=16, layers=2, heads=4, act="quick_gelu",
            projection_dim=12, dtype=jnp.float32,
        ),
        vision_config=CLIPVisionConfig(
            image_size=16, patch_size=4, width=16, layers=2, heads=4,
            act="quick_gelu", projection_dim=12, dtype=jnp.float32,
        ),
    )
    scorer.variables = load_hf_clip_dual(
        {k: v.numpy() for k, v in hf_clip.state_dict().items()}, scorer.variables
    )

    # ---------------- flax chain ----------------
    schedule = make_euler_ancestral_schedule(1)
    sigma0 = float(schedule.sigmas[0])
    t0 = float(schedule.timesteps[0])
    init = np.random.default_rng(11).normal(size=(b, hw, hw, 4)).astype(np.float32)

    embeds, pooled = encode_sdxl_prompt(
        te1, te1_vars, te2, te2_vars,
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(ids.astype(np.int32)),
    )
    x = jnp.asarray(init) * schedule.init_noise_sigma
    x_in = x / jnp.sqrt(sigma0**2 + 1.0)
    eps = jax.jit(unet.apply)(
        uvars, x_in, jnp.full((b,), t0), embeds, pooled, time_ids
    )
    x0 = x - sigma0 * eps  # the final turbo step is deterministic: x -> x0
    images = jax.jit(lambda v, z: vae.apply(v, z, method=vae.decode))(vvars, x0)
    reward_ids = jnp.asarray(ids.astype(np.int32))
    scores = scorer.score(images, reward_ids)

    # ---------------- torch chain ----------------
    ids_t = torch.from_numpy(ids)
    with torch.no_grad():
        out1 = hf1(input_ids=ids_t, output_hidden_states=True)
        out2 = hf2(input_ids=ids_t, output_hidden_states=True)
        embeds_t = torch.cat(
            [out1.hidden_states[-2], out2.hidden_states[-2]], dim=-1
        )
        pooled_t = out2.text_embeds

        xt = torch.from_numpy(init.transpose(0, 3, 1, 2)) * float(
            schedule.init_noise_sigma
        )
        xt_in = xt / math.sqrt(sigma0**2 + 1.0)
        eps_t = t_unet2dcondition(
            xt_in,
            torch.full((b,), t0),
            embeds_t,
            pooled_t,
            torch.from_numpy(_np(time_ids)),
            unet_sd,
            ucfg,
        )
        x0_t = xt - sigma0 * eps_t
        zt = t_conv(x0_t / vcfg.scaling_factor, vae_sd, "post_quant_conv", padding=0)
        images_t = t_vae_decoder(
            zt, vae_sd, groups=vcfg.norm_groups,
            layers_per_block=vcfg.layers_per_block,
            n_levels=len(vcfg.block_out_channels),
        )
        px = ((images_t + 1.0) / 2.0).clamp(0.0, 1.0)
        px = (px - torch.tensor(CLIP_MEAN)[:, None, None]) / torch.tensor(CLIP_STD)[
            :, None, None
        ]
        img_f = hf_clip.get_image_features(pixel_values=px)
        txt_f = hf_clip.get_text_features(input_ids=ids_t)
        img_f = img_f / img_f.norm(dim=-1, keepdim=True)
        txt_f = txt_f / txt_f.norm(dim=-1, keepdim=True)
        want_scores = (txt_f * img_f).sum(-1)

    # intermediate + final checks: a failure localizes to one stage
    np.testing.assert_allclose(_np(embeds), embeds_t.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(pooled), pooled_t.numpy(), atol=ATOL, rtol=RTOL)
    _assert_close_nchw(eps, eps_t)
    _assert_close_nchw(images, images_t, atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(
        _np(scores), want_scores.numpy(), atol=5e-4, rtol=2e-3
    )
