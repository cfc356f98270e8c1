"""Cross-implementation port-fidelity anchors against REAL torch models.

The reference's text encoders and reward backbones are HF ``transformers``
CLIP models (``train_online_pso_sdxl_turbo.py:242-294``,
``pickscore_utils.py:8-9``); this environment ships torch(cpu) +
transformers, so the Flax towers and the torch->flax converter are pinned
directly against the implementation the reference runs — not against
self-recorded goldens. Layer-level anchors (conv / group-norm / attention
/ linear transpose conventions) cover the UNet/VAE porting rules that
diffusers' absence keeps from being tested end-to-end.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ATOL, RTOL = 3e-5, 2e-4


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------- #
# full-tower anchors vs transformers
# --------------------------------------------------------------------- #


def test_clip_text_tower_matches_transformers():
    """Flax text tower == transformers CLIPTextModelWithProjection
    (penultimate hidden state, final LN output, pooled, projection)."""
    from transformers import CLIPTextConfig as HFTextConfig
    from transformers import CLIPTextModelWithProjection

    from pairwise_sample_optimization_tpu.checkpoints import (
        clip_text_param_map,
        torch_to_flax,
    )
    from pairwise_sample_optimization_tpu.models.clip import (
        CLIPTextConfig,
        CLIPTextTower,
    )

    hf_cfg = HFTextConfig(
        vocab_size=100,
        hidden_size=32,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=77,
        hidden_act="quick_gelu",
        projection_dim=16,
        # real SDXL/PickScore text-encoder config.json files carry the
        # historical eos_token_id=2, which selects HF's argmax pooling —
        # the behavior our towers implement
        eos_token_id=2,
    )
    torch.manual_seed(0)
    hf = CLIPTextModelWithProjection(hf_cfg).eval()
    # argmax pooling parity: 99 is the max id in each row (HF pools at
    # input_ids.argmax(-1) for eos_token_id=2 configs; ours always does)
    ids = np.array(
        [[1, 5, 7, 99, 3, 2, 6, 8], [4, 12, 8, 9, 99, 11, 13, 10]], np.int64
    )
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), output_hidden_states=True)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}

    cfg = CLIPTextConfig(
        vocab_size=100, width=32, layers=2, heads=4, act="quick_gelu",
        projection_dim=16, dtype=jnp.float32,
    )
    tower = CLIPTextTower(cfg)
    ids_j = jnp.asarray(ids.astype(np.int32))
    variables = jax.eval_shape(tower.init, jax.random.key(0), ids_j)  # the tree, not its values
    params, _ = torch_to_flax(sd, variables["params"], clip_text_param_map)
    got = jax.jit(tower.apply)({"params": params}, ids_j)

    np.testing.assert_allclose(
        _np(got["penultimate"]), out.hidden_states[-2].numpy(), atol=ATOL, rtol=RTOL
    )
    np.testing.assert_allclose(
        _np(got["last_hidden_state"]),
        out.last_hidden_state.numpy(),
        atol=ATOL,
        rtol=RTOL,
    )
    np.testing.assert_allclose(
        _np(got["projected"]), out.text_embeds.numpy(), atol=ATOL, rtol=RTOL
    )


def test_clip_vision_tower_matches_transformers():
    """Flax vision tower == transformers CLIPVisionModelWithProjection."""
    from transformers import CLIPVisionConfig as HFVisionConfig
    from transformers import CLIPVisionModelWithProjection

    from pairwise_sample_optimization_tpu.checkpoints import (
        clip_vision_param_map,
        torch_to_flax,
    )
    from pairwise_sample_optimization_tpu.models.clip import (
        CLIPVisionConfig,
        CLIPVisionTower,
    )

    hf_cfg = HFVisionConfig(
        image_size=28,
        patch_size=7,
        hidden_size=32,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        hidden_act="quick_gelu",
        projection_dim=16,
    )
    torch.manual_seed(1)
    hf = CLIPVisionModelWithProjection(hf_cfg).eval()
    rng = np.random.default_rng(2)
    px_nchw = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(px_nchw))
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}

    cfg = CLIPVisionConfig(
        image_size=28, patch_size=7, width=32, layers=2, heads=4,
        act="quick_gelu", projection_dim=16, dtype=jnp.float32,
    )
    tower = CLIPVisionTower(cfg)
    px_nhwc = jnp.asarray(np.transpose(px_nchw, (0, 2, 3, 1)))
    variables = jax.eval_shape(tower.init, jax.random.key(0), px_nhwc)  # the tree
    params, _ = torch_to_flax(sd, variables["params"], clip_vision_param_map)
    got = jax.jit(tower.apply)({"params": params}, px_nhwc)
    np.testing.assert_allclose(
        _np(got), out.image_embeds.numpy(), atol=ATOL, rtol=RTOL
    )


def test_pickscore_dual_encoder_matches_transformers_clipmodel():
    """The full PickScore compute (normalized text @ image^T diagonal,
    reference ``pickscore_utils.py:24-62``) against a real transformers
    CLIPModel state dict loaded through ``load_hf_clip_dual``."""
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel

    from pairwise_sample_optimization_tpu.checkpoints import load_hf_clip_dual
    from pairwise_sample_optimization_tpu.models.clip import (
        CLIPDualEncoder,
        CLIPTextConfig,
        CLIPVisionConfig,
    )

    hf_cfg = HFCLIPConfig(
        text_config={
            "vocab_size": 100, "hidden_size": 32, "intermediate_size": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "max_position_embeddings": 77, "hidden_act": "gelu",
            "eos_token_id": 2,
        },
        vision_config={
            "image_size": 28, "patch_size": 7, "hidden_size": 32,
            "intermediate_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 4, "hidden_act": "gelu",
        },
        projection_dim=16,
    )
    torch.manual_seed(3)
    hf = CLIPModel(hf_cfg).eval()
    rng = np.random.default_rng(4)
    px = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    ids = np.array(
        [[1, 5, 7, 99, 3, 2, 6, 8], [4, 12, 8, 9, 99, 11, 13, 10]], np.int64
    )
    with torch.no_grad():
        img = hf.get_image_features(pixel_values=torch.from_numpy(px))
        txt = hf.get_text_features(input_ids=torch.from_numpy(ids))
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        want = (txt @ img.T).diagonal().numpy()

    dual = CLIPDualEncoder(
        CLIPTextConfig(
            vocab_size=100, width=32, layers=2, heads=4, act="gelu",
            projection_dim=16, dtype=jnp.float32,
        ),
        CLIPVisionConfig(
            image_size=28, patch_size=7, width=32, layers=2, heads=4,
            act="gelu", projection_dim=16, dtype=jnp.float32,
        ),
    )
    px_nhwc = jnp.asarray(np.transpose(px, (0, 2, 3, 1)))
    ids_j = jnp.asarray(ids.astype(np.int32))
    abstract = jax.eval_shape(dual.init, jax.random.key(0), px_nhwc, ids_j)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    variables = load_hf_clip_dual(sd, abstract)
    img_j, txt_j, _ = jax.jit(dual.apply)(variables, px_nhwc, ids_j)
    got = jnp.sum(txt_j * img_j, axis=-1)
    # cosine of two independently-normalized towers compounds fp error;
    # 2e-4 absolute on a [-1,1] similarity is well inside score noise
    np.testing.assert_allclose(_np(got), want, atol=2e-4, rtol=0.02)


# --------------------------------------------------------------------- #
# layer-level porting-convention anchors (UNet/VAE rules)
# --------------------------------------------------------------------- #


def test_conv2d_port_convention():
    """torch Conv2d (NCHW, OIHW) == flax nn.Conv (NHWC) with the
    converter's 'conv' kind transpose (OIHW -> HWIO)."""
    import flax.linen as nn

    from pairwise_sample_optimization_tpu.checkpoints.convert import _to_flax

    torch.manual_seed(5)
    tconv = torch.nn.Conv2d(8, 16, 3, padding=1)
    x = torch.randn(2, 8, 10, 12)
    with torch.no_grad():
        want = tconv(x).numpy()

    conv = nn.Conv(16, (3, 3), padding=((1, 1), (1, 1)), dtype=jnp.float32)
    kernel = _to_flax(tconv.weight.detach().numpy(), "conv")
    bias = tconv.bias.detach().numpy()
    got = conv.apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
    )
    np.testing.assert_allclose(
        _np(got).transpose(0, 3, 1, 2), want, atol=ATOL, rtol=RTOL
    )


def test_group_norm_matches_torch():
    """ops.group_norm (NHWC, fused SiLU option) == torch GroupNorm(+silu):
    same channel grouping, eps placement, and affine order."""
    from pairwise_sample_optimization_tpu.ops.group_norm import group_norm

    torch.manual_seed(6)
    c, groups = 24, 4
    tgn = torch.nn.GroupNorm(groups, c, eps=1e-6)
    with torch.no_grad():
        tgn.weight.mul_(1.7).add_(0.3)
        tgn.bias.add_(0.1)
    x = torch.randn(2, c, 6, 5)
    with torch.no_grad():
        want = tgn(x).numpy()
        want_silu = torch.nn.functional.silu(tgn(x)).numpy()

    x_nhwc = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    scale = jnp.asarray(tgn.weight.detach().numpy())
    bias = jnp.asarray(tgn.bias.detach().numpy())
    got = group_norm(x_nhwc, scale, bias, groups, 1e-6)
    np.testing.assert_allclose(
        _np(got).transpose(0, 3, 1, 2), want, atol=ATOL, rtol=RTOL
    )
    got_silu = group_norm(x_nhwc, scale, bias, groups, 1e-6, act="silu")
    np.testing.assert_allclose(
        _np(got_silu).transpose(0, 3, 1, 2), want_silu, atol=ATOL, rtol=RTOL
    )


def test_attention_matches_torch_sdpa():
    """ops.attention (B,S,H,D layout) == torch scaled_dot_product_attention
    — the op torch SDPA/xformers provided to the reference."""
    from pairwise_sample_optimization_tpu.ops.attention import dot_product_attention

    torch.manual_seed(7)
    b, s_q, s_kv, h, d = 2, 9, 7, 4, 8
    q = torch.randn(b, h, s_q, d)
    k = torch.randn(b, h, s_kv, d)
    v = torch.randn(b, h, s_kv, d)
    with torch.no_grad():
        want = torch.nn.functional.scaled_dot_product_attention(q, k, v).numpy()

    to_bshd = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 1, 3))
    got = dot_product_attention(to_bshd(q), to_bshd(k), to_bshd(v))
    np.testing.assert_allclose(
        _np(got).transpose(0, 2, 1, 3), want, atol=ATOL, rtol=RTOL
    )

    # causal path (CLIP text towers)
    with torch.no_grad():
        want_c = torch.nn.functional.scaled_dot_product_attention(
            q, k[:, :, :s_q], v[:, :, :s_q], is_causal=True
        ).numpy()
    got_c = dot_product_attention(
        to_bshd(q), to_bshd(k[:, :, :s_q]), to_bshd(v[:, :, :s_q]), causal=True
    )
    np.testing.assert_allclose(
        _np(got_c).transpose(0, 2, 1, 3), want_c, atol=ATOL, rtol=RTOL
    )


def test_linear_port_convention():
    """torch Linear weight (out,in) == flax Dense kernel (in,out) via the
    converter's 'linear' transpose."""
    import flax.linen as nn

    from pairwise_sample_optimization_tpu.checkpoints.convert import _to_flax

    torch.manual_seed(8)
    tl = torch.nn.Linear(6, 10)
    x = torch.randn(3, 6)
    with torch.no_grad():
        want = tl(x).numpy()
    dense = nn.Dense(10, dtype=jnp.float32)
    got = dense.apply(
        {
            "params": {
                "kernel": jnp.asarray(_to_flax(tl.weight.detach().numpy(), "linear")),
                "bias": jnp.asarray(tl.bias.detach().numpy()),
            }
        },
        jnp.asarray(x.numpy()),
    )
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=RTOL)


def test_flax_to_torch_roundtrip_runs_in_torch():
    """Export direction: a flax-initialized text tower state dict loads
    into transformers and reproduces the flax numbers (the LoRA/export
    interop direction)."""
    from transformers import CLIPTextConfig as HFTextConfig
    from transformers import CLIPTextModelWithProjection

    from pairwise_sample_optimization_tpu.checkpoints import (
        clip_text_param_map,
        flax_to_torch,
    )
    from pairwise_sample_optimization_tpu.models.clip import (
        CLIPTextConfig,
        CLIPTextTower,
    )

    cfg = CLIPTextConfig(
        vocab_size=100, width=32, layers=2, heads=4, act="quick_gelu",
        projection_dim=16, dtype=jnp.float32,
    )
    tower = CLIPTextTower(cfg)
    ids = np.array([[1, 5, 99, 3, 2, 6, 7, 8]], np.int64)
    ids_j = jnp.asarray(ids.astype(np.int32))
    variables = jax.jit(tower.init)(jax.random.key(42), ids_j)
    want = jax.jit(tower.apply)(variables, ids_j)

    sd = flax_to_torch(variables["params"], clip_text_param_map)
    hf_cfg = HFTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=77, hidden_act="quick_gelu", projection_dim=16,
        eos_token_id=2,
    )
    hf = CLIPTextModelWithProjection(hf_cfg).eval()
    hf.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=False
    )
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(
        _np(want["projected"]), out.text_embeds.numpy(), atol=ATOL, rtol=RTOL
    )
