"""Port models vs the JAX package's flax models, fp32 on the CPU.

Each JAX tiny module gets params from a seed (the UNet's and the VAE's
drawn with numpy in the flax tree's shapes, which is much faster than
compiling their init; the CLIP towers' from flax's init), its params (and
LoRA collection, with a non-zero B so the adapter does work) carried into
the port with ``state_dict_from_jax`` and loaded with ``strict=True``;
inputs are made with numpy and handed to both. Each JAX module's apply is
jitted once per test module. Tolerance: ATOL 3e-5 / RTOL 2e-4, the bar of
``tests/test_torch_parity_blocks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.models import clip as jclip
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.models import vae as jvae
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.models import clip as tclip
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.models import vae as tvae

ATOL, RTOL = 3e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def _random_params(shapes, seed):
    """Params in a flax tree's shapes (``jax.eval_shape`` of the init):
    kernels gaussian with std 1/sqrt(fan_in), norms identity, biases and
    embeddings small, LoRA A gaussian with std 1/rank and B zero."""
    r = np.random.default_rng(seed)

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return np.zeros(shape, np.float32)
        if name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or len(shape) < 2 or "embedding" in name:
            std = 0.02
        else:
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return (r.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nonzero_lora_b(lora, seed):
    r = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict)
                    else (r.standard_normal(v.shape).astype(np.float32) * 0.2 if k == "b"
                          else np.asarray(v)))
                for k, v in node.items()}

    return walk(lora)


@pytest.fixture(scope="module")
def unet_pair():
    cfg = junet.UNetConfig.tiny(lora_rank=4)
    model = junet.SDXLUNet(cfg)
    r = np.random.default_rng(0)
    inputs = (
        r.standard_normal((3, 8, 8, 4)).astype(np.float32),
        np.array([999, 499, 17], np.int32),
        r.standard_normal((3, 77, 32)).astype(np.float32),
        r.standard_normal((3, 16)).astype(np.float32),
        np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (3, 1)),
    )
    shapes = jax.eval_shape(model.init, jax.random.key(0), *map(jnp.asarray, inputs))
    variables = _random_params(shapes, 0)
    variables = {"params": variables["params"], "lora": _nonzero_lora_b(variables["lora"], 1)}
    port = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=4), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return jax.jit(model.apply), variables, port, inputs


@pytest.mark.parametrize("scale", ["one", "zero", "per_sample"])
def test_tiny_unet_matches_jax(unet_pair, scale):
    apply, variables, port, (x, t, ehs, pooled, tids) = unet_pair
    ls_j, ls_t = {
        "one": (1.0, 1.0),
        "zero": (0.0, 0.0),
        "per_sample": (jnp.asarray([1.0, 0.0, 0.5]), torch.tensor([1.0, 0.0, 0.5])),
    }[scale]
    want = apply(variables, *map(jnp.asarray, (x, t, ehs, pooled, tids)), lora_scale=ls_j)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(ehs), torch.from_numpy(pooled), torch.from_numpy(tids),
                   lora_scale=ls_t)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_tiny_unet_lora_is_live_and_separate(unet_pair):
    _, _, port, (x, t, ehs, pooled, tids) = unet_pair
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ehs),
            torch.from_numpy(pooled), torch.from_numpy(tids))
    with torch.no_grad():
        on, off = port(*args, lora_scale=1.0), port(*args, lora_scale=0.0)
    assert (on - off).abs().max() > 1e-3
    lora_keys = [k for k in port.state_dict() if ".lora." in k]
    assert lora_keys and all(port.state_dict()[k].dtype == torch.float32 for k in lora_keys)
    base = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=0), device="cpu").state_dict()
    assert set(port.state_dict()) - set(lora_keys) == set(base)


def test_tiny_vae_decode_matches_jax():
    cfg = jvae.VAEConfig.tiny()
    model = jvae.AutoencoderKL(cfg)
    variables = _random_params(jax.eval_shape(model.init, jax.random.key(2),
                                              jnp.zeros((1, 16, 16, 3)), jax.random.key(3)), 2)
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny(), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"], "vae"), strict=True)
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.5
    want = jax.jit(lambda v, z: model.apply(v, z, method=model.decode))(variables, jnp.asarray(z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_tiny_clip_text_tower_matches_jax():
    cfg = jclip.CLIPTextConfig.tiny()
    model = jclip.CLIPTextTower(cfg)
    ids = np.random.default_rng(5).integers(1, 999, size=(2, 77)).astype(np.int32)
    ids[0, 9], ids[1, 40] = 999, 999  # EOS (highest id) positions
    variables = jax.jit(model.init)(jax.random.key(6), jnp.asarray(ids))
    port = tclip.CLIPTextTower(tclip.CLIPTextConfig.tiny(), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"], "clip_text"), strict=True)
    want = jax.jit(model.apply)(variables, jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    for key in ("penultimate", "last_hidden_state", "pooled", "projected"):
        _close(got[key].numpy(), want[key])


def test_tiny_clip_vision_tower_matches_jax():
    cfg = jclip.CLIPVisionConfig.tiny()
    model = jclip.CLIPVisionTower(cfg)
    pixels = np.random.default_rng(7).standard_normal((2, 28, 28, 3)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.key(8), jnp.asarray(pixels))
    port = tclip.CLIPVisionTower(tclip.CLIPVisionConfig.tiny(), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"], "clip_vision"), strict=True)
    want = jax.jit(model.apply)(variables, jnp.asarray(pixels))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels).permute(0, 3, 1, 2))
    _close(got.numpy(), want)
