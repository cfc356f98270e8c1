"""The port's DreamBooth PSO (VAE encoder, PNG reader, dataset, loss,
scheduler spaces, trainer, CLI) against the JAX package, fp32 on the CPU
with the tiny models.

JAX params are drawn with numpy in ``jax.eval_shape``'s shapes and carried
into the port with ``state_dict_from_jax``; the JAX trainer's random draws
(lattice indices and noise, from its key splits) are handed to the port's
update. Tolerance: ATOL 3e-5 / RTOL 2e-4 unless a test says otherwise.
Images are compared with PIL, which is installed here (the port does not
import it).
"""

import importlib.util
import math
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pairwise_sample_optimization_tpu.checkpoints import lora_safetensors as jls
from pairwise_sample_optimization_tpu.data import dreambooth as jdb
from pairwise_sample_optimization_tpu.models import sdxl_text as jtext
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.models import vae as jvae
from pairwise_sample_optimization_tpu.ops import schedules as jsched
from pairwise_sample_optimization_tpu.train import losses as jlosses
from pairwise_sample_optimization_tpu.train import dreambooth_pso as jdbp
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.checkpoints import (LORA_FILE, latest_checkpoint,
                                                                load_file, restore_train_state,
                                                                state_dict_from_jax)
from pairwise_sample_optimization_tpu_torch.checkpoints.torch_names import unet_param_map
from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as cli
from pairwise_sample_optimization_tpu_torch.data import dreambooth as tdb
from pairwise_sample_optimization_tpu_torch.models import sdxl_text as ttext
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.models import vae as tvae
from pairwise_sample_optimization_tpu_torch.ops import schedules as tsched
from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
from pairwise_sample_optimization_tpu_torch.train import (DreamBoothPSOConfig,
                                                          DreamBoothPSOTrainer, PSOTrainState,
                                                          dreambooth_pso_loss, lora_parameters,
                                                          make_optimizer)
from pairwise_sample_optimization_tpu_torch.utils.png import read_png, write_png

ATOL, RTOL = 3e-5, 2e-4
ROOT = Path(__file__).resolve().parent.parent
RANK, GA, B, HW, CTX = 2, 2, 2, 8, 5
HP = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-4,
          max_grad_norm=1.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _random_variables(shapes, seed, lora_b_std=0.0):
    """Weights in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, small biases, LoRA A gaussian with std
    1/rank and B gaussian with std ``lora_b_std``."""
    r = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return (r.standard_normal(shape) * lora_b_std).astype(np.float32)
        if name == "a":
            std = 1.0 / shape[-1]
        elif name == "bias" or len(shape) < 2 or "embedding" in name:
            std = 0.02
        else:
            std = 1.0 / math.sqrt(np.prod(shape[:-1]))
        return (r.standard_normal(shape) * std).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape) for k, v in node.items()}

    return walk(shapes)


# ---------------------------------------------------------------------- #
# tables, VAE encoder, PNG reader, resize, dataset
# ---------------------------------------------------------------------- #


def test_karras_sigmas_and_time_ids_from_records_are_bit_equal():
    for n in (1000, 37):
        np.testing.assert_array_equal(tsched.make_karras_sigmas(n), jsched.make_karras_sigmas(n))
    assert tsched.make_karras_sigmas().dtype == np.float32
    sizes, crops = [(600, 520), (520, 640), (512, 512)], [(44, 0), (0, 64), (0, 0)]
    got = ttext.time_ids_from_records(sizes, crops, 512)
    assert got.dtype == torch.float32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtext.time_ids_from_records(
        sizes, crops, 512)))


def test_vae_encode_matches_jax_and_chunks_equal_the_whole():
    model = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    variables = _random_variables(jax.eval_shape(model.init, jax.random.key(0),
                                                 jnp.zeros((1, 16, 16, 3)), jax.random.key(1)), 2)
    vae = tvae.AutoencoderKL(tvae.VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(state_dict_from_jax(variables["params"], "vae"), strict=True)
    assert any(k.startswith("encoder.down_blocks.0.downsamplers.0.conv") for k in vae.state_dict())
    x = np.random.default_rng(3).uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(lambda v, x: model.apply(v, x, method=model.encode))(
        variables, jnp.asarray(x))
    pipe = SDXLPipeline(unet=None, vae=vae, te1=None, te2=None)
    mean, logvar = pipe.encode_images(x)
    _close(mean, mean_j)
    _close(logvar, logvar_j)
    mean_c, logvar_c = pipe.encode_images(torch.from_numpy(x), chunk=2)  # 2 + 2 + 1
    _close(mean_c, mean)  # the CPU's convolutions may sum in another order per batch size
    _close(logvar_c, logvar)
    # sample_latents: mean + exp(logvar / 2) n, scaled
    n = torch.randn(mean.permute(0, 3, 1, 2).shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        z = vae.sample_latents(torch.from_numpy(x).permute(0, 3, 1, 2), noise=n)
    want = (mean.permute(0, 3, 1, 2) + torch.exp(0.5 * logvar.permute(0, 3, 1, 2)) * n) * 0.13025
    _close(z, want, atol=1e-6, rtol=1e-6)


def _image(h, w, seed):
    """Smooth gradients plus noise: every PNG filter type wins some rows."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3 + yy, yy * 5, (xx * yy) % 97 * 2], -1)
    return np.clip(base + r.integers(-3, 4, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P16", "1"])
def test_png_reader_matches_pil_on_files_pil_writes(tmp_path, mode):
    """PIL writes a palette of 16 colours at 4 bits a pixel and mode "1" at
    one bit; the others at 8."""
    img = Image.fromarray(_image(37, 53, 1))
    if mode.startswith("P"):
        img = img.quantize(int(mode[1:] or 256))
    else:
        img = img.convert(mode)
    path = tmp_path / f"{mode}.png"
    img.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


def _png_with_filter(path, rgb, kind, interlace=0):
    """An RGB PNG whose every row uses filter ``kind`` (0-4); ``interlace=1``
    only marks the header (the reader refuses the file from it)."""
    h, w, _ = rgb.shape
    raw = rgb.reshape(h, 3 * w).astype(np.int64)
    out = []
    for y in range(h):
        cur = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_png_reader_takes_each_row_filter_and_refuses_16_bit_and_interlaced(tmp_path):
    rgb = _image(21, 30, 2)
    for kind in range(5):
        path = tmp_path / f"filter{kind}.png"
        _png_with_filter(path, rgb, kind)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), rgb)
        np.testing.assert_array_equal(read_png(str(path)), rgb)
    write_png(str(tmp_path / "own.png"), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "own.png")), rgb)
    Image.fromarray(np.full((8, 8), 40000, np.uint16)).save(tmp_path / "deep.png")
    with pytest.raises(NotImplementedError, match="deep.png.*16-bit"):
        read_png(str(tmp_path / "deep.png"))
    _png_with_filter(tmp_path / "laced.png", rgb, 0, interlace=1)
    with pytest.raises(NotImplementedError, match="laced.png.*interlaced"):
        read_png(str(tmp_path / "laced.png"))


def test_resize_crop_matches_jax_resize_crop_down_and_up():
    """PIL's bicubic resampler in fixed point, two passes with a uint8
    round-and-clip after each: the port's copy gives PIL's bytes exactly
    (0 of the pixels off by one), center and random crops alike."""
    for h, w, size in ((130, 97, 64), (33, 45, 64), (60, 52, 32)):
        arr = _image(h, w, h)
        for seed in (None, 7):
            r_t = None if seed is None else np.random.default_rng(seed)
            r_j = None if seed is None else np.random.default_rng(seed)
            got, orig, crop = tdb.resize_crop(arr, size, r_t)
            want, orig_j, crop_j = jdb._resize_crop(arr, size, r_j)
            assert (orig, crop) == (orig_j, crop_j) and got.shape == (size, size, 3)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() == 0.0, (h, w, diff.max())
    np.testing.assert_array_equal(tdb.to_model_range(np.array([0, 255], np.uint8)),
                                  jdb.to_model_range(np.array([0, 255], np.uint8)))


def test_dreambooth_dataset_matches_jax_on_a_directory_of_pngs(tmp_path):
    for i, (h, w) in enumerate(((60, 52), (52, 64), (48, 48))):
        Image.fromarray(_image(h, w, i)).save(tmp_path / f"{i}.png")
    kw = dict(resolution=32, repeats=2, center_crop=False, random_flip=True, aug_pool=3, seed=5)
    got = tdb.DreamBoothDataset(str(tmp_path), "a sks dog", **kw)
    want = jdb.DreamBoothDataset(str(tmp_path), "a sks dog", **kw)
    assert len(got) == len(want) == 3 * 2 * 2 * 3 and got.num_source == want.num_source == 6
    assert got.original_sizes == want.original_sizes
    assert got.crop_top_lefts == want.crop_top_lefts
    np.testing.assert_allclose(np.stack(got.pixel_values), np.stack(want.pixel_values),
                               atol=1.0 / 127.5 + 1e-6, rtol=0)
    center = tdb.DreamBoothDataset(str(tmp_path), "a sks dog", 32)
    center_j = jdb.DreamBoothDataset(str(tmp_path), "a sks dog", 32)
    assert len(center) == 3 and center.crop_top_lefts == center_j.crop_top_lefts
    np.testing.assert_array_equal(np.stack(center.pixel_values), np.stack(center_j.pixel_values))


# ---------------------------------------------------------------------- #
# loss, scheduler spaces, update
# ---------------------------------------------------------------------- #


def test_dreambooth_pso_loss_matches_jax_for_both_losses_with_and_without_prior():
    r = np.random.default_rng(0)
    mw, ml, rw, rl = (r.random(4).astype(np.float32) for _ in range(4))
    for loss_type in ("pso", "pso_db"):
        for prior in (0.0, 0.5):
            want = jlosses.dreambooth_pso_loss(mw, ml, rw, rl, beta=5.0, loss_type=loss_type,
                                               neg_defactor=0.8, prior_loss_weight=prior)
            got = dreambooth_pso_loss(*map(torch.from_numpy, (mw, ml, rw, rl)), beta=5.0,
                                      loss_type=loss_type, neg_defactor=0.8,
                                      prior_loss_weight=prior)
            _close(got[0], want[0])
            _close(got[1], want[1])
    with pytest.raises(ValueError):
        dreambooth_pso_loss(torch.ones(2), torch.ones(2), None, None, 5.0, "pso")


def _jax_unet():
    cfg = junet.UNetConfig.tiny(lora_rank=RANK)
    model = junet.SDXLUNet(cfg)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, HW, HW, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, CTX, 32)), jnp.zeros((1, 16)),
                            jnp.zeros((1, 6)))

    def unet_apply(v, x, t, c, lora_scale):
        return model.apply(v, x, t, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    return model, shapes, unet_apply


def _port_pipe(variables):
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=RANK), device="cpu")
    unet.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return SDXLPipeline(unet=unet, vae=None, te1=None, te2=None)


def test_noise_and_precondition_matches_jax_in_every_space_and_prediction_type():
    r = np.random.default_rng(1)
    latents, noise, pred = (r.standard_normal((3, HW, HW, 4)).astype(np.float32)
                            for _ in range(3))
    t_eff = np.array([0, 250, 750], np.int32)
    for space in ("euler_edm", "edm", "ddpm"):
        for prediction in ("epsilon", "v_prediction"):
            cfg = dict(scheduler_space=space, prediction_type=prediction)
            jt = jdbp.DreamBoothPSOTrainer(jdbp.DreamBoothPSOConfig(**cfg), None,
                                           jts.make_optimizer())
            tt = DreamBoothPSOTrainer(DreamBoothPSOConfig(**cfg), None)
            want = jt._noise_and_precondition(jnp.asarray(latents), jnp.asarray(noise),
                                              jnp.asarray(t_eff))
            got = tt.noise_and_precondition(torch.from_numpy(latents), torch.from_numpy(noise),
                                            torch.from_numpy(t_eff).long())
            for g, w in zip(got[:5], want[:5]):
                _close(g, w)
            _close(got[5](torch.from_numpy(pred), got[2]), want[5](jnp.asarray(pred), want[2]))
            if space == "edm":  # c_noise = 0.25 ln sigma: fractional, negative at small sigma
                assert got[1][0] < 0 and got[1][0] != torch.round(got[1][0])


@pytest.fixture(scope="module")
def update_setup():
    model, shapes, unet_apply = _jax_unet()
    variables = _random_variables(shapes, 0, lora_b_std=0.05)
    r = np.random.default_rng(2)
    batch = {"instance_latents": r.standard_normal((GA, B, HW, HW, 4)).astype(np.float32),
             "negative_latents": r.standard_normal((GA, B, HW, HW, 4)).astype(np.float32),
             "cond": {"embeds": r.standard_normal((GA, B, CTX, 32)).astype(np.float32),
                      "pooled": r.standard_normal((GA, B, 16)).astype(np.float32),
                      "time_ids": np.tile(np.float32([512, 512, 0, 0, 512, 512]), (GA, B, 1))},
             "time_ids_win": np.tile(np.float32([600, 520, 44, 0, 512, 512]), (GA, B, 1)),
             "time_ids_lose": np.tile(np.float32([512, 512, 0, 0, 512, 512]), (GA, B, 1))}
    key = jax.random.key(9)
    idx, noise = [], []
    for k in jax.random.split(key, GA):  # the draws of the JAX update's scan
        k_t, k_n = jax.random.split(k)
        idx.append(np.asarray(jdbp.sample_lattice_timesteps(k_t, B, 1000, 4)))
        noise.append(np.asarray(jax.random.normal(k_n, (B, HW, HW, 4), jnp.float32)))
    return dict(unet_apply=unet_apply, variables=variables, batch=batch, key=key,
                idx=np.stack(idx), noise=np.stack(noise))


def _port_update(s, variables, **cfg):
    pipe = _port_pipe(variables)
    lora = lora_parameters(pipe.unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **HP))
    trainer = DreamBoothPSOTrainer(DreamBoothPSOConfig(grad_accum=GA, **cfg), pipe)
    tree = lambda x: ({k: tree(v) for k, v in x.items()} if isinstance(x, dict)
                      else torch.from_numpy(x))
    metrics = trainer.update(state, tree(s["batch"]), torch.from_numpy(s["idx"]).long(),
                             torch.from_numpy(s["noise"]))
    return state, metrics


@pytest.mark.parametrize("loss_type, fuse", [("pso_db", True), ("pso", True), ("pso", False)])
def test_update_matches_jax_update_impl(update_setup, loss_type, fuse):
    s = update_setup
    cfg = dict(loss_type=loss_type, fuse_ref_pass=fuse)
    tx = jts.make_optimizer(**HP)
    jtrainer = jdbp.DreamBoothPSOTrainer(jdbp.DreamBoothPSOConfig(grad_accum=GA, **cfg),
                                         s["unet_apply"], tx)
    jstate = jts.PSOTrainState.create(s["variables"]["lora"], tx)
    jbatch = jax.tree.map(jnp.asarray, s["batch"])
    jnew, jaux = jax.jit(jtrainer._update_impl)(jstate, s["variables"]["params"], jbatch,
                                                s["key"])
    state, metrics = _port_update(s, s["variables"], **cfg)
    for k in ("loss", "win_loss", "lose_loss", "implicit_acc"):
        _close(np.float32(metrics[k]), jaux[k])
    assert state.step == int(jnew.step) == 1
    want = state_dict_from_jax({"params": {}, "lora": jnew.lora}, "unet", n_levels=2)
    assert set(want) == set(state.lora)
    for k, v in want.items():
        _close(state.lora[k], v)
    before = state_dict_from_jax({"params": {}, "lora": s["variables"]["lora"]}, "unet",
                                 n_levels=2)
    assert max(float((state.lora[k].detach() - before[k]).abs().max()) for k in before) > 1e-5


def test_pso_first_step_is_log_2_plus_the_prior_term(update_setup):
    """A fresh adapter (LoRA B = 0): policy = reference, every logit 0, so
    loss - prior_loss_weight * lose_loss = log 2, fused or not."""
    s = update_setup
    def zero_b(node):
        return {k: zero_b(v) if isinstance(v, dict) else (v * 0 if k == "b" else v)
                for k, v in node.items()}

    fresh = {"params": s["variables"]["params"], "lora": zero_b(s["variables"]["lora"])}
    for fuse in (True, False):
        _, m = _port_update(s, fresh, loss_type="pso", fuse_ref_pass=fuse, prior_loss_weight=0.5)
        assert m["implicit_acc"] == 0.0
        assert abs(m["loss"] - 0.5 * m["lose_loss"] - math.log(2.0)) < 1e-6


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #


def _instance_dir(tmp_path):
    d = tmp_path / "instance"
    d.mkdir()
    for i, (h, w) in enumerate(((44, 38), (38, 46))):
        write_png(str(d / f"{i}.png"), _image(h, w, 10 + i))
    return d


def _cli(tmp_path, *extra):
    return ["--tiny", "--device", "cpu", "--instance_data_dir", str(tmp_path / "instance"),
            "--instance_prompt", "a photo of sks dog", "--class_prompt", "a photo of dog",
            "--output_dir", str(tmp_path / "out"), "--rank", str(RANK), "--num_negatives", "3",
            "--sample_batch_size", "2", "--gradient_accumulation_steps", "2", *extra]


def _jax_lora_tree(port_lora):
    """The JAX tiny UNet's LoRA collection holding the port's adapter values."""
    _, shapes, _ = _jax_unet()

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            else:
                key = unet_param_map(path + ("kernel",), n_levels=2)[0][:-len("weight")]
                key += {"a": "lora.down.weight", "b": "lora.up.weight"}[k]
                out[k] = port_lora[key].numpy().T
        return out

    return walk(shapes["lora"], ())


def test_cli_tiny_run_validates_checkpoints_resumes_and_exports_the_jax_layout(tmp_path):
    _instance_dir(tmp_path)
    out = tmp_path / "out"
    state, history, _ = cli.main(_cli(tmp_path, "--max_train_steps", "1", "--validation_steps",
                                      "1", "--num_validation_images", "1",
                                      "--checkpointing_steps", "1", "--gradient_checkpointing"))
    assert state.step == 1 and len(history) == 1 and math.isfinite(history[0]["loss"])
    gen = out / "gen_1"
    assert sorted(p.name for p in gen.iterdir()) == [f"p_{i:03d}" for i in range(1, 26)]
    for p in gen.iterdir():
        assert [f.name for f in p.iterdir()] == ["img_01.png"]
        assert read_png(str(p / "img_01.png")).shape == (32, 32, 3)
    state2, history2, pipe = cli.main(_cli(tmp_path, "--max_train_steps", "2",
                                           "--resume_from_checkpoint", "latest",
                                           "--skip_validation"))
    assert state2.step == 2 and len(history2) == 1 and not (out / "gen_2").exists()
    assert Path(latest_checkpoint(str(out))).name == "checkpoint-2"
    exported = load_file(str(out / "lora-2" / LORA_FILE))
    lora = {k: v.detach() for k, v in lora_parameters(pipe.unet).items()}
    want = jls.export_sdxl_lora_safetensors({"unet": _jax_lora_tree(lora)}, n_levels=2)
    assert set(exported) == set(want) and len(want) == len(lora)
    for k, w in want.items():
        assert exported[k].dtype == torch.float32 and np.array_equal(exported[k].numpy(), w), k
    # the step-1 file holds the adapter checkpoint-1 restores
    first = load_file(str(out / "lora-1" / LORA_FILE))
    restored = PSOTrainState.create(lora_parameters(pipe.unet),
                                    make_optimizer(lora_parameters(pipe.unet)))
    restore_train_state(str(out / "checkpoint-1"), restored)
    assert all(torch.equal(first["unet." + k], v.detach()) for k, v in restored.lora.items())


REFUSED_FLAGS = (["--fast_init"],)


def test_cli_refuses_unported_flags_before_building_a_model(tmp_path, monkeypatch):
    monkeypatch.setattr(SDXLPipeline, "random", None)  # a model built would fail otherwise
    _instance_dir(tmp_path)
    for flags in REFUSED_FLAGS:
        with pytest.raises(NotImplementedError, match=flags[0]):
            cli.main(_cli(tmp_path, *flags))


def test_cli_refuses_jpeg_webp_and_bmp_files_and_runs_only_where_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(SDXLPipeline, "random", None)
    for ext in (".jpg", ".JPEG", ".webp", ".bmp"):
        d = _instance_dir(tmp_path)
        (d / f"photo{ext}").write_bytes(b"refused by its extension")
        with pytest.raises(NotImplementedError, match=f"photo{ext}.*PNG"):
            cli.main(_cli(tmp_path))
        cls = tmp_path / "class"
        cls.mkdir()
        (d / f"photo{ext}").rename(cls / f"photo{ext}")
        with pytest.raises(NotImplementedError, match=f"photo{ext}"):
            cli.main(_cli(tmp_path, "--with_prior_preservation", "--class_data_dir", str(cls)))
        for p in (d, cls):
            for f in p.iterdir():
                f.unlink()
            p.rmdir()
    if not torch.cuda.is_available():  # the CLI runs on CUDA unless asked for the CPU
        _instance_dir(tmp_path)
        argv = _cli(tmp_path)
        argv.remove("--device")
        argv.remove("cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_chip_smoke_launch_counts_match_the_tiny_dreambooth_runs(tmp_path):
    """The launch counts chip_smoke.py expects of a DreamBooth CLI run equal
    the kernel-wrapper calls the run makes (counted here on the CPU, where
    the wrappers take their plain versions): the pso_db run with remat, a
    validation and a resume, the pso run with prior preservation (class
    images generated) and the fused reference pass, and the pso run with
    DoRA (its reference pass a forward of its own) and text-encoder LoRA
    (the causal text towers take no kernel; under remat every ResnetBlock
    is recomputed, the trained conditioning reaching them all), with a
    validation."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _instance_dir(tmp_path)
    runs = [("a1", ["--max_train_steps", "1", "--validation_steps", "1",
                    "--num_validation_images", "1", "--gradient_checkpointing"]),
            ("a2", ["--max_train_steps", "2", "--validation_steps", "1",
                    "--num_validation_images", "1", "--gradient_checkpointing",
                    "--resume_from_checkpoint", "latest"]),
            ("b", ["--max_train_steps", "1", "--loss_type", "pso", "--scheduler_space", "edm",
                   "--with_prior_preservation", "--class_data_dir", str(tmp_path / "class"),
                   "--num_class_images", "3", "--center_crop", "--skip_validation"]),
            ("c", ["--max_train_steps", "1", "--loss_type", "pso", "--use_dora",
                   "--train_text_encoder", "--optimizer", "prodigy", "--learning_rate", "1.0",
                   "--gradient_checkpointing",
                   "--validation_steps", "1", "--num_validation_images", "1",
                   "--output_dir", str(tmp_path / "out_c")])]
    for name, extra in runs:
        argv = _cli(tmp_path, *extra)
        with cs.ShapeRecorder() as rec:
            state, history, pipe = cli.main(argv)
        args = cli.parse_args(argv)
        want = cs.expected_dreambooth_launches(pipe, args, instance_images=2,
                                               steps=len(history),
                                               first_step=state.step - len(history))
        got = {"flash_attn_fwd": sum(rec.attention.values()),
               "flash_attn_bwd_pre": sum(rec.attention_bwd.values()),
               "flash_attn_bwd": sum(rec.attention_bwd.values()),
               "flash_attn_bwd_post": sum(n for (qs, ks, _), n in rec.attention_bwd.items()
                                          if cs.bwd_needs_post(qs, ks[1])),
               "gn_stats": sum(rec.gn.values()), "gn_silu_norm": sum(rec.gn.values())}
        assert got == want, name
        assert all(math.isfinite(m["loss"]) for m in history), name
