"""The port's opt-in int8 and subpixel paths (``ops/qconv.py``,
``ops/upsample.py``) and ``fast_init`` vs the JAX package, fp32 on the CPU.

The same numpy inputs go through the JAX function and the port's (whose CPU
tensors take the kernels' plain versions). The quantized integers and
scales are held equal to JAX's: the JAX ones are caught where its
``int8_matmul`` / ``int8_conv2d`` hand them to ``lax.dot_general`` /
``lax.conv_general_dilated``. Outputs are held at the port's ATOL 3e-5 /
RTOL 2e-4 unless a test states another limit and its reason. Models are the
tiny configs; each JAX apply is jitted once where it runs more than once.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.models import clip as jclip
from pairwise_sample_optimization_tpu.models import unet as junet
from pairwise_sample_optimization_tpu.models import vae as jvae
from pairwise_sample_optimization_tpu.ops import qconv as jq
from pairwise_sample_optimization_tpu.ops import upsample as jup
from pairwise_sample_optimization_tpu.train import online_pso as jpso
from pairwise_sample_optimization_tpu.train import train_state as jts
from pairwise_sample_optimization_tpu_torch.checkpoints import state_dict_from_jax
from pairwise_sample_optimization_tpu_torch.models import clip as tclip
from pairwise_sample_optimization_tpu_torch.models import unet as tunet
from pairwise_sample_optimization_tpu_torch.models import vae as tvae
from pairwise_sample_optimization_tpu_torch.ops import qconv as tq
from pairwise_sample_optimization_tpu_torch.ops import upsample as tup

ATOL, RTOL = 3e-5, 2e-4


@pytest.fixture(autouse=True)
def _knobs_off_and_one_thread():
    """Every process-wide knob off after each test (the JAX package's and the
    port's), and one torch thread for these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for mod, sub in ((jq, jup), (tq, tup)):
        mod.set_use_int8_decode(False)
        mod.set_use_int8_scorer(False)
        mod.set_int8_smooth_alpha(None)
        sub.set_use_subpixel(False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _jax_ints(monkeypatch, call):
    """``call()`` of a JAX qconv function, and the int8 operands it handed to
    ``lax.dot_general`` / ``lax.conv_general_dilated``."""
    seen = []

    def catch(fn):
        def wrapped(a, b, *args, **kw):
            seen.append((np.asarray(a), np.asarray(b)))
            return fn(a, b, *args, **kw)
        return wrapped

    lax = jax.lax
    monkeypatch.setattr(jq, "lax", types.SimpleNamespace(
        dot_general=catch(lax.dot_general), conv_general_dilated=catch(lax.conv_general_dilated)))
    out = call()
    monkeypatch.setattr(jq, "lax", lax)
    (xq, wq), = seen
    assert xq.dtype == np.int8 and wq.dtype == np.int8
    return out, xq, wq


# (bias, the tokens' leading shape): M = 34, and M = 16, which the card's
# int8 matmul takes where torch._int_mm's CUDA rule (M > 16) did not
@pytest.mark.parametrize("with_bias,lead", [(False, (2, 17)), (True, (2, 17)), (True, (1, 16))],
                         ids=["False", "True", "True-m16"])
def test_int8_matmul_ints_scales_and_output_equal_jax(monkeypatch, with_bias, lead):
    r = np.random.default_rng(0)
    x = (r.standard_normal(lead + (48,)).astype(np.float32)
         * np.linspace(0.1, 3, 48, dtype=np.float32))
    w = (r.standard_normal((48, 24)) * 0.2).astype(np.float32)  # JAX (C, O)
    b = r.standard_normal(24).astype(np.float32) if with_bias else None
    want, jxq, jwq = _jax_ints(monkeypatch, lambda: jq.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b)))
    tx, tw = torch.from_numpy(x).reshape(-1, 48), torch.from_numpy(w.T.copy())
    xq, sx = tq.quantize_rows(tx, tq.absmax(tx, "rows"))
    wq, sw = tq.quantize_rows(tw, tq.absmax(tw, "rows"))
    np.testing.assert_array_equal(xq.numpy(), jxq.reshape(-1, 48))
    np.testing.assert_array_equal(wq.numpy(), jwq.T)
    # JAX's scales, computed as its lines 115-116 compute them
    np.testing.assert_array_equal(sx.numpy(), np.asarray(
        jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=-1), 1e-8) / 127.0).reshape(-1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(
        jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w)), axis=0), 1e-8) / 127.0))
    got = tq.int8_matmul(torch.from_numpy(x), tw, None if b is None else torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_int8_conv2d_ints_scales_and_output_equal_jax(monkeypatch, alpha):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 6, 5, 16)).astype(np.float32)  # JAX NHWC
    x[..., 3] *= 40.0  # a hot channel, as a GroupNorm affine makes
    x[..., 7] = 0.0  # a channel the activations never use (SmoothQuant's m = 1)
    k = (r.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)  # HWIO
    b = r.standard_normal(8).astype(np.float32)
    want, jxq, jwq = _jax_ints(monkeypatch, lambda: jq.int8_conv2d(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), smooth_alpha=alpha))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tw = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()  # (O, C, 3, 3)
    m = None if alpha is None else tq.smooth_divisor(tx, tw, alpha)
    xq, sx = tq.quantize_nhwc(tx, tq.absmax(tx, "samples", m), m)
    w_rows = (tw if m is None else tw * m.view(1, -1, 1, 1)).permute(0, 2, 3, 1).reshape(8, -1)
    wq, sw = tq.quantize_rows(w_rows.contiguous(), tq.absmax(w_rows.contiguous(), "rows"))
    jw_rows = jwq.transpose(3, 0, 1, 2).reshape(8, -1)  # HWIO -> (O, taps, C)
    if alpha is None:  # the exact-integer case: every int equal
        np.testing.assert_array_equal(xq.numpy(), jxq)
        np.testing.assert_array_equal(wq.numpy(), jw_rows)
        np.testing.assert_array_equal(sx.numpy(), np.asarray(
            jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=(1, 2, 3)), 1e-8) / 127.0))
        tol = (ATOL, RTOL)
    else:
        # torch.pow and jnp.power may differ by an ulp in m, which can move a
        # value across a rounding tie: ints within 1 of JAX's, at most 1 in
        # 500 moved; the output then within one step of one weight on one
        # activation, s_x * s_w * 127 ~ 1e-2 of |y|'s max here
        for got_q, want_q in ((xq.numpy(), jxq), (wq.numpy(), jw_rows)):
            moved = np.abs(got_q.astype(int) - want_q.astype(int))
            assert moved.max() <= 1 and moved.mean() <= 2e-3
        tol = (1e-2 * float(np.abs(np.asarray(want)).max()), 0.0)
    got = tq.int8_conv2d(tx, tw, torch.from_numpy(b), smooth_alpha=alpha)
    _close(got.permute(0, 2, 3, 1), want, *tol)


@pytest.mark.parametrize("op", ["conv", "matmul"])
def test_int8_exact_on_representable_values_as_jax(op):
    """JAX ``tests/test_qconv.py``'s exact cases: integers within +-127 on
    grids of step 1 quantize losslessly, so the int8 result is the exact
    product, for the port as for JAX (atol 0)."""
    r = np.random.default_rng(0)
    if op == "conv":
        x = r.integers(-127, 128, (2, 6, 6, 4)).astype(np.float32)
        k = r.integers(-127, 128, (3, 3, 4, 5)).astype(np.float32)
        x[0, 0, 0, 0], x[1, 0, 0, 0], k[0, 0, 0] = 127.0, -127.0, 127.0
        b = np.arange(5, dtype=np.float32)
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
        jgot = jq.int8_conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
        got = tq.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                             torch.from_numpy(k).permute(3, 2, 0, 1).contiguous(),
                             torch.from_numpy(b)).permute(0, 2, 3, 1)
    else:
        x = r.integers(-127, 128, (2, 5, 8)).astype(np.float32)
        w = r.integers(-127, 128, (8, 6)).astype(np.float32)
        x[..., 0], w[0] = 127.0, 127.0
        b = np.arange(6, dtype=np.float32)
        want = x @ w + b
        jgot = jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(np.asarray(jgot), want)


def _absmax_as_the_kernel_reads(x, offset, mode, div, sms):
    """Q1a's grid, blocks, row groups, splits, segments and 16-byte loads
    (``csrc/int8_conv.cu::q8_absmax_kernel`` under ``absmax_plan``) walked
    over ``x`` flattened, its element 0 ``offset`` elements past a 16-byte
    boundary: how often each element is read, and each row's maximum of
    |x (/ div)| in fp32 as the kernel takes it."""
    flat = x.reshape(-1).float().numpy()  # bf16's values are exact in fp32
    vec = 16 // x.element_size()
    rows, row_stride, n_seg, seg_len, seg_stride = tq.absmax_geometry(x.shape, mode,
                                                                      div is not None)
    tpr, splits, chunk = tq.absmax_plan(rows, n_seg * seg_len, sms)
    reads = np.zeros(flat.size, np.int64)
    partial = np.zeros((rows, splits), np.float32)
    for blk in range(-(-rows // (256 // tpr)) * splits):
        split = blk % splits
        lo, hi = split * chunk, min(split * chunk + chunk, n_seg * seg_len)
        assert lo < hi  # no empty block
        for row in range((blk // splits) * (256 // tpr), (blk // splits + 1) * (256 // tpr)):
            if row >= rows:
                continue
            s = lo // seg_len
            while s * seg_len < hi:
                a, b = max(lo, s * seg_len) - s * seg_len, min(hi, (s + 1) * seg_len) - s * seg_len
                start, n = row * row_stride + s * seg_stride + a, b - a
                mis = (offset + start) % vec
                head = min(n, vec - mis if mis else 0)
                nv = (n - head) // vec
                assert (offset + start + head) % vec == 0 and n - head - nv * vec < vec
                piece = flat[start:start + n]
                if div is not None:
                    piece = piece / div[s]
                reads[start:start + n] += 1
                partial[row, split] = max(partial[row, split], np.abs(piece).max())
                s += 1
    return reads, partial.max(axis=1)


@pytest.mark.parametrize("mode, shape, dtype, divided, offset, sms", [
    ("rows", (37, 1001), torch.bfloat16, False, 1, 132),
    ("samples", (3, 5, 17, 19), torch.float32, True, 2, 2),
    ("channels", (4, 6, 9, 11), torch.bfloat16, False, 3, 2)])
def test_absmax_plan_reads_each_element_once_and_equals_plain_and_jax(
        monkeypatch, mode, shape, dtype, divided, offset, sms):
    """Q1a's one-launch plan (``absmax_plan``, ``absmax_geometry``): its
    blocks read every element of every row exactly once, in 16-byte loads
    from aligned addresses between scalar heads and tails, and the rows'
    maxima over the blocks' partial maxima equal the plain version's bit for
    bit and JAX's (``jnp.max(jnp.abs(...))``, ``ops/qconv.py``). Two cases
    take a card of 2 SMs and small chunks, so that rows split over blocks
    and chunks cross segments; the plan's bounds hold at the paths' sizes."""
    if sms == 2:
        monkeypatch.setattr(tq, "ABSMAX_LOADS", 1)
        monkeypatch.setattr(tq, "ABSMAX_MIN_CHUNK", 64)
    r = np.random.default_rng(7)
    x = torch.from_numpy((r.standard_normal(shape) * 1.7 + 0.1).astype(np.float32)).to(dtype)
    div = (r.random(shape[1]) + 0.5).astype(np.float32) if divided else None
    reads, got = _absmax_as_the_kernel_reads(x, offset, mode, div, sms)
    assert (reads == 1).all()
    want = tq.absmax_plain(x, mode, None if div is None else torch.from_numpy(div))
    assert np.array_equal(got, want.numpy())
    xf = jnp.asarray(x.float().numpy())
    if mode == "rows":
        jwant = jnp.max(jnp.abs(xf), axis=-1)
    elif mode == "samples":
        jwant = jnp.max(jnp.abs(xf / jnp.asarray(div).reshape(1, -1, 1, 1)), axis=(1, 2, 3))
    else:
        jwant = jnp.max(jnp.abs(xf), axis=(0, 2, 3))
    assert np.array_equal(got, np.asarray(jwant))
    for rows, row_len in ((8192, 640), (320, 2880), (2, 320 * 64 * 64), (1, 128 * 1024 * 1024),
                          (512, 128 * 128), (3, 1001)):
        tpr, splits, chunk = tq.absmax_plan(rows, row_len, sms)
        assert tpr in (32, 64, 128, 256) and (splits - 1) * chunk < row_len <= splits * chunk
        waves = 2 if rows * row_len > tq.ABSMAX_TWO_WAVES else 1
        assert splits == 1 or (tpr == 256 and chunk % 8 == 0
                               and rows * splits <= waves * sms * tq.ABSMAX_BLOCKS_PER_SM + rows)


def test_int8_has_no_gradient():
    x = torch.randn(2, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tq.int8_matmul(x, torch.randn(8, 8))
    with torch.no_grad():
        assert tq.int8_matmul(x, torch.randn(8, 8)).shape == (2, 4, 8)


# ---------------------------------------------------------------------- #
# models
# ---------------------------------------------------------------------- #


def _params(shapes, seed, lora_b=0.0):
    """Params in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms identity, small biases, LoRA A with std 1/rank and
    B gaussian with std ``lora_b``."""
    r = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "b":
            return (r.standard_normal(shape) * lora_b).astype(np.float32)
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


UNET_RANK = 2


def _unet_inputs(r, n):
    return (r.standard_normal((n, 8, 8, 4)).astype(np.float32),
            np.array([999, 499, 17, 250][:n], np.float32),
            r.standard_normal((n, 5, 32)).astype(np.float32),
            r.standard_normal((n, 16)).astype(np.float32),
            np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (n, 1)))


@pytest.fixture(scope="module")
def unet_pair():
    model = junet.SDXLUNet(junet.UNetConfig.tiny(lora_rank=UNET_RANK))
    r = np.random.default_rng(0)
    inputs = _unet_inputs(r, 2)
    shapes = jax.eval_shape(model.init, jax.random.key(0), *(jnp.asarray(v[:1]) for v in inputs))
    variables = _params(shapes, 1, lora_b=0.05)
    port = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=UNET_RANK), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, "unet", n_levels=2), strict=True)
    return model, variables, port, inputs


def _port_unet_apply(port, inputs, lora_scale):
    x, t, ehs, pooled, tids = map(torch.from_numpy, inputs)
    with torch.no_grad():
        return port(x.permute(0, 3, 1, 2), t, ehs, pooled, tids,
                    lora_scale=lora_scale).permute(0, 2, 3, 1)


# A model's int8 forward against JAX's. Every op's integers are JAX's
# wherever the fp32 activations entering its quantize agree bit for bit
# (the ops' tests above). Through a model the frameworks' fp32 sums differ
# by ulps, and an activation within an ulp of a rounding tie lands one step
# apart; each later quantize then sees a slightly moved input, and the move
# spreads: one such flip at the 28th of the tiny UNet's 65 int8 ops moves
# its output by 2.2% of its max on other inputs, as far as int8 is from
# fp32. So the model-level checks here run
# on fixed inputs on which no quantize meets a tie (the UNet and the
# smoothed decode agree to 5e-7; the plain decode shows one late flip,
# 1.05e-3), at 2e-3 of the output's max; a routing or scaling fault moves
# outputs by 1e-2 or more. The routing checks hold the int8 forward's own
# distance from the plain one above 4x that limit and below int8's band
# (0.1 of the max).
UNET_INT8_TOL = 2e-3


def _routed(got, plain, want):
    """The int8 output is far from the plain one next to the limit above,
    and within int8's band of it."""
    scale = float(np.abs(_np(want)).max())
    dist = float(np.abs(_np(got) - _np(plain)).max())
    assert 4 * UNET_INT8_TOL * scale < dist < 0.1 * scale, (dist, scale)


def test_unet_int8_ref_pass_matches_jax_and_routes(unet_pair):
    model, variables, port, inputs = unet_pair
    j_in = [jnp.asarray(v) for v in inputs]
    with jq.int8_ref_pass():  # a trace-time scope: jit inside it
        want = np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, lora_scale=0.0))(
            variables, *j_in))
    with tq.int8_ref_pass():
        got = _port_unet_apply(port, inputs, 0.0)
    scale = float(np.abs(want).max())
    _close(got, want, UNET_INT8_TOL * scale, 0.0)
    # outside the scope the plain forward (held against JAX's in
    # test_torch_port_models.py)
    _routed(got, _port_unet_apply(port, inputs, 0.0), want)


@pytest.fixture(scope="module")
def vae_pair():
    model = jvae.AutoencoderKL(jvae.VAEConfig.tiny())
    variables = _params(jax.eval_shape(model.init, jax.random.key(2), jnp.zeros((1, 16, 16, 3)),
                                       jax.random.key(3)), 2)
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny(), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"], "vae"), strict=True)
    r = np.random.default_rng(4)
    z = r.standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.5
    img = r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    decode = lambda: np.asarray(jax.jit(lambda v, z_: model.apply(v, z_, method=model.decode))(
        variables, jnp.asarray(z)))
    jmean, _ = jax.jit(lambda v, x: model.apply(v, x, method=model.encode))(
        variables, jnp.asarray(img))
    return port, z, img, decode, decode(), jmean


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_vae_int8_decode_matches_jax_and_the_encoder_does_not_quantize(vae_pair, alpha):
    port, z, img, decode, plain, jmean = vae_pair
    jq.set_use_int8_decode(True)
    jq.set_int8_smooth_alpha(alpha)
    want = decode()
    tq.set_use_int8_decode(True)
    tq.set_int8_smooth_alpha(alpha)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        mean, _ = port.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
    # 9 quantized convs deep: the tie argument of UNET_INT8_TOL; with the
    # migration also torch.pow's ulp (test_int8_conv2d_ints_...)
    _close(got, want, UNET_INT8_TOL * float(np.abs(want).max()), 0.0)
    _routed(got, plain, want)
    _close(mean.permute(0, 2, 3, 1), jmean)  # the encoder stays fp32 under the knob


@pytest.fixture(scope="module")
def clip_vision():
    jcfg = jclip.CLIPVisionConfig.tiny()
    pixels = np.random.default_rng(7).standard_normal((2, 28, 28, 3)).astype(np.float32)
    variables = _params(jax.eval_shape(jclip.CLIPVisionTower(jcfg).init, jax.random.key(8),
                                       jnp.asarray(pixels)), 8)
    plain = np.asarray(jax.jit(jclip.CLIPVisionTower(jcfg).apply)(variables, jnp.asarray(pixels)))
    return variables, pixels, plain


@pytest.mark.parametrize("route", ["config", "override"])
def test_clip_vision_int8_mlp_matches_jax(clip_vision, route):
    variables, pixels, plain = clip_vision
    jcfg, tcfg = jclip.CLIPVisionConfig.tiny(), tclip.CLIPVisionConfig.tiny()
    if route == "config":
        jcfg = dataclasses.replace(jcfg, int8_mlp=True)
        tcfg = dataclasses.replace(tcfg, int8_mlp=True)
    if route == "override":
        jq.set_use_int8_scorer(True)
        tq.set_use_int8_scorer(True)
    want = np.asarray(jax.jit(jclip.CLIPVisionTower(jcfg).apply)(variables, jnp.asarray(pixels)))
    port = tclip.CLIPVisionTower(tcfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"], "clip_vision"), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(pixels).permute(0, 3, 1, 2))
    _close(got, want, UNET_INT8_TOL * float(np.abs(want).max()), 0.0)
    _routed(got, plain, want)
    # a text tower never quantizes under the override
    ids = torch.randint(1, 999, (2, 77))
    text = tclip.CLIPTextTower(tclip.CLIPTextConfig.tiny(), device="cpu")
    with torch.no_grad():
        on = text(ids)["projected"]
        tq.set_use_int8_scorer(False)
        assert torch.equal(on, text(ids)["projected"])


def test_subpixel_matches_jax_and_the_naive_path_with_gradients():
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 5, 6, 8)).astype(np.float32)  # NHWC
    k = (r.standard_normal((3, 3, 8, 4)) * 0.2).astype(np.float32)
    b = r.standard_normal(4).astype(np.float32)
    g = r.standard_normal((2, 10, 12, 4)).astype(np.float32)
    jup.set_use_subpixel(True)

    def jloss(x_, k_, b_):
        return jnp.sum(jup.upsample2x_conv3x3(x_, k_, b_) * g)

    want = np.asarray(jax.jit(jup.upsample2x_conv3x3)(jnp.asarray(x), jnp.asarray(k),
                                                      jnp.asarray(b)))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(k),
                                                      jnp.asarray(b))
    outs, grads = {}, {}
    for subpixel in (True, False):
        tup.set_use_subpixel(subpixel)
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
        tw = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
        y = tup.upsample2x_conv3x3(tx, tw, torch.from_numpy(b))
        (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
        outs[subpixel] = y.permute(0, 2, 3, 1)
        grads[subpixel] = (tx.grad.permute(0, 2, 3, 1), tw.grad.permute(2, 3, 1, 0))
    _close(outs[True], want)
    _close(outs[True], outs[False])
    for got, naive, jg in zip(grads[True], grads[False], jgrads):
        _close(got, jg)
        _close(got, naive)
    # the collapsed kernel is JAX's, parity-major
    k4 = tup.subpixel_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    jk4 = np.asarray(jax.jit(jup._subpixel_kernel)(jnp.asarray(k)))  # (2, 2, C, 4, O)
    np.testing.assert_array_equal(k4.view(4, 4, 8, 2, 2).permute(3, 4, 2, 0, 1).numpy(), jk4)


# ---------------------------------------------------------------------- #
# the trainer, the runner, DreamBooth
# ---------------------------------------------------------------------- #


def test_turbo_update_with_int8_ref_pass_matches_jax(unet_pair):
    """One update of 2 x 3 microbatches with the int8 reference pass on a
    trained adapter: loss, grad_norm and the updated LoRA against JAX's
    ``_update`` with ``int8_ref_pass``. The loss and the gradient norm are
    held at 1e-3 relative (``UNET_INT8_TOL``'s reason: the reference
    log-probs are as close as the int8 forwards), the updated LoRA (lr 1e-4
    steps) at the port's tolerance."""
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline
    from pairwise_sample_optimization_tpu_torch.train import (OnlinePSOConfig, OnlinePSOTrainer,
                                                              PSOTrainState, lora_parameters,
                                                              make_optimizer)

    model, variables, port, _ = unet_pair
    ga, bs, steps = 2, 1, 4
    t = steps - 1
    r = np.random.default_rng(11)
    n = ga * bs
    lat = lambda: r.standard_normal((n, 2, t, 8, 8, 4)).astype(np.float32)
    samples = {"latents": lat(), "next_latents": lat(), "input_latents": lat(),
               "log_probs": np.zeros((n, 2, t), np.float32),
               "step_indices": np.tile(np.arange(t, dtype=np.int32), (n, 1)),
               "timesteps": np.tile(np.array([999, 749, 499], np.int32), (n, 1)),
               "rewards": r.standard_normal((n, 2, 1)).astype(np.float32)}
    _, _, ctx, pooled, tids = _unet_inputs(r, n)
    cond = {"embeds": ctx, "pooled": pooled, "time_ids": tids}
    per = lambda tree: {k: v.reshape((ga, bs) + v.shape[1:]) for k, v in tree.items()}
    hp = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=1e-6,
              max_grad_norm=1.0)

    def unet_apply(v, x, t_, c, lora_scale):
        return model.apply(v, x, t_, c["embeds"], c["pooled"], c["time_ids"],
                           lora_scale=lora_scale)

    tx = jts.make_optimizer(**hp)
    jtrainer = jpso.OnlinePSOTrainer(jpso.OnlinePSOConfig(
        num_steps=steps, train_batch_size=bs, grad_accum=ga, int8_ref_pass=True),
        unet_apply, tx, donate=False)
    jnew, jm = jtrainer._update(jts.PSOTrainState.create(variables["lora"], tx),
                                variables["params"],
                                {k: jnp.asarray(v) for k, v in per(samples).items()},
                                {k: jnp.asarray(v) for k, v in per(cond).items()},
                                jax.random.key(5))
    unet = tunet.SDXLUNet(tunet.UNetConfig.tiny(lora_rank=UNET_RANK), device="cpu")
    unet.load_state_dict(port.state_dict())
    trainer = OnlinePSOTrainer(OnlinePSOConfig(num_steps=steps, train_batch_size=bs,
                                               grad_accum=ga, int8_ref_pass=True),
                               SDXLPipeline(unet=unet, vae=None, te1=None, te2=None))
    lora = lora_parameters(unet)
    state = PSOTrainState.create(lora, make_optimizer(lora, **hp))
    m = trainer.update(state, {k: torch.from_numpy(v) for k, v in per(samples).items()},
                       {k: torch.from_numpy(v) for k, v in per(cond).items()})
    assert abs(m["loss"] - math.log(2.0)) > 1e-4  # the trained adapter: policy != reference
    for key in ("loss", "grad_norm", "ratio_win"):
        _close(np.float32(m[key]), jm[key], 0.0, 1e-3)
    want = state_dict_from_jax({"params": {}, "lora": jnew.lora}, "unet", n_levels=2)
    assert set(want) == set(state.lora)
    for k_ in want:
        _close(state.lora[k_], want[k_])


def test_fast_init_towers_are_all_zero():
    from pairwise_sample_optimization_tpu_torch.rewards import AestheticScorer, ImageRewardScorer
    from pairwise_sample_optimization_tpu_torch.pipeline import SDXLPipeline

    pipe = SDXLPipeline.random(lora_rank=2, tiny=True, dtype=torch.float32, device="cpu",
                               fast_init=True)
    towers = [pipe.unet, pipe.vae, pipe.te1, pipe.te2, pipe.scorer.model,
              AestheticScorer.random(tclip.CLIPVisionConfig.tiny(), device="cpu",
                                     fast_init=True).vision]
    assert all(not p.detach().any() for m in towers for p in m.parameters())
    assert any(".lora." in k for k in pipe.unet.state_dict())
    ir = ImageRewardScorer.random(*_tiny_imagereward_configs(), device="cpu", fast_init=True)
    assert all(not p.detach().any() for m in (ir.vit, ir.bert, ir.mlp) for p in m.parameters())


def _tiny_imagereward_configs():
    from pairwise_sample_optimization_tpu_torch.models.bert import BertConfig
    from pairwise_sample_optimization_tpu_torch.models.vit import ViTConfig

    return ViTConfig.tiny(), BertConfig.tiny()


# every knob the runner refused before it took them, as the JAX runner
# takes them: each runs one tiny epoch on the CPU
FORMER_REFUSALS = {
    "turbo-int8_ref_pass": ("turbo", ["train.int8_ref_pass=True"]),
    "dmd-int8_decode-smooth-subpixel": ("dmd", ["kernels.int8_vae_decode=True",
                                                "kernels.int8_smooth_alpha=0.5",
                                                "kernels.subpixel_upsample=True"]),
    "turbo-fast_init": ("turbo", ["fast_init=True"]),
}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("name", list(FORMER_REFUSALS))
def test_runner_takes_every_former_refused_knob(tmp_path, monkeypatch, name):
    """Each runs a tiny epoch with the knob set as the JAX runner sets it,
    and the launch counts chip_smoke.py expects of it (the int8 kernels'
    too) equal the kernel-wrapper calls the run makes on the CPU."""
    from pairwise_sample_optimization_tpu_torch.cli import online_runner
    from pairwise_sample_optimization_tpu_torch.cli.train_online_pso_sdxl_turbo import (
        build_config)
    from pairwise_sample_optimization_tpu_torch.train.online_pso import OnlinePSOTrainer

    cs = _chip_smoke()
    sampler, overrides = FORMER_REFUSALS[name]
    config = build_config(True, [f"output_dir={tmp_path}", "checkpointing_steps=0",
                                 *overrides])
    seen = {}
    make = OnlinePSOTrainer.__init__

    def spy(self, cfg, pipe):
        seen.update(int8_ref_pass=cfg.int8_ref_pass, decode=tq.use_int8_decode(),
                    alpha=tq._SMOOTH_ALPHA, subpixel=tup._USE_SUBPIXEL,
                    zero=not any(p.detach().any() for p in pipe.unet.parameters()))
        make(self, cfg, pipe)

    monkeypatch.setattr(OnlinePSOTrainer, "__init__", spy)
    with cs.ShapeRecorder() as rec:
        _, history, pipe = online_runner.run_online_pso(config, sampler=sampler, num_epochs=1,
                                                        device="cpu")
    assert history and all(math.isfinite(h["loss"]) for h in history)
    assert seen == {"int8_ref_pass": "train.int8_ref_pass=True" in overrides,
                    "decode": "kernels.int8_vae_decode=True" in overrides,
                    "alpha": 0.5 if "kernels.int8_smooth_alpha=0.5" in overrides else None,
                    "subpixel": "kernels.subpixel_upsample=True" in overrides,
                    "zero": "fast_init=True" in overrides}
    t, s_ = config.train, config.sample
    ucfg, vcfg = pipe.unet.config, pipe.vae.config
    gen = cs._generation_launches(ucfg, vcfg, s_.num_steps,
                                  [pipe.scorer.model.vision_config.layers],
                                  int8={"decode": True if seen["decode"] else None,
                                        "subpixel": seen["subpixel"]})
    upd = cs.expected_update_launches(ucfg, t.gradient_accumulation_steps * t.distilled_train_steps,
                                      False, 2 * t.batch_size, pipe.latent_hw,
                                      int8_ref=seen["int8_ref_pass"], subpixel=seen["subpixel"])
    got = {"flash_attn_fwd": sum(rec.attention.values()), "gn_stats": sum(rec.gn.values()),
           **rec.int8_launches()}
    want = {k: s_.num_batches_per_epoch * gen[k] + len(history) * upd[k] for k in got}
    assert got == want
    assert (got["int8_conv3x3"] > 0) == (seen["decode"] or seen["int8_ref_pass"])


def test_dreambooth_cli_runs_with_fast_init(tmp_path):
    from pairwise_sample_optimization_tpu_torch.cli import train_pso_sdxl_turbo_dreambooth as cli
    from pairwise_sample_optimization_tpu_torch.utils.png import write_png

    inst = tmp_path / "instance"
    inst.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(inst / f"{i}.png"), rng.integers(0, 256, (40, 36, 3)).astype(np.uint8))
    out = tmp_path / "out"
    cli.main(["--tiny", "--device", "cpu", "--fast_init", "--instance_data_dir", str(inst),
              "--instance_prompt", "a photo of sks dog", "--class_prompt", "a photo of dog",
              "--output_dir", str(out), "--max_train_steps", "1", "--skip_validation",
              "--checkpointing_steps", "1"])
    assert (out / "checkpoint-1").is_dir()
