"""``chip_smoke.py`` holds the bf16 flash-attention backward against
``flash_attention_bwd_plain`` with ``bwd_tolerance``: rtol 1e-2 and an atol
of 5% of the plain gradient's rms. This file shows on the CPU that a
backward that rounds as the kernels round (P and dS to bf16 before the
products, fp32 sums) stays within half the limit, and that one wrong as a
kernel could be fails it: a q tile left out of the dK / dV loop, a kv tile
left out of the dQ loop, or P or dS off by 5%. The same for the one-kernel
backward's sums over blocks (dQ over blocks of keys, dK and dV over q
chunks, added in a shuffled order as bulk reductions add them): within
half the limit, two orders far closer to each other, and a block's share
dropped or added twice fails. Shapes are one batch of the update's
1024-token self-attention and 77-token cross-attention, four heads; inputs
are standard normal, as in the smoke's kernel phase. Also the backward's
plan (chunks, accumulators) at the update's shapes, the accumulator tile
layout its plain post version reads, and the update shapes chip_smoke
derives for its launch counts.
"""

import collections
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parent.parent
TILE = 64  # the kernels' q and kv tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _inputs(skv, seed, d=64):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((1, 1024, 4, d), (1, skv, 4, d), (1, skv, 4, d), (1, 1024, 4, d))]


def _backward(q, k, v, o, lse, do, fault=""):
    """The kernels' arithmetic in torch: P and dS rounded to bf16 before the
    products, fp32 sums; ``fault`` makes it wrong in one way."""
    bf = lambda t: t.to(torch.bfloat16).float()
    scale = 1.0 / 8.0
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    if fault == "p_5pct":
        p = p * 1.05
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - tfa.attention_di(o, do)[..., None])
    ds = ds * scale * (1.05 if fault == "ds_5pct" else 1.0)
    p_kv, ds_kv, ds_q = bf(p), bf(ds), bf(ds)
    if fault == "k2_drops_a_q_tile":
        p_kv[:, :, -TILE:], ds_kv[:, :, -TILE:] = 0, 0
    if fault == "k3_drops_a_kv_tile":
        ds_q[..., (k.shape[1] - 1) // TILE * TILE:] = 0
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_kv, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kv, dof)
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


@functools.lru_cache(maxsize=None)
def _reference(skv, d=64):
    """The inputs at kv length ``skv`` and head dim ``d`` (seeded by skv),
    (q, k, v, o, lse, do), and the plain backward's gradients; once a
    (skv, d) for the whole module (no test changes them)."""
    q, k, v, do = _inputs(skv, seed=skv, d=d)
    o, lse = tfa.flash_attention_plain(q, k, v)
    return (q, k, v, o, lse, do), tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)


def _gradients(skv, fault):
    inputs, want = _reference(skv)
    return _backward(*inputs, fault), want


def _held(smoke, skv, fault):
    """True if chip_smoke's bf16 backward check passes ``fault``'s gradients."""
    got, want = _gradients(skv, fault)
    try:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            smoke.check_close(name, g, w, smoke.bwd_tolerance(w))
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("skv", [1024, 77])
def test_bf16_backward_limit_passes_the_kernels_rounding(smoke, skv):
    assert smoke.TOL["attention_bwd"]["bf16"] == (5e-2, 1e-2)
    assert _held(smoke, skv, "")
    got, want = _gradients(skv, "")
    assert max(smoke.tolerance_used(g, w, smoke.bwd_tolerance(w)) for g, w in zip(got, want)) < 0.5


@pytest.mark.parametrize("fault", ["k2_drops_a_q_tile", "k3_drops_a_kv_tile", "p_5pct",
                                   "ds_5pct"])
@pytest.mark.parametrize("skv", [1024, 77])
def test_bf16_backward_limit_fails_a_wrong_kernel(smoke, skv, fault):
    assert not _held(smoke, skv, fault)


def _pad_q_rows(t, rows, copies):
    """``t`` (B, S, ...) padded to ``rows`` along S: zeros, or with
    ``copies`` copies of its last row."""
    extra = rows - t.shape[1]
    tail = t[:, -1:].expand(-1, extra, *t.shape[2:]) if copies else t.new_zeros(
        (t.shape[0], extra, *t.shape[2:]))
    return torch.cat([t, tail], 1)


def test_bf16_backward_limit_fails_copied_pad_q_rows(smoke):
    """K2 loops over q tiles of 64 rows; at a ragged q length (1000) the pad
    rows of the last tile must be zero-filled Q and dO (their P can be
    anything: they add nothing to dK or dV). A copy that clamps the source
    row without zero-filling adds the last real row 24 more times."""
    r = np.random.default_rng(1000)
    q, k, v, do = (torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
                   for s in ((1, 1000, 4, 64), (1, 77, 4, 64), (1, 77, 4, 64), (1, 1000, 4, 64)))
    o, lse = tfa.flash_attention_plain(q, k, v)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)[1:]
    for copies in (False, True):
        q_pad, o_pad, do_pad = (_pad_q_rows(t, 1024, copies) for t in (q, o, do))
        lse_pad = _pad_q_rows(lse.transpose(1, 2), 1024, copies).transpose(1, 2)
        got = _backward(q_pad, k, v, o_pad, lse_pad, do_pad)[1:]
        used = max(smoke.tolerance_used(g, w, smoke.bwd_tolerance(w)) for g, w in zip(got, want))
        assert (used > 1) == copies, (copies, used)


# ---- the one-kernel backward: sums over blocks taken in the card's order ----

SMS = 132  # an H100's SMs: the chunking of bwd_plan on the card


@functools.lru_cache(maxsize=None)
def _fused_parts(skv, d):
    """The bf16 backward kernel's partial sums in torch at ``_reference``'s
    inputs: P and dS rounded to bf16 before the products; dQ's shares over
    blocks of ``BWD_KV_ROWS[d]`` keys, dK's and dV's over the chunks of q
    rows that ``bwd_plan`` gives these lengths. Once a (skv, d)."""
    (q, k, v, o, lse, do), _ = _reference(skv, d)
    bf = lambda t: t.to(torch.bfloat16).float()
    b, sq, h, _ = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - tfa.attention_di(o, do)[..., None]) * scale
    p, ds = bf(p), bf(ds)
    q_chunk, _, _ = tfa.bwd_plan(b * h, sq, skv, SMS, d)
    rows = tfa.BWD_KV_ROWS[d]
    kv_blocks = list(range(0, skv, rows))
    chunks = list(range(0, sq, q_chunk * TILE))
    dq_parts = [torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + rows], kf[:, k0:k0 + rows])
                for k0 in kv_blocks]
    kv_parts = [(torch.einsum("bhqk,bqhd->bkhd", ds[:, :, q0:q0 + q_chunk * TILE],
                              qf[:, q0:q0 + q_chunk * TILE]),
                 torch.einsum("bhqk,bqhd->bkhd", p[:, :, q0:q0 + q_chunk * TILE],
                              dof[:, q0:q0 + q_chunk * TILE])) for q0 in chunks]
    return dq_parts, kv_parts, qf, kf


def _fused_backward(skv, d, fault="", seed=0):
    """The bf16 backward kernel's arithmetic: ``_fused_parts`` each summed
    in fp32 in a shuffled order (the bulk reductions add in the order blocks
    finish). ``fault`` drops one block's dQ share, or drops or doubles one
    q chunk's dK / dV share."""
    dq_parts, kv_parts, qf, kf = _fused_parts(skv, d)
    gen = torch.Generator().manual_seed(seed)
    if fault == "drops_a_kv_block_of_dq":
        dq_parts = dq_parts[:-1]
    if fault == "drops_a_q_chunk_of_dkv":
        kv_parts = kv_parts[1:]
    if fault == "adds_a_q_chunk_of_dkv_twice":
        kv_parts = kv_parts + kv_parts[-1:]

    def shuffled_sum(parts, like):
        total = torch.zeros_like(like)
        for i in torch.randperm(len(parts), generator=gen).tolist():
            total = total + parts[i]
        return total

    dq = shuffled_sum(dq_parts, qf)
    dk, dv = (shuffled_sum([part[i] for part in kv_parts], kf) for i in (0, 1))
    return [t.to(torch.bfloat16) for t in (dq, dk, dv)]


def _fused_held(smoke, skv, fault, seed=0, d=64):
    return _fused_backward(skv, d, fault, seed), _reference(skv, d)[1]


@pytest.mark.parametrize("d", tfa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("skv", [1024, 77])
def test_bf16_backward_limit_passes_the_fused_kernels_sums(smoke, skv, d):
    """Sums over 8 or 16 kv blocks (dQ) and 2 to 16 q chunks (dK, dV) in two
    shuffled orders stay within half the limit at every head dim, and the
    two orders differ by far less than the limit (the run-to-run check of
    chip_smoke): at d = 64 by under 0.2 of it; at the SD1.x head dims by
    under 0.4, one bf16 rounding step (2^-8 relative) over the rtol of 1e-2
    (at d = 160 one element of ~6x the rms rounds the other way: 0.22)."""
    runs = [_fused_held(smoke, skv, "", seed, d) for seed in (0, 1)]
    for got, want in runs:
        assert max(smoke.tolerance_used(g, w, smoke.bwd_tolerance(w))
                   for g, w in zip(got, want)) < 0.5
    (first, want), (second, _) = runs
    assert max(smoke.tolerance_used(b, a, smoke.bwd_tolerance(w))
               for a, b, w in zip(first, second, want)) < (0.2 if d == 64 else 0.4)


@pytest.mark.parametrize("d", tfa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("fault", ["drops_a_kv_block_of_dq", "drops_a_q_chunk_of_dkv",
                                   "adds_a_q_chunk_of_dkv_twice"])
@pytest.mark.parametrize("skv", [1024, 77])
def test_bf16_backward_limit_fails_a_wrong_fused_kernel(smoke, skv, fault, d):
    got, want = _fused_held(smoke, skv, fault, d=d)
    assert max(smoke.tolerance_used(g, w, smoke.bwd_tolerance(w))
               for g, w in zip(got, want)) > 1


# (batch * heads, sq, skv) -> (q tiles a block walks, dQ accumulator, dK / dV
# accumulators) by head dim: SD1.x's shapes (2 prompts with CFG x 8 heads) at
# every head dim; at 64 also the Turbo (8 x 10 / 20 heads) and DMD2 (2 x 10 /
# 20 heads) update shapes
_SD15_PLAN = {(32, 4096, 4096): (64, True, False), (32, 4096, 77): (8, False, True),
              (32, 1024, 1024): (16, True, False), (32, 1024, 77): (2, False, True),
              (32, 256, 256): (1, True, True), (32, 256, 77): (1, False, True),
              (32, 64, 64): (1, False, False), (32, 64, 77): (1, False, False)}
PLANS = {
    40: _SD15_PLAN, 80: _SD15_PLAN,
    64: {**_SD15_PLAN,
         (80, 1024, 1024): (16, True, False), (80, 1024, 77): (4, False, True),
         (160, 256, 256): (4, True, False), (160, 256, 77): (4, False, False),
         (20, 4096, 4096): (64, True, False), (20, 4096, 77): (5, False, True),
         (40, 1024, 1024): (16, True, False), (40, 1024, 77): (3, False, True)},
    # two warpgroups share 64 kv rows: dQ has an accumulator past 64 keys
    160: {**_SD15_PLAN, (32, 4096, 77): (13, True, True), (32, 1024, 77): (4, True, True),
          (32, 256, 256): (2, True, True), (32, 256, 77): (1, True, True),
          (32, 64, 77): (1, True, False)},
}


@pytest.mark.parametrize("d", tfa.BWD_HEAD_DIMS)
def test_bwd_plan_at_the_update_shapes(d):
    """Per (batch * heads, sq, skv) on 132 SMs: the q tiles a block walks
    (every chunk non-empty, all tiles covered) and which gradients go
    through fp32 accumulators: dQ wherever more than one block of keys
    adds to it, dK and dV where the q loop is split."""
    for (bh, sq, skv), (chunk, acc_q, acc_kv) in PLANS[d].items():
        q_chunk, dq_rows, kv_rows = tfa.bwd_plan(bh, sq, skv, SMS, d)
        n_q = -(-sq // TILE)
        assert (q_chunk, bool(dq_rows), bool(kv_rows)) == (chunk, acc_q, acc_kv), (bh, sq, skv)
        assert dq_rows in (0, n_q * TILE) and kv_rows in (0, -(-skv // TILE) * TILE)
        assert bool(dq_rows) == (skv > tfa.BWD_KV_ROWS[d])
        assert (-(-n_q // q_chunk) - 1) * q_chunk < n_q  # the last chunk is not empty


@pytest.mark.parametrize("d", tfa.BWD_HEAD_DIMS)
def test_bwd_post_plain_reads_the_kernels_tile_layout(d):
    """The accumulators' layout as the kernels write it (``acc_off``: per
    head 64-row tiles; each 64-column block of a tile 64 rows of 256 bytes,
    the 8-column group j of row r at group j ^ (r % 8); then the remaining
    8-column groups, each 64 rows of 32 bytes), built here element by
    element, decodes to the gradients it encodes."""
    r = np.random.default_rng(5)
    b, sq, h, skv = 2, 100, 3, 70
    grads = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
             for s in ((b, sq, h, d), (b, skv, h, d), (b, skv, h, d))]
    full = d // 64

    def place(row, col):  # the float index of element (row, col) within its tile
        j, e = col // 8, col % 8
        if j < 8 * full:
            return (j // 8) * TILE * 64 + row * 64 + ((j % 8) ^ (row % 8)) * 8 + e
        return full * TILE * 64 + (j - 8 * full) * TILE * 8 + row * 8 + e

    def encode(x):
        n = x.shape[1]
        tiles = -(-n // TILE)
        out = np.zeros((b * h, tiles, TILE * d), np.float32)
        rows = x.permute(0, 2, 1, 3).reshape(b * h, n, d).numpy()
        for row in range(n):
            for col in range(d):
                out[:, row // TILE, place(row % TILE, col)] = rows[:, row, col]
        return torch.from_numpy(out.reshape(-1))

    acc = torch.cat([encode(g) for g in grads])
    outs = [torch.empty_like(g).to(torch.bfloat16) for g in grads]
    tfa.bwd_post_plain(acc, *outs, True, True)
    for got, want in zip(outs, grads):
        assert torch.equal(got, want.to(torch.bfloat16))
    only_kv = torch.cat([encode(g) for g in grads[1:]])
    dq = torch.zeros_like(outs[0])
    tfa.bwd_post_plain(only_kv, dq, *outs[1:], False, True)
    assert torch.equal(outs[2], grads[2].to(torch.bfloat16)) and not dq.any()


def test_chip_smoke_derives_the_update_shapes_of_sdxl(smoke):
    """``attention_shapes`` at the full SDXL UNet, policy batch 8, 64^2
    latents (Turbo at 512^2): per UNet pass 10 transformer blocks at 32^2
    tokens and 10 heads, 60 at 16^2 tokens and 20 heads, each with a self-
    and a cross-attention; the post kernel runs for all but the 16^2-token
    cross-attention (one block of keys, no split at 160 batch * heads)."""
    from pairwise_sample_optimization_tpu_torch.models import UNetConfig

    ucfg = UNetConfig.sdxl()
    shapes = collections.Counter(smoke.attention_shapes(ucfg, 8, 64))
    assert shapes == {((8, 1024, 10, 64), 1024): 10, ((8, 1024, 10, 64), 77): 10,
                      ((8, 256, 20, 64), 256): 60, ((8, 256, 20, 64), 77): 60}
    upd = smoke.expected_update_launches(dataclasses.replace(ucfg, remat="full"), 6, False, 8, 64)
    assert upd["flash_attn_bwd_pre"] == upd["flash_attn_bwd"] == 6 * 140
    assert upd["flash_attn_bwd_post"] == 6 * 80
