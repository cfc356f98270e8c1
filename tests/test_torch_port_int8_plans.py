"""The int8 kernels' plans (``ops/qconv.py``) walked in plain Python as
``csrc/int8_conv.cu`` walks them, on the CPU: Q2's and Q3's tiles, split-K
units and grid (``conv3x3_plan``, ``matmul_plan``), Q1b's threads a row and
Q1c's tiles (``quantize_rows_plan``, ``quantize_nhwc_plan``), and the
quantize's division-free fast path. No JAX and no card: the kernels themselves are
held bit-equal to their plain versions on the card (``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu_torch.ops import qconv as tq

H100_SMS = 132
GRID_X_MAX, GRID_YZ_MAX = 2**31 - 1, 65535  # CUDA's grid limits
# the paths' conv shapes ((B, H, W, C), O): the VAE decoder's at 1024^2 and
# 512^2, the UNet's resnets and upsamplers in the int8 reference pass; then
# the edges of chip_smoke.INT8_CONV_EDGES (small enough to count each output)
PATH_CONVS = [((2, 1024, 1024, 128), 128), ((4, 1024, 1024, 256), 256),
              ((2, 512, 512, 512), 256), ((8, 128, 128, 512), 512), ((2, 16, 16, 1280), 1280),
              ((8, 16, 16, 2560), 1280), ((2, 32, 32, 320), 640), ((8, 32, 32, 1920), 640),
              ((2, 64, 64, 960), 320)]
EDGE_CONVS = [((1, 5, 5, 16), 24), ((1, 7, 9, 48), 32), ((2, 33, 17, 64), 80),
              ((1, 3, 2, 16), 8), ((1, 5, 72, 48), 80), ((2, 9, 200, 32), 256),
              ((1, 6, 64, 128), 130), ((2, 16, 16, 1280), 1280)]


def _units(plan, block):
    """The units block ``block`` of Q2's persistent grid walks, as the
    kernel derives them: (tile, b, h0, w0, n0, k0, k1) each."""
    per_image = plan.tiles_h * plan.tiles_w
    for u in range(block, plan.units, plan.grid):
        tile, split = divmod(u, plan.splits)
        mt, nt = divmod(tile, plan.tiles_n)
        b, rem = divmod(mt, per_image)
        th, tw = divmod(rem, plan.tiles_w)
        k0 = split * plan.chunk
        yield (tile, b, th * plan.patch_h, tw * plan.pw, nt * plan.bn, k0,
               min(k0 + plan.chunk, plan.k_steps))


def _conv_walk(x, o, bf16_out):
    """The plan's units as the kernel's blocks walk them: how often each
    (tile, k-step) comes up, and each tile's corner (the tile's units agree
    on it; its last unit to finish writes it)."""
    b, h, w, c = x
    plan = tq.conv3x3_plan(b, h, w, c, o, H100_SMS, bf16_out)
    steps = np.zeros((plan.tiles, plan.k_steps), np.int32)
    corners = {}
    for block in range(plan.grid):
        for tile, bi, h0, w0, n0, k0, k1 in _units(plan, block):
            assert k0 < k1  # no empty unit
            steps[tile, k0:k1] += 1
            corners.setdefault(tile, set()).add((bi, h0, w0, n0))
    assert len(corners) == plan.tiles and all(len(v) == 1 for v in corners.values())
    return plan, steps, [next(iter(v)) for v in corners.values()]


def _check_plan(plan, x, bf16_out):
    """The grid fits the card (one block an SM, at most 2^31 - 1 units, the
    split counters' limit), the tensor maps' boxes fit TMA's limits (at most
    256 a dim), and K is split only where the tiles leave SMs idle, each
    split launch in one wave."""
    assert plan.k_steps == 9 * math.ceil(x[3] / tq.CONV_BK)
    assert 1 <= plan.grid <= H100_SMS and plan.units <= GRID_X_MAX
    assert plan.mi * plan.bn // 2 == tq.CONV_ACC and plan.bn <= 256
    assert plan.pw * plan.patch_h == 2 * plan.mi * 64 and plan.patch_h <= 256
    assert plan.pw == 16 or (bf16_out and x[2] >= 64 and x[2] % 8 == 0)
    if plan.splits > 1:
        assert plan.units <= H100_SMS
        assert plan.tiles <= H100_SMS // 2
        assert plan.chunk >= tq.CONV_MIN_SPLIT_STEPS


@pytest.mark.parametrize("bf16_out", [True, False])
def test_conv3x3_plan_covers_the_paths_convs(bf16_out):
    """Q2 at the paths' shapes: the tiles are the whole grid of patches x N
    tiles, each once; patches and N tiles cover the image and O; every
    tile's units sum each of its 9 taps x ceil(C / 128) channel slices
    exactly once; the plan fits the card."""
    for x, o in PATH_CONVS:
        plan, steps, corners = _conv_walk(x, o, bf16_out)
        assert (steps == 1).all()
        assert sorted(corners) == sorted(
            (bi, th * plan.patch_h, tw * plan.pw, nt * plan.bn) for bi in range(x[0])
            for th in range(plan.tiles_h) for tw in range(plan.tiles_w)
            for nt in range(plan.tiles_n))
        assert plan.tiles_h * plan.patch_h >= x[1] > (plan.tiles_h - 1) * plan.patch_h
        assert plan.tiles_w * plan.pw >= x[2] > (plan.tiles_w - 1) * plan.pw
        assert plan.tiles_n * plan.bn >= o > (plan.tiles_n - 1) * plan.bn
        _check_plan(plan, x, bf16_out)


@pytest.mark.parametrize("bf16_out", [True, False])
def test_conv3x3_plan_writes_each_output_once_at_the_edges(bf16_out):
    """Q2 at ``chip_smoke.INT8_CONV_EDGES``' shapes (C under one slice,
    patches and N tiles cut by H, W and O, an image under one tile, the
    split route): every output (b, h, w, o) is written by exactly one tile
    and every tile's k-steps are summed once."""
    for x, o in EDGE_CONVS:
        plan, steps, corners = _conv_walk(x, o, bf16_out)
        assert (steps == 1).all()
        b, h, w, _ = x
        writes = np.zeros((b, plan.tiles_h * plan.patch_h, plan.tiles_w * plan.pw,
                           plan.tiles_n * plan.bn), np.int32)
        for bi, h0, w0, n0 in corners:
            writes[bi, h0:h0 + plan.patch_h, w0:w0 + plan.pw, n0:n0 + plan.bn] += 1
        assert (writes[:, :h, :w, :o] == 1).all()
        _check_plan(plan, x, bf16_out)


def test_conv3x3_plan_splits_k_at_the_unet_low_levels():
    """The split-K route where the tiles leave most SMs idle ((2,16,16,1280) x
    1280: 20 tiles), none where they fill the card; the slab workspace of
    the wrapper (a unit's 256 threads x 128 int32) fits int32 indexing."""
    small = tq.conv3x3_plan(2, 16, 16, 1280, 1280, H100_SMS)
    assert small.tiles == 20 and small.splits > 1 and small.units <= H100_SMS
    assert small.units * tq.CONV_CONSUMERS * tq.CONV_ACC < 2**31
    for x, o in ((2, 1024, 1024, 128), 128), ((8, 64, 64, 320), 320), ((8, 16, 16, 1280), 1280):
        assert tq.conv3x3_plan(*x, o, H100_SMS).splits == 1


def _rows_cover(rows, k, offset, elem):
    """Q1b's blocks, rows, threads, scalar head, 8-element groups and tail
    walked over rows of k elements whose element 0 lies ``offset`` elements
    past a 16-byte boundary: how often each element is quantized (every
    group's load asserted 16-byte aligned)."""
    tpr, blocks = tq.quantize_rows_plan(rows, k, H100_SMS)
    per_block = tq.ABSMAX_THREADS // tpr
    assert tpr in (32, 64, 128, 256) and blocks * per_block >= rows > (blocks - 1) * per_block
    count = np.zeros((rows, k), np.int32)
    vec = 16 // elem
    for row in range(rows):
        mis = (offset + row * k) % vec
        head = min(k, vec - mis if mis else 0)
        groups = (k - head) // 8
        assert head < 8 <= tpr  # the head, and the tail, one element a thread
        count[row, :head] += 1
        for tid in range(tpr):
            for g in range(tid, groups, tpr):
                start = head + 8 * g
                assert (offset + row * k + start) % vec == 0
                count[row, start:start + 8] += 1
            e = head + groups * 8 + tid
            if e < k:
                count[row, e] += 1
    return count


@pytest.mark.parametrize("elem", [2, 4])
def test_quantize_rows_plan_quantizes_each_element_once(elem):
    """Q1b (bf16, fp32): each element of each row is quantized exactly once,
    by the scalar head, one 16-byte-aligned group of 8, or the scalar tail,
    for row lengths no multiple of 8 and bases off 16 bytes."""
    for rows, k, offset in ((37, 1001, 1), (5, 3001, 1), (9, 7, 2), (4, 1027, 3), (64, 1280, 0)):
        assert (_rows_cover(rows, k, offset, elem) == 1).all()


def test_quantize_rows_plan_at_the_paths_rows():
    """At the paths' row shapes a row's thread holds at most
    ``QUANT_GROUPS`` groups (unless the row takes 256 threads) and no launch
    passes the grid's limit."""
    for rows, k in ((1280, 1280), (2048, 1280), (10240, 1280), (616, 2048), (8192, 640),
                    (1280, 23040), (128, 1152), (8192, 2560), (154, 2048)):
        tpr, blocks = tq.quantize_rows_plan(rows, k, H100_SMS)
        assert math.ceil(k / 8) <= tq.QUANT_GROUPS * tpr or tpr == 256
        assert blocks <= GRID_X_MAX


@pytest.mark.parametrize("b, c, h, w", [(2, 80, 7, 9), (2, 100, 9, 9), (8, 640, 16, 16),
                                        (2, 128, 64, 64)])
def test_quantize_nhwc_plan_writes_each_element_once(b, c, h, w):
    """Q1c: each (sample, channel, pixel) is loaded by one block's thread
    (16 bytes along pixels, or scalar) and written once in NHWC: by the
    thread gathering its pixel's 32 channels, or (C no multiple of 16) by
    one byte store; the grid's y and z fit."""
    tile_p, (gx, gy, gz) = tq.quantize_nhwc_plan(b, c, h * w, H100_SMS)
    assert tile_p in tq.NHWC_TILE_PS and gy <= GRID_YZ_MAX and gz <= GRID_YZ_MAX
    loads = np.zeros((b, c, h * w), np.int32)
    stores = np.zeros((b, h * w, c), np.int32)
    v = 8  # bf16: pixels a 16-byte load (or V scalar loads)
    for bi in range(gz):
        for cy in range(gy):
            for px in range(gx):
                c0, p0 = cy * tq.NHWC_TILE_C, px * tile_p
                for cl in range(min(tq.NHWC_TILE_C, c - c0)):
                    for pg in range(0, min(tile_p, h * w - p0), v):
                        loads[bi, c0 + cl, p0 + pg:min(p0 + pg + v, h * w)] += 1
                for pl in range(min(tile_p, h * w - p0)):
                    if c % 16:
                        for cl in range(min(tq.NHWC_TILE_C, c - c0)):
                            stores[bi, p0 + pl, c0 + cl] += 1
                        continue
                    for cb in range(0, min(tq.NHWC_TILE_C, c - c0), 32):
                        stores[bi, p0 + pl, c0 + cb:min(c0 + cb + 32, c)] += 1
    assert (loads == 1).all() and (stores == 1).all()


def _fast_quantize(v, s, margin):
    """The kernels' quantize_n on fp32 numpy values: t = v * RN(1 / s),
    clip(rint(t)), and whether t passes the half-integer test."""
    with np.errstate(over="ignore"):
        t = (v * (np.float32(1) / s)).astype(np.float32)
    a = np.abs(t)
    with np.errstate(invalid="ignore"):
        fast = (a >= np.float32(129)) | (np.abs(a - np.floor(a) - np.float32(0.5)) > a * margin)
    return np.clip(np.rint(t), -127, 127), fast


def test_fast_quantize_equals_the_true_division_where_it_passes():
    """Where ``quantize_n``'s test passes, clip(rint(v * RN(1 / s))) equals
    clip(rint(RN(v / s))), the plain version's integer, on random values and
    on values a few ulps either side of (k + 1/2) * s; with a margin of
    2^-26 in place of 2^-20 the same values give integers off by one."""
    rng = np.random.default_rng(3)
    wrong = {2.0**-20: 0, 2.0**-26: 0}
    for _ in range(30):
        s = np.float32(max(np.float32(rng.random() * 10.0 ** rng.uniform(-8, 3)), 1e-8)
                       / np.float32(127))
        k = rng.integers(-130, 130, 20000).astype(np.float32)
        v = ((k + np.float32(0.5)) * s).astype(np.float32)
        for _ in range(int(rng.integers(0, 4))):
            v = np.nextafter(v, np.where(rng.random(v.size) < .5, np.inf, -np.inf)
                             ).astype(np.float32)
        v = np.concatenate([v, (rng.standard_normal(20000) * 100 * s).astype(np.float32),
                            np.array([0, -0.0, np.inf, -np.inf, 1e-45, 3e38], np.float32)])
        with np.errstate(over="ignore"):
            want = np.clip(np.rint((v / s).astype(np.float32)), -127, 127)
        for margin in wrong:
            got, fast = _fast_quantize(v, s, np.float32(margin))
            wrong[margin] += int((got[fast] != want[fast]).sum())
    assert wrong[2.0**-20] == 0 and wrong[2.0**-26] > 0
    # the plain version's integers are those of the true division
    x = torch.from_numpy(rng.standard_normal((4, 40)).astype(np.float32))
    q, s = tq.quantize_rows_plain(x, x.abs().amax(dim=1))
    got, fast = _fast_quantize(x.numpy(), s.numpy()[:, None], np.float32(2.0**-20))
    assert fast.mean() > 0.9 and np.array_equal(got[fast], q.numpy()[fast])


# Q3's shapes (M, K, N): the UNet's int8 sites in the reference pass at 2 and 8
# images (the 640-wide level's 1024 tokens: q / k / v / out and proj_in / out,
# GEGLU in and out; its cross-attention's k / v from the 2048-wide context at
# 77 tokens; the 1280-wide level's 256 tokens the same), the CLIP vision
# towers' MLPs at 257 tokens (ViT-L 1024 -> 4096, ViT-H 1280 -> 5120, and
# back) at 1 and 8 images, and the edges of chip_smoke.INT8_MATMUL_EDGES
UNET_MATMULS = [shape for b in (2, 8) for shape in (
    (1024 * b, 640, 640), (1024 * b, 640, 5120), (1024 * b, 2560, 640), (77 * b, 2048, 640),
    (256 * b, 1280, 1280), (256 * b, 1280, 10240), (256 * b, 5120, 1280), (77 * b, 2048, 1280))]
CLIP_MATMULS = [(257 * b, k, n) for b in (1, 8)
                for k, n in ((1024, 4096), (4096, 1024), (1280, 5120), (5120, 1280))]
EDGE_MATMULS = [(1, 640, 640), (16, 2048, 640), (17, 1280, 1280), (65, 64, 24), (154, 2048, 1280),
                (300, 256, 200), (33, 8, 40), (100, 72, 136), (256, 5120, 1280), (128, 5120, 640),
                (2000, 640, 1280)]
MATMULS = {"unet": UNET_MATMULS, "clip": CLIP_MATMULS, "edges": EDGE_MATMULS}


def _matmul_walk(m, k, n):
    """Q3's units as the kernel's blocks walk them: how often each (tile,
    k-step) is summed, and each tile's corner (m0, n0)."""
    plan = tq.matmul_plan(m, k, n, H100_SMS)
    steps = np.zeros((plan.tiles, plan.k_steps), np.int32)
    corners = {}
    for block in range(plan.grid):
        for u in range(block, plan.units, plan.grid):
            tile, split = divmod(u, plan.splits)
            mt, nt = divmod(tile, plan.tiles_n)
            k0 = split * plan.chunk
            k1 = min(k0 + plan.chunk, plan.k_steps)
            assert k0 < k1  # no empty unit
            steps[tile, k0:k1] += 1
            corners.setdefault(tile, set()).add((mt * tq.MATMUL_BM, nt * plan.bn))
    assert len(corners) == plan.tiles and all(len(v) == 1 for v in corners.values())
    return plan, steps, [next(iter(v)) for v in corners.values()]


@pytest.mark.parametrize("family", list(MATMULS))
def test_matmul_plan_covers_each_output_and_k_step_once(family):
    """Q3 at the paths' and the edges' shapes: the tiles are the grid of M
    tiles x N tiles, each once, covering M and N; every tile's units sum
    each of its ceil(K / 128) k-steps once; the grid and the split fit the
    card (the kernel's ring fits shared memory at both N tiles by its own
    static_assert, checked where it is built). At the edges, the epilogue's TMA
    stores (a warpgroup's 64 rows x 128 bytes a block: 64 bf16 or 32 fp32
    columns; none wholly past M or N) write each output element once."""
    for m, k, n in MATMULS[family]:
        plan, steps, corners = _matmul_walk(m, k, n)
        assert (steps == 1).all()
        assert sorted(corners) == sorted((mt * tq.MATMUL_BM, nt * plan.bn) for mt in
                                         range(plan.tiles_m) for nt in range(plan.tiles_n))
        assert plan.tiles_m * tq.MATMUL_BM >= m > (plan.tiles_m - 1) * tq.MATMUL_BM
        assert plan.tiles_n * plan.bn >= n > (plan.tiles_n - 1) * plan.bn
        assert plan.k_steps == math.ceil(k / tq.MATMUL_BK)
        assert plan.bn in (128, 256) and (plan.bn == 128 or n % 256 == 0)
        assert 1 <= plan.grid <= H100_SMS and plan.units <= GRID_X_MAX
        if plan.splits > 1:
            assert plan.units <= H100_SMS and plan.tiles <= H100_SMS // 2
            assert plan.chunk >= tq.MATMUL_MIN_SPLIT_STEPS
        if family != "edges":
            continue
        for cols in (64, 32):  # a staging row of 128 bytes: bf16, fp32
            writes = np.zeros((plan.tiles_m * tq.MATMUL_BM, plan.tiles_n * plan.bn), np.int32)
            for m0, n0 in corners:
                for r0 in (m0, m0 + 64):  # the two consumer warpgroups
                    for c0 in range(n0, n0 + plan.bn, cols):
                        if r0 < m and c0 < n:
                            writes[r0:r0 + 64, c0:c0 + cols] += 1
            assert (writes[:m, :n] == 1).all()


def test_matmul_plan_splits_k_only_where_the_tiles_leave_sms_idle():
    """The split-K route at the edges that take it (20 and 5 tiles over K =
    5120), none where the tiles fill the card (the UNet's 640-wide level at
    8 images, the CLIP MLP); the wrapper's slab workspace (a unit's 256
    threads x bn / 2 int32) fits int32 indexing; 256-column tiles only where
    they cut the 128-column tiles' waves to one (the 2048-token 1280-wide
    products: 160 tiles of 128, 80 of 256), 128 elsewhere (the 8192-token
    GEGLU's and the 2056-token CLIP MLP's: more than one wave either way;
    the 512- and 616-token products: one wave already)."""
    for m, k, n in ((256, 5120, 1280), (128, 5120, 640)):
        plan = tq.matmul_plan(m, k, n, H100_SMS)
        assert plan.splits > 1 and plan.units <= H100_SMS
        assert plan.units * tq.CONV_CONSUMERS * plan.bn // 2 < 2**31
    for m, k, n in ((8192, 640, 5120), (8192, 2560, 640), (2056, 1280, 5120)):
        assert tq.matmul_plan(m, k, n, H100_SMS).splits == 1
    assert [tq.matmul_plan(m, k, n, H100_SMS).bn
            for m, k, n in ((2048, 1280, 1280), (2048, 5120, 1280), (8192, 1280, 5120),
                            (2056, 1280, 5120), (512, 1280, 1280), (616, 2048, 1280))
            ] == [256, 256, 128, 128, 128, 128]
