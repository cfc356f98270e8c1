"""``chip_smoke.py`` holds the bf16 flash-attention forward (K1) against
``flash_attention_plain`` with ``fwd_tolerance`` (rtol 1e-2 and an atol of
5% of the plain O's rms) and its fp32 logsumexp at ``TOL["attention_lse"]``.
This file shows on the CPU that a forward that rounds as K1 rounds (kv
tiles of 64 keys, fp32 running max, row sum and accumulator, P rounded to
bf16 before P.V, O to bf16 at the end; at head dim 512 S as the fp32 sum of
two partial products over the halves of d, as the kernel's two warpgroups
compute it) stays within half the limit, and that one wrong as a kernel
could be fails it: O off by 5%, the LSE off by 0.05 (P 5% low in the
backward), a kv tile left out, the zero-filled pad keys of a last partial
kv tile counted in the row sum, or the running-max rescale of the
accumulator skipped. Shapes: one batch of the update's 1024-token
self-attention and 77-token cross-attention at head dim 64 (four heads),
PickScore's 257-token self-attention at 80 (four heads) and the VAE
mid-block at 512 (one head, 1024 of its 4096 tokens); inputs are standard
normal, as in the smoke's kernel phase.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parent.parent
TILE = 64  # K1's kv tile


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# case -> (head dim, q length, kv length, heads); "1024" and "77" are d = 64
CASES = {"1024": (64, 1024, 1024, 4), "77": (64, 1024, 77, 4), "d80-257": (80, 257, 257, 4),
         "d512-1024": (512, 1024, 1024, 1)}


def _inputs(case):
    d, sq, skv, h = CASES[case]
    r = np.random.default_rng(skv if d == 64 else d + skv)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((1, sq, h, d), (1, skv, h, d), (1, skv, h, d))]


def _scores(qf, kf):
    """S = Q K^T / sqrt(d) for one kv tile; at d = 512 the fp32 sum of the
    two warpgroups' partial products over d's halves."""
    d = qf.shape[-1]
    if d != 512:
        return torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(d)
    halves = [torch.einsum("bqhd,bkhd->bhqk", qf[..., c], kf[..., c])
              for c in (slice(0, 256), slice(256, 512))]
    return (halves[0] + halves[1]) / math.sqrt(d)


def _forward(q, k, v, fault=""):
    """K1's arithmetic in torch, tile by tile; ``fault`` makes it wrong in
    one way. -> (o (B, Sq, H, D) bf16, lse (B, H, Sq) fp32)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    n_tiles = -(-skv // TILE)
    pad = (0, 0, 0, 0, 0, n_tiles * TILE - skv)  # pad keys are zero rows, as the copy fills them
    qf, kf, vf = q.float(), F.pad(k.float(), pad), F.pad(v.float(), pad)
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for t in range(n_tiles):
        if fault == "drops_a_kv_tile" and t == n_tiles - 1:
            continue
        cols = slice(t * TILE, (t + 1) * TILE)
        s = _scores(qf, kf[:, cols])
        if fault != "counts_pad_keys":
            s = torch.where(torch.arange(t * TILE, (t + 1) * TILE) < skv, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        if fault != "skips_rescale":
            acc = alpha[..., None] * acc
        acc = acc + torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf[:, cols])
        m = m_new
    o, lse = acc / l[..., None], m + torch.log(l)
    if fault == "o_5pct":
        o = o * 1.05
    if fault == "lse_off_by_0.05":
        lse = lse + 0.05
    return o.transpose(1, 2).to(torch.bfloat16), lse


def _outputs(case, fault):
    q, k, v = _inputs(case)
    return _forward(q, k, v, fault), tfa.flash_attention_plain(q, k, v)


def _used(smoke, case, fault):
    """The largest share of chip_smoke's bf16 forward limits (O, LSE) that
    ``fault``'s forward uses; over 1 fails the check."""
    (o, lse), (o_p, lse_p) = _outputs(case, fault)
    return max(smoke.tolerance_used(o, o_p, smoke.fwd_tolerance(o_p)),
               smoke.tolerance_used(lse, lse_p, smoke.TOL["attention_lse"]))


def _held(smoke, case, fault):
    """True if chip_smoke's bf16 forward check passes ``fault``'s outputs."""
    (o, lse), (o_p, lse_p) = _outputs(case, fault)
    try:
        smoke.check_close("o", o, o_p, smoke.fwd_tolerance(o_p))
        smoke.check_close("lse", lse, lse_p, smoke.TOL["attention_lse"])
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_limit_passes_the_kernels_rounding(smoke, case):
    assert smoke.TOL["attention"]["bf16"] == (5e-2, 1e-2)
    assert smoke.TOL["attention"]["fp32"] == (2e-3, 2e-3)  # also the small reference's
    assert smoke.TOL["attention_lse"] == (2e-3, 0.0)
    assert _held(smoke, case, "")
    assert _used(smoke, case, "") < 0.5


@pytest.mark.parametrize("case,fault", [
    ("1024", "o_5pct"), ("77", "o_5pct"), ("1024", "lse_off_by_0.05"), ("77", "lse_off_by_0.05"),
    ("1024", "drops_a_kv_tile"), ("77", "drops_a_kv_tile"), ("77", "counts_pad_keys"),
    ("1024", "skips_rescale"), ("77", "skips_rescale"),
    ("d80-257", "o_5pct"), ("d80-257", "drops_a_kv_tile"), ("d80-257", "counts_pad_keys"),
    ("d80-257", "skips_rescale"),
    ("d512-1024", "o_5pct"), ("d512-1024", "drops_a_kv_tile"), ("d512-1024", "skips_rescale"),
])
def test_bf16_forward_limit_fails_a_wrong_kernel(smoke, case, fault):
    assert not _held(smoke, case, fault)
