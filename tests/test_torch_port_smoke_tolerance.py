"""``chip_smoke.py`` holds the bf16 flash-attention backward kernels (K2 dK/dV,
K3 dQ) against ``flash_attention_bwd_plain`` with ``bwd_tolerance``: rtol
1e-2 and an atol of 5% of the plain gradient's rms. This file shows on the
CPU that a backward that rounds as the kernels round (P and dS to bf16
before the products, fp32 sums) stays within half the limit, and that one
wrong as a kernel could be fails it: a q tile left out of K2's loop, a kv
tile left out of K3's, or P or dS off by 5%. Shapes are one batch of the
update's 1024-token self-attention and 77-token cross-attention, four
heads; inputs are standard normal, as in the smoke's kernel phase.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parent.parent
TILE = 64  # the kernels' q and kv tile


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _inputs(skv, seed):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((1, 1024, 4, 64), (1, skv, 4, 64), (1, skv, 4, 64), (1, 1024, 4, 64))]


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


def _gradients(skv, fault):
    q, k, v, do = _inputs(skv, seed=skv)
    o, lse = tfa.flash_attention_plain(q, k, v)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    return _backward(q, k, v, o, lse, do, fault), want


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
