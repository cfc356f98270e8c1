"""Block-wise 8-bit AdamW (``--use_8bit_adam``, ``train.use_8bit_adam``).

Counterpart of the JAX package's ``train/quantized_adam.py::adam8bit``:
both Adam moments are stored as int8 with an fp32 absmax scale per block of
256 elements of each tensor (a tensor's last block is zero-padded), and
dequantized to fp32 for the update. The second moment is stored in the
square-root domain (sqrt(nu) needs half the dynamic range). Quantization is
``round(x / (absmax / 127))`` half to even, clipped to +-127, the scale
stored as ``absmax / 127``. The learning rate is read at the incremented
update count (one step later than ``adamw``), as there. Decay is
decoupled: ``-lr * (step + wd * p)``.

The moments of every tensor live in one (blocks, 256) int8 buffer each, so
an update is a few ops over the whole LoRA (``flat_optim.FlatOptimizer``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .flat_optim import FlatOptimizer, bias_correction, sqrt_rn

BLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat fp32 (n * BLOCK,) -> (int8 (n, BLOCK), fp32 scales (n,))."""
    flat = x.float().view(-1, BLOCK)
    scale = flat.abs().amax(dim=1)
    # 127 as a tensor on the device: CUDA multiplies by the fp32 reciprocal
    # of a Python divisor, which is not the rounded quotient on every block
    c127 = torch.full((), 127.0, device=flat.device)
    safe = torch.where(scale == 0.0, 1.0, scale)[:, None] / c127
    q = torch.clamp(torch.round(flat / safe), -127, 127).to(torch.int8)
    return q, scale / c127


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 (n, BLOCK), scales (n,)) -> flat fp32 (n * BLOCK,)."""
    return (q.float() * scale[:, None]).view(-1)


class Adam8bit(FlatOptimizer):
    """8-bit AdamW over ``groups`` (``FlatOptimizer``'s layout: each group
    its own learning rate and weight decay), with global-norm clipping."""

    block = BLOCK
    state_names = ("mu_q", "mu_scale", "nu_q", "nu_scale")

    def __init__(self, groups, betas=(0.9, 0.999), eps: float = 1e-8, max_grad_norm: float = 1.0,
                 schedule=None):
        super().__init__(groups, max_grad_norm, schedule)
        self.b1, self.b2 = betas
        self.eps = eps
        dev = self.grad_flat.device
        blocks = self.numel // BLOCK
        self.mu_q = torch.zeros(blocks, BLOCK, dtype=torch.int8, device=dev)
        self.nu_q = torch.zeros(blocks, BLOCK, dtype=torch.int8, device=dev)
        self.mu_scale = torch.zeros(blocks, device=dev)
        self.nu_scale = torch.zeros(blocks, device=dev)

    def update(self, g, p):
        b1, b2 = self.b1, self.b2
        k = self.count + 1
        mu = b1 * dequantize(self.mu_q, self.mu_scale) + (1 - b1) * g
        nu_prev = torch.square(dequantize(self.nu_q, self.nu_scale))
        nu = b2 * nu_prev + (1 - b2) * g * g
        step = (mu / bias_correction(b1, k)) / (sqrt_rn(nu / bias_correction(b2, k)) + self.eps)
        out = self.scaled_by_group(step, p, k)  # the schedule at the incremented count
        self.mu_q, self.mu_scale = quantize(mu)
        self.nu_q, self.nu_scale = quantize(sqrt_rn(nu))
        return out

    def tensor_state(self, name: str) -> Tuple[torch.Tensor, ...]:
        """(mu_q, mu_scale, nu_q, nu_scale) of one tensor's blocks."""
        start = 0
        for n, p in zip(self.names, self.params):
            blocks = -(-p.numel() // BLOCK)
            if n == name:
                sl = slice(start, start + blocks)
                return self.mu_q[sl], self.mu_scale[sl], self.nu_q[sl], self.nu_scale[sl]
            start += blocks
        raise KeyError(name)
