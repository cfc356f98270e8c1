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

``Adam8bit`` keeps the moments of every tensor in one (blocks, 256) int8
buffer each, so an update is a few ops over the whole LoRA
(``flat_optim.FlatOptimizer``). ``ForeachAdam8bit`` is the same arithmetic
for full finetuning, whose 2.57 G elements cannot take flat copies: it
keeps each chunk's (``foreach_adamw.CHUNK`` elements, the tensors of one
group) int8 moments and scales, each tensor's blocks a slice of them, and
updates one chunk at a time through temporary flat buffers of that chunk.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .flat_optim import FlatOptimizer, bias_correction, sqrt_rn
from .foreach_adamw import CHUNK, chunk_groups, global_norm

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


def adam8bit_direction(g: torch.Tensor, state: Tuple[torch.Tensor, ...], b1: float, b2: float,
                       eps: float, k: int):
    """Adam's direction at update ``k`` from the flat fp32 gradient ``g`` and
    the quantized moments ``state`` = (mu_q, mu_scale, nu_q, nu_scale) of
    its blocks -> (direction, the moments quantized anew)."""
    mu_q, mu_scale, nu_q, nu_scale = state
    mu = b1 * dequantize(mu_q, mu_scale) + (1 - b1) * g
    nu_prev = torch.square(dequantize(nu_q, nu_scale))
    nu = b2 * nu_prev + (1 - b2) * g * g
    step = (mu / bias_correction(b1, k)) / (sqrt_rn(nu / bias_correction(b2, k)) + eps)
    return step, quantize(mu) + quantize(sqrt_rn(nu))


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
        k = self.count + 1
        step, (self.mu_q, self.mu_scale, self.nu_q, self.nu_scale) = adam8bit_direction(
            g, (self.mu_q, self.mu_scale, self.nu_q, self.nu_scale), self.b1, self.b2, self.eps, k)
        return self.scaled_by_group(step, p, k)  # the schedule at the incremented count

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


def _blocks(p: torch.Tensor) -> int:
    return -(-p.numel() // BLOCK)


class ForeachAdam8bit:
    """``Adam8bit``'s arithmetic over chunks of the tensors (see the module
    docstring), after one global-norm clip over every tensor. ``groups`` as
    ``FlatOptimizer`` takes them (``train_state.param_groups``)."""

    state_names = ("mu_q", "mu_scale", "nu_q", "nu_scale")

    def __init__(self, groups: List[dict], betas=(0.9, 0.999), eps: float = 1e-8,
                 max_grad_norm: float = 1.0, schedule: Optional[Callable[[int], float]] = None,
                 chunk: int = CHUNK):
        self.b1, self.b2 = betas
        self.eps, self.max_grad_norm = eps, max_grad_norm
        self.count = 0
        self.names, self.params, self.chunks = chunk_groups(groups, schedule, chunk, BLOCK)
        dev = self.params[0].device
        blocks = [sum(_blocks(self.params[i]) for i in idx) for idx, *_ in self.chunks]
        self.mu_q, self.nu_q = ([torch.zeros(n, BLOCK, dtype=torch.int8, device=dev)
                                 for n in blocks] for _ in range(2))
        self.mu_scale, self.nu_scale = ([torch.zeros(n, device=dev) for n in blocks]
                                        for _ in range(2))

    def _views(self, idx, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each tensor's stretch of a chunk's flat buffer, in its shape."""
        out, start = [], 0
        for i in idx:
            p = self.params[i]
            out.append(buf[start:start + p.numel()].view(p.shape))
            start += _blocks(p) * BLOCK
        return out

    @torch.no_grad()
    def step(self, params: Dict[str, nn.Parameter], grads: Dict[str, torch.Tensor]) -> None:
        """One update of ``params`` (the parameters this optimizer was made
        with, by name) from ``grads``, in place."""
        if list(params) != self.names:
            raise KeyError("step() needs the parameters the optimizer was made with, in order")
        grads = [grads[k] for k in self.names]
        norm = global_norm(grads)
        clip = bool(norm >= self.max_grad_norm)
        k = self.count + 1
        for c, (idx, lr, wd, schedule) in enumerate(self.chunks):
            n = self.mu_q[c].numel()
            g = torch.zeros(n, device=self.mu_q[c].device)
            torch._foreach_copy_(self._views(idx, g), [grads[i] for i in idx])
            if clip:
                g = g / norm * self.max_grad_norm
            state = (self.mu_q[c], self.mu_scale[c], self.nu_q[c], self.nu_scale[c])
            step, new = adam8bit_direction(g, state, self.b1, self.b2, self.eps, k)
            del g
            torch._foreach_copy_(list(state), list(new))
            del new
            if wd:
                p = torch.zeros(n, device=step.device)
                torch._foreach_copy_(self._views(idx, p), [self.params[i] for i in idx])
                step = step + wd * p
                del p
            step = torch.mul(step, -lr * FlatOptimizer.factor(schedule, k))
            torch._foreach_add_([self.params[i] for i in idx], self._views(idx, step))
        self.count += 1

    def tensor_state(self, name: str) -> Tuple[torch.Tensor, ...]:
        """(mu_q, mu_scale, nu_q, nu_scale) of one tensor's blocks."""
        i = self.names.index(name)
        for c, (idx, *_) in enumerate(self.chunks):
            if i in idx:
                start = sum(_blocks(self.params[j]) for j in idx[:idx.index(i)])
                sl = slice(start, start + _blocks(self.params[i]))
                return tuple(getattr(self, s)[c][sl] for s in self.state_names)
        raise KeyError(name)

    def state_dict(self) -> dict:
        return {"kind": type(self).__name__, "count": self.count, "names": list(self.names),
                "state": {s: getattr(self, s) for s in self.state_names}}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != type(self).__name__ or state.get("names") != self.names:
            raise KeyError(f"optimizer state of {state.get('kind')!r} over other tensors does "
                           f"not fit this {type(self).__name__}")
        self.count = int(state["count"])
        for s in self.state_names:
            torch._foreach_copy_(getattr(self, s), state["state"][s])
