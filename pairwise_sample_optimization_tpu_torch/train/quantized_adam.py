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

Under tensor parallelism (``parallel.tp``) a rank holds slices of some
tensors. Their moments are quantized in the whole tensor's blocks of 256,
as one process quantizes them: each element's block is its index in the
whole tensor's flattened order over 256, a block's absmax is the MAX
all-reduce of the ranks' absmaxes over the model group, and those scales
(every block of the whole tensor, the same on every model rank) are kept
beside the local int8 values (``mu_gscale`` / ``nu_gscale``, one tensor a
sliced tensor).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .flat_optim import FlatOptimizer, bias_correction, sqrt_rn
from .foreach_adamw import CHUNK, chunk_groups, sharded_global_norm

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
                       eps: float, k: int, stretches=()):
    """Adam's direction at update ``k`` from the flat fp32 gradient ``g`` and
    the quantized moments ``state`` = (mu_q, mu_scale, nu_q, nu_scale) of
    its blocks -> (direction, the moments quantized anew). ``stretches``:
    the tensor-parallel slices in the buffer (:func:`tp_stretches`); their
    whole-tensor scales follow as ``state[4:]`` = (mu_gscale, nu_gscale)
    and are returned anew after the four."""
    if stretches:
        mu_q, mu_scale, nu_q, nu_scale, mu_g, nu_g = state
        mu = b1 * _dequantize_tp(mu_q, mu_scale, stretches, mu_g) + (1 - b1) * g
        nu_prev = torch.square(_dequantize_tp(nu_q, nu_scale, stretches, nu_g))
    else:
        mu_q, mu_scale, nu_q, nu_scale = state
        mu = b1 * dequantize(mu_q, mu_scale) + (1 - b1) * g
        nu_prev = torch.square(dequantize(nu_q, nu_scale))
    nu = b2 * nu_prev + (1 - b2) * g * g
    step = (mu / bias_correction(b1, k)) / (sqrt_rn(nu / bias_correction(b2, k)) + eps)
    if not stretches:
        return step, quantize(mu) + quantize(sqrt_rn(nu))
    (mq, ms, mg), (nq, ns, ng) = (_quantize_tp(x, stretches) for x in (mu, sqrt_rn(nu)))
    return step, (mq, ms, nq, ns, mg, ng)


def tp_stretches(params, offsets) -> list:
    """(start in the flat buffer, shard) of each tensor-parallel slice among
    ``params`` laid out at ``offsets``."""
    return [(o, p.tp_shard) for o, p in zip(offsets, params)
            if getattr(p, "tp_shard", None) is not None]


def _global_blocks(shard) -> int:
    n = 1
    for s in shard.shape:
        n *= s
    return -(-n // BLOCK)


def _ids(shard, device) -> torch.Tensor:
    return (shard.flat_index() // BLOCK).to(device)


def _quantize_tp(x: torch.Tensor, stretches):
    """:func:`quantize` of the flat ``x``, its sliced stretches in their
    whole tensors' blocks -> (q, local scales, whole-tensor scales of the
    stretches, concatenated)."""
    from ..parallel.collectives import all_reduce_sum_

    q, scale = quantize(x)
    c127 = torch.full((), 127.0, device=x.device)
    ids, absmax = [], []
    for start, shard in stretches:
        i = _ids(shard, x.device)
        seg = x[start:start + i.numel()].float()
        ids.append(i)
        absmax.append(torch.zeros(_global_blocks(shard), device=x.device)
                      .scatter_reduce_(0, i, seg.abs(), "amax"))
    gscale = torch.cat(absmax)
    all_reduce_sum_([gscale], stretches[0][1].group, op=torch.distributed.ReduceOp.MAX)
    flat_q, base = q.view(-1), 0
    for (start, shard), i in zip(stretches, ids):
        g = gscale[base:base + _global_blocks(shard)]
        safe = torch.where(g == 0.0, 1.0, g) / c127
        seg = x[start:start + i.numel()].float()
        flat_q[start:start + i.numel()] = torch.clamp(torch.round(seg / safe[i]), -127,
                                                      127).to(torch.int8)
        base += g.numel()
    return q, scale, gscale / c127


def _dequantize_tp(q, scale, stretches, gscale) -> torch.Tensor:
    flat, base = dequantize(q, scale), 0
    for start, shard in stretches:
        i = _ids(shard, q.device)
        nb = _global_blocks(shard)
        flat[start:start + i.numel()] = (q.view(-1)[start:start + i.numel()].float()
                                         * gscale[base:base + nb][i])
        base += nb
    return flat


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
        self.stretches = tp_stretches(self.params, self.offsets)
        if self.stretches:  # the sliced tensors' whole-tensor scales
            self.state_names = Adam8bit.state_names + ("mu_gscale", "nu_gscale")
            n = sum(_global_blocks(sh) for _, sh in self.stretches)
            self.mu_gscale = torch.zeros(n, device=dev)
            self.nu_gscale = torch.zeros(n, device=dev)

    def update(self, g, p):
        k = self.count + 1
        state = tuple(getattr(self, s) for s in self.state_names)
        step, new = adam8bit_direction(g, state, self.b1, self.b2, self.eps, k, self.stretches)
        for s, t in zip(self.state_names, new):
            setattr(self, s, t)
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
        # what ``chunk_groups`` needs to lay out the same groups over other shapes
        self.layout = ([(list(g["params"]), g["lr"], g["weight_decay"], g.get("schedule"))
                        for g in groups], schedule, chunk)
        dev = self.params[0].device
        blocks = [sum(_blocks(self.params[i]) for i in idx) for idx, *_ in self.chunks]
        self.mu_q, self.nu_q = ([torch.zeros(n, BLOCK, dtype=torch.int8, device=dev)
                                 for n in blocks] for _ in range(2))
        self.mu_scale, self.nu_scale = ([torch.zeros(n, device=dev) for n in blocks]
                                        for _ in range(2))
        # each chunk's tensor-parallel slices: (start in its buffer, shard)
        self.stretches = []
        for idx, *_ in self.chunks:
            starts = [0]
            for i in idx[:-1]:
                starts.append(starts[-1] + _blocks(self.params[i]) * BLOCK)
            self.stretches.append(tp_stretches([self.params[i] for i in idx], starts))
        if any(self.stretches):  # the slices' whole-tensor scales, a tensor a chunk
            self.state_names = ForeachAdam8bit.state_names + ("mu_gscale", "nu_gscale")
            self.mu_gscale, self.nu_gscale = (
                [torch.zeros(sum(_global_blocks(sh) for _, sh in st), device=dev)
                 for st in self.stretches] for _ in range(2))

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
        norm = sharded_global_norm(self.params, grads)
        clip = bool(norm >= self.max_grad_norm)
        k = self.count + 1
        for c, (idx, lr, wd, schedule) in enumerate(self.chunks):
            names = self.state_names if self.stretches[c] else ForeachAdam8bit.state_names
            n = self.mu_q[c].numel()
            g = torch.zeros(n, device=self.mu_q[c].device)
            torch._foreach_copy_(self._views(idx, g), [grads[i] for i in idx])
            if clip:
                g = g / norm * self.max_grad_norm
            state = tuple(getattr(self, s)[c] for s in names)
            step, new = adam8bit_direction(g, state, self.b1, self.b2, self.eps, k,
                                           self.stretches[c])
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
                return tuple(getattr(self, s)[c][sl] for s in ForeachAdam8bit.state_names)
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
