"""AdamW that updates each trained tensor in place: the optimizer of full
finetuning.

``flat_optim.FlatAdamW`` copies every gradient and parameter into flat fp32
buffers, a few ops over ~2k LoRA tensors; over the whole SDXL UNet (2.57 G
elements) those copies would take ~31 GB more. ``ForeachAdamW`` runs the
same arithmetic (optax's ``clip_by_global_norm``, then ``adamw`` with its
first moment stored in fp32 or bf16) with ``torch._foreach_*`` ops on the
tensors themselves, a group of tensors of at most ``chunk`` elements at a
time, so that its temporaries stay within a few times ``chunk``. Its state
is one first and one fp32 second moment per tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from .flat_optim import FlatOptimizer, bias_correction, sqrt_rn

CHUNK = 2**26  # elements a group of tensors holds (256 MB in fp32)


def global_norm(tensors, chunk: int = CHUNK) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32: each tensor's
    norm, then the norm of those (at most ``chunk`` elements converted to
    fp32 at a time)."""
    norms, group, n = [], [], 0
    for t in tensors:
        group.append(t)
        n += t.numel()
        if n >= chunk:
            norms += torch._foreach_norm([x.float() for x in group])
            group, n = [], 0
    if group:
        norms += torch._foreach_norm([x.float() for x in group])
    return torch.linalg.vector_norm(torch.stack(norms))


def chunk_groups(groups: List[dict], schedule: Optional[Callable[[int], float]], chunk: int,
                 block: int = 1):
    """(names, parameters, chunks) of ``groups`` (``FlatOptimizer``'s
    form): each chunk ``(tensor indices, lr, weight_decay, schedule)`` holds
    consecutive tensors of one group, at most ``chunk`` elements with each
    tensor padded to a multiple of ``block`` (or one larger tensor)."""
    names: List[str] = []
    params: List[nn.Parameter] = []
    chunks = []
    for g in groups:
        idx, n = [], 0
        for name, p in g["params"].items():
            size = p.numel() + (-p.numel() % block)
            if idx and n + size > chunk:
                chunks.append((idx, float(g["lr"]), float(g["weight_decay"]),
                               g.get("schedule") or schedule))
                idx, n = [], 0
            idx.append(len(params))
            names.append(name)
            params.append(p)
            n += size
        if idx:
            chunks.append((idx, float(g["lr"]), float(g["weight_decay"]),
                           g.get("schedule") or schedule))
    if not params:
        raise ValueError("no parameters to optimize")
    return names, params, chunks


class ForeachAdamW:
    """optax ``adamw`` per group after global-norm clipping, as
    ``FlatAdamW`` computes it, on the tensors in place. ``groups`` as
    ``FlatOptimizer`` takes them (``train_state.param_groups``)."""

    def __init__(self, groups: List[dict], betas=(0.9, 0.999), eps: float = 1e-8,
                 max_grad_norm: float = 1.0, schedule: Optional[Callable[[int], float]] = None,
                 mu_dtype: torch.dtype = torch.float32, chunk: int = CHUNK):
        self.b1, self.b2 = betas
        self.eps, self.max_grad_norm = eps, max_grad_norm
        self.count = 0
        self.names, self.params, self.chunks = chunk_groups(groups, schedule, chunk)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

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
        bc1, bc2 = bias_correction(self.b1, k), bias_correction(self.b2, k)
        b1_stored = float(torch.tensor(self.b1, dtype=self.mu[0].dtype))
        cpu = self.params[0].device.type == "cpu"
        for idx, lr, wd, schedule in self.chunks:
            p = [self.params[i] for i in idx]
            g = [grads[i].float() for i in idx]
            if clip:
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.max_grad_norm)
            mu, nu = [self.mu[i] for i in idx], [self.nu[i] for i in idx]
            m = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                   torch._foreach_mul([t.float() for t in mu], b1_stored))
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
            del g
            v = torch._foreach_div(nu, bc2)
            v = [sqrt_rn(t) for t in v] if cpu else torch._foreach_sqrt(v)
            torch._foreach_add_(v, self.eps)
            step = torch._foreach_div(torch._foreach_div(m, bc1), v)
            del v
            torch._foreach_copy_(mu, m)
            del m
            if wd:
                torch._foreach_add_(step, torch._foreach_mul([t.float() for t in p], wd))
            torch._foreach_mul_(step, -lr * FlatOptimizer.factor(schedule, self.count))
            torch._foreach_add_(p, step)
        self.count += 1

    def state_dict(self) -> dict:
        return {"kind": type(self).__name__, "count": self.count, "names": list(self.names),
                "state": {"mu": self.mu, "nu": self.nu}}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != type(self).__name__ or state.get("names") != self.names:
            raise KeyError(f"optimizer state of {state.get('kind')!r} over other tensors does "
                           f"not fit this {type(self).__name__}")
        self.count = int(state["count"])
        torch._foreach_copy_(self.mu, state["state"]["mu"])
        torch._foreach_copy_(self.nu, state["state"]["nu"])
