"""Optimizers that update every trained tensor through one flat buffer.

The DreamBooth and online trainers train ~1.1k LoRA tensors. A loop of
small ops per tensor would cost the host a launch each (the DreamBooth step
is set by the host's launch rate), so these optimizers gather the
gradients and the parameters into flat fp32 buffers
(``torch._foreach_copy_`` onto fixed views), run their update as a few ops
over the whole buffer, and add it back with one ``torch._foreach_add_``.
Each tensor's stretch is padded to a multiple of ``block`` (the 8-bit
AdamW's quantization blocks never straddle two tensors); the padding stays
zero.

``FlatOptimizer`` holds that layout, optax's ``clip_by_global_norm``
(``g / norm * max_norm`` when the norm reaches ``max_norm``), the update
count and the ``state_dict`` plumbing; ``FlatAdamW`` is optax's ``adamw``
with its first moment stored in fp32 or, as optax's ``mu_dtype``, in bf16
(the moment is updated in fp32 from the stored one and stored rounded).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..parallel.tp import is_sharded


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 square root rounded to nearest (as XLA's and CUDA's): the
    CPU's vectorized fp32 ``torch.sqrt`` can be an ulp off, the fp64 root
    rounded to fp32 is not."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


def bias_correction(beta: float, k: int) -> float:
    """1 - beta^k in fp32 arithmetic (as the JAX package computes it), as a
    Python float that fp32 holds exactly."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(k))


class FlatOptimizer:
    """Global-norm clipping, then :meth:`update` on the flat buffers.

    ``groups``: ``[{"params": {name: parameter}, "lr": float,
    "weight_decay": float, "schedule": f or None}, ...]``, laid out one after
    the other (a group's elements are one slice of the buffer). A group's
    ``schedule(k)`` (else ``schedule``) is its learning rate's factor at
    update ``k`` (``train_state.make_lr_schedule``).
    Subclasses name their state buffers in ``state_names`` and implement
    :meth:`update`, which returns the flat update to add to the parameters.
    """

    block = 1
    state_names: Sequence[str] = ()

    def __init__(self, groups: List[dict], max_grad_norm: float,
                 schedule: Optional[Callable[[int], float]] = None):
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.count = 0
        self.names: List[str] = []
        self.params: List[nn.Parameter] = []
        offsets, n = [], 0
        self.group_slices = []  # (start, end, lr, weight_decay, schedule)
        for g in groups:
            start = n
            for name, p in g["params"].items():
                self.names.append(name)
                self.params.append(p)
                offsets.append(n)
                n += p.numel() + (-p.numel() % self.block)
            self.group_slices.append((start, n, float(g["lr"]), float(g["weight_decay"]),
                                      g.get("schedule") or schedule))
        if not self.params:
            raise ValueError("no parameters to optimize")
        dev = self.params[0].device
        self.numel = n
        self.grad_flat = torch.zeros(n, device=dev)
        self.param_flat = torch.zeros(n, device=dev)
        self.update_flat = torch.zeros(n, device=dev)

        self.offsets = offsets
        # tensor-parallel slices among the parameters (``parallel.tp``)
        self.sharded = is_sharded(self.params)
        self._grad_views = self._views(self.grad_flat)
        self._param_views = self._views(self.param_flat)
        self._update_views = self._views(self.update_flat)

    def _views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each tensor's stretch of a flat buffer, in the tensor's shape."""
        return [buf[o:o + p.numel()].view(p.shape) for o, p in zip(self.offsets, self.params)]

    @staticmethod
    def factor(schedule, k: int) -> float:
        return 1.0 if schedule is None else float(schedule(k))

    def group_lrs(self, k: int) -> List[float]:
        """Each group's learning rate at update ``k``: lr * f(k)."""
        return [lr * self.factor(schedule, k) for _, _, lr, _, schedule in self.group_slices]

    def scaled_by_group(self, step: torch.Tensor, p: torch.Tensor, k: int) -> torch.Tensor:
        """-lr * f(k) * (step + wd * p), each group with its own lr, wd and
        schedule f (optax's adamw tail: decoupled decay, then the rate)."""
        out = torch.empty_like(step)
        for (start, end, _, wd, _), lr in zip(self.group_slices, self.group_lrs(k)):
            s = step[start:end]
            if wd:
                s = s + wd * p[start:end]
            torch.mul(s, -lr, out=out[start:end])
        return out

    def update(self, g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, params: Dict[str, nn.Parameter], grads: Dict[str, torch.Tensor]) -> None:
        """One update of ``params`` (the parameters this optimizer was made
        with, by name) from ``grads``, in place."""
        if list(params) != self.names:
            raise KeyError("step() needs the parameters the optimizer was made with, in order")
        torch._foreach_copy_(self._grad_views, [grads[k] for k in self.names])
        torch._foreach_copy_(self._param_views, self.params)
        g = self.grad_flat
        if self.sharded:
            from .foreach_adamw import sharded_global_norm

            norm = sharded_global_norm(self.params, self._grad_views)
        else:
            norm = torch.linalg.vector_norm(g)
        g = torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
        self.update_flat.copy_(self.update(g, self.param_flat))
        torch._foreach_add_(self.params, self._update_views)
        self.count += 1

    def state_dict(self) -> dict:
        return {"kind": type(self).__name__, "count": self.count, "names": list(self.names),
                "state": {k: getattr(self, k) for k in self.state_names}}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != type(self).__name__ or state.get("names") != self.names:
            raise KeyError(f"optimizer state of {state.get('kind')!r} over other tensors does "
                           f"not fit this {type(self).__name__}")
        self.count = int(state["count"])
        for k in self.state_names:
            cur = getattr(self, k)
            if isinstance(cur, torch.Tensor):
                cur.copy_(state["state"][k])
            else:
                setattr(self, k, state["state"][k])


class FlatAdamW(FlatOptimizer):
    """optax ``adamw`` per group (decoupled decay ``lr * wd * p``, eps
    outside the square root, the schedule read at the update count before
    it is incremented), the first moment stored in ``mu_dtype`` (fp32 or
    bf16).

    ``load_state_dict`` also reads the state of a ``torch.optim.AdamW``
    over the same tensors in the same order (``{"adamw": ..., "scheduler":
    ...}``, what the port's train-state checkpoints held before this
    optimizer was its fp32 AdamW): the two keep the same moments and the
    same count, and the schedule follows the count."""

    state_names = ("mu", "nu")

    def __init__(self, groups, betas=(0.9, 0.999), eps: float = 1e-8, max_grad_norm: float = 1.0,
                 schedule=None, mu_dtype: torch.dtype = torch.float32):
        super().__init__(groups, max_grad_norm, schedule)
        self.b1, self.b2 = betas
        self.eps = eps
        self.mu = torch.zeros(self.numel, dtype=mu_dtype, device=self.grad_flat.device)
        self.nu = torch.zeros(self.numel, device=self.grad_flat.device)

    def update(self, g, p):
        b1, b2 = self.b1, self.b2
        k = self.count + 1
        # b1 * mu in the stored dtype, b1 rounded to it first (JAX's weak-typed
        # scalar), then promoted to fp32 beside the gradient's term, as optax's
        b1_stored = float(torch.tensor(b1, dtype=self.mu.dtype))
        mu = (1 - b1) * g + b1_stored * self.mu
        self.nu.mul_(b2).add_((1 - b2) * (g * g))
        step = (mu / bias_correction(b1, k)) / (sqrt_rn(self.nu / bias_correction(b2, k))
                                                + self.eps)
        self.mu.copy_(mu)
        return self.scaled_by_group(step, p, self.count)

    def load_state_dict(self, state: dict) -> None:
        if "adamw" not in state:
            return super().load_state_dict(state)
        adamw = state["adamw"]
        order = [i for g in adamw["param_groups"] for i in g["params"]]
        if len(order) != len(self.params):
            raise KeyError(f"torch.optim.AdamW state over {len(order)} tensors does not fit "
                           f"this FlatAdamW over {len(self.params)}")
        self.mu.zero_()
        self.nu.zero_()
        counts = set()
        for i, mu, nu, p in zip(order, self._views(self.mu), self._views(self.nu), self.params):
            st = adamw["state"].get(i)
            if st is None:
                continue
            if st["exp_avg"].shape != p.shape:
                raise KeyError(f"torch.optim.AdamW state of shape {tuple(st['exp_avg'].shape)} "
                               f"does not fit a tensor of shape {tuple(p.shape)}")
            mu.copy_(st["exp_avg"])
            nu.copy_(st["exp_avg_sq"])
            counts.add(int(st["step"]))
        if len(counts) > 1:
            raise KeyError(f"torch.optim.AdamW state with several step counts {sorted(counts)}")
        self.count = counts.pop() if counts else 0
