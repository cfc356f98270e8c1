"""Prodigy (``--optimizer prodigy``): Adam with the step size learned from
the distance travelled (Mishchenko & Defazio, arXiv 2306.06101).

Counterpart of the JAX package's ``train/prodigy.py::prodigy``, with the
knobs ``beta3`` (default sqrt(beta2)), ``decouple`` (AdamW-style decay;
otherwise ``wd * p`` is added to the gradient before the moments),
``use_bias_correction``, ``safeguard_warmup`` and ``d_coef``. The JAX
function's ``d0`` and ``growth_rate`` stay at the defaults the DreamBooth
CLI leaves them at: ``D0`` = 1e-6, and no cap on the growth of d.
State: the distance estimate ``d`` (from ``D0``), the accumulated
numerator, the moments ``m`` (scaled by d) and ``v`` (by d^2), the
accumulated signed step ``s`` and a copy of the initial parameters ``p0``.
Per update, with dlr = d * lr * bc:

    r = beta3 r + (d / D0) dlr <g, p0 - p>       (over every trained tensor)
    s = beta3 s + (d / D0) (d if safeguard_warmup else dlr) g
    d = max(d, d_coef r / ||s||_1)                (where ||s||_1 > 0)
    u = -dlr m / (sqrt(v) + d eps) [- dlr wd p]

A learning-rate schedule multiplies the update only, by ``schedule(k)``
(the JAX DreamBooth CLI's ``optax.scale_by_schedule(s(k) / lr)``); the
internal lr stays fixed. ``d``, the numerator and every moment stay on the
device: an update makes no host sync.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .flat_optim import FlatOptimizer, bias_correction, sqrt_rn

D0 = 1e-6  # the initial distance estimate d


class Prodigy(FlatOptimizer):
    state_names = ("d", "numerator", "m", "v", "s", "p0")

    def __init__(self, params: Dict[str, nn.Parameter], learning_rate: float = 1.0,
                 betas=(0.9, 0.999), beta3: Optional[float] = None, d_coef: float = 1.0,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decouple: bool = True, use_bias_correction: bool = False,
                 safeguard_warmup: bool = False, max_grad_norm: float = 1.0, schedule=None):
        super().__init__([{"params": params, "lr": learning_rate, "weight_decay": weight_decay}],
                         max_grad_norm, schedule)
        self.lr, self.wd = learning_rate, weight_decay
        self.b1, self.b2 = betas
        self.b3 = math.sqrt(self.b2) if beta3 is None else beta3
        self.d_coef, self.eps = d_coef, eps
        self.decouple, self.use_bias_correction = decouple, use_bias_correction
        self.safeguard_warmup = safeguard_warmup
        dev = self.grad_flat.device
        self.d = torch.tensor(D0, dtype=torch.float32, device=dev)
        self.numerator = torch.zeros((), device=dev)
        self.m, self.v, self.s = (torch.zeros(self.numel, device=dev) for _ in range(3))
        torch._foreach_copy_(self._param_views, self.params)
        self.p0 = self.param_flat.clone()

    def update(self, g, p):
        b1, b2, b3 = self.b1, self.b2, self.b3
        if not self.decouple and self.wd:
            g = g + self.wd * p
        k = self.count + 1
        bc = 1.0
        if self.use_bias_correction:  # in fp32, as the JAX package computes it
            bc = float(np.sqrt(np.float32(bias_correction(b2, k)))
                       / np.float32(bias_correction(b1, k)))
        d = self.d
        dlr = d * self.lr * bc
        self.m.mul_(b1).add_((1.0 - b1) * d * g)
        self.v.mul_(b2).add_((1.0 - b2) * d * d * g * g)
        gdot = torch.sum(g * (self.p0 - p))
        self.numerator = b3 * self.numerator + (d / D0) * dlr * gdot
        s_scale = (d / D0) * (d if self.safeguard_warmup else dlr)
        self.s.mul_(b3).add_(s_scale * g)
        l1 = torch.sum(torch.abs(self.s))
        d_hat = torch.where(l1 > 0.0, self.d_coef * self.numerator / torch.clamp_min(l1, 1e-30), d)
        d_new = torch.maximum(d, d_hat)
        u = -dlr * self.m / (sqrt_rn(self.v) + d_new * self.eps)
        if self.decouple and self.wd:
            u = u - dlr * self.wd * p
        self.d = d_new
        f = self.factor(self.schedule, self.count)
        return u * f if f != 1.0 else u
