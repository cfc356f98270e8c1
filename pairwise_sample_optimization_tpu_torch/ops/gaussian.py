"""Gaussian transition density shared by the step/logprob functions.

fp32, the realized transition detached, and the MEAN (not sum) over all
non-batch dims: the beta=50 PSO loss is sensitive to each of these.
"""

from __future__ import annotations

import math

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape (B,) -> (B, 1, ..., 1) for broadcasting over sample dims."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def gaussian_logprob_mean(x, mean, std_b):
    """Mean-over-non-batch-dims Gaussian log density; ``std_b`` is
    broadcast-shaped. The gradient flows through ``mean``/``std`` only."""
    ll = (
        -torch.square(x.detach() - mean) / (2.0 * torch.square(std_b))
        - torch.log(std_b)
        - LOG_SQRT_2PI
    )
    return ll.reshape(ll.shape[0], -1).mean(dim=-1)
