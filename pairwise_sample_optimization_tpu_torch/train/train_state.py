"""LoRA-only train state, optimizer and learning-rate schedules.

Counterpart of the JAX package's ``train/train_state.py``. The trainable
set is the UNet's LoRA adapter (``*.lora.down.weight`` / ``*.lora.up.weight``,
fp32); every other weight is frozen (``requires_grad=False``).

``make_optimizer`` is optax's ``chain(clip_by_global_norm, adamw)``:
gradients are scaled by ``max_norm / norm`` only when ``norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead),
then ``torch.optim.AdamW`` steps, whose update equals optax's adamw
(decoupled decay on the pre-step weights, eps outside the square root).
The optimizer updates the LoRA parameters in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

LR_SCHEDULES = ("constant", "constant_with_warmup", "linear", "cosine", "cosine_with_restarts",
                "polynomial")


def lora_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The module's LoRA parameters by name, trainable; every other
    parameter of the module is frozen."""
    out = {}
    for name, p in module.named_parameters():
        trainable = ".lora." in name
        p.requires_grad_(trainable)
        if trainable:
            out[name] = p
    return out


def make_lr_schedule(name: str, learning_rate: float, warmup_steps: int = 0,
                     total_steps: int = 0, num_cycles: Optional[float] = None,
                     power: float = 1.0, lr_end: float = 1e-7) -> Callable[[int], float]:
    """The factor f(step) of diffusers' ``get_scheduler`` schedules (the
    learning rate is ``learning_rate * f(step)``), as a ``LambdaLR``
    ``lr_lambda``. Every name except ``constant`` includes the linear
    warmup."""
    if name not in LR_SCHEDULES:
        raise ValueError(f"unknown lr scheduler {name!r}")
    w = max(int(warmup_steps), 0)
    t = max(int(total_steps), w + 1)

    def factor(step: int) -> float:
        if name == "constant":
            return 1.0
        s = float(step)
        warm = min(s / max(w, 1), 1.0) if w else 1.0
        progress = min(max((s - w) / max(t - w, 1), 0.0), 1.0)
        if name == "constant_with_warmup":
            f = 1.0
        elif name == "linear":
            f = 1.0 - progress
        elif name == "cosine":
            cycles = 0.5 if num_cycles is None else float(num_cycles)
            f = max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))
        elif name == "cosine_with_restarts":
            cycles = 1.0 if num_cycles is None else float(num_cycles)
            f = 0.0 if progress >= 1.0 else max(
                0.0, 0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1.0))))
        else:  # polynomial: decay from learning_rate to lr_end
            f = (lr_end / learning_rate if progress >= 1.0 else
                 ((learning_rate - lr_end) * (1.0 - progress) ** power + lr_end) / learning_rate)
        return warm * f

    return factor


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class ClippedAdamW:
    """Global-norm clipping (optax semantics) followed by AdamW, with an
    optional ``LambdaLR`` schedule stepped once per update."""

    def __init__(self, params: Dict[str, nn.Parameter], learning_rate: float, betas, eps: float,
                 weight_decay: float, max_grad_norm: float,
                 schedule: Optional[Callable[[int], float]] = None):
        self.max_grad_norm = max_grad_norm
        self.adamw = torch.optim.AdamW(list(params.values()), lr=learning_rate, betas=betas,
                                       eps=eps, weight_decay=weight_decay)
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
                          if schedule is not None else None)

    def step(self, params: Dict[str, nn.Parameter], grads: Dict[str, torch.Tensor]) -> None:
        norm = global_norm(grads.values())
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        for name, p in params.items():
            p.grad = (grads[name] * clip).to(p.dtype)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params: Dict[str, nn.Parameter], learning_rate: float = 1e-5,
                   beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 1e-6, max_grad_norm: float = 1.0,
                   state_dtype: Optional[str] = None,
                   schedule: Optional[Callable[[int], float]] = None,
                   use_8bit: bool = False) -> ClippedAdamW:
    """AdamW with global-norm clipping (reference hyperparameters).
    ``schedule`` is a factor from :func:`make_lr_schedule`."""
    if use_8bit:
        raise NotImplementedError("8-bit AdamW is not ported yet")
    if state_dtype not in (None, "", "float32"):
        raise NotImplementedError(f"optimizer state dtype {state_dtype!r} is not ported yet; "
                                  "moments are fp32")
    return ClippedAdamW(params, learning_rate, (beta1, beta2), eps, weight_decay, max_grad_norm,
                        schedule)


@dataclasses.dataclass
class PSOTrainState:
    """Update count, the trainable LoRA parameters (by name) and their
    optimizer."""

    step: int
    lora: Dict[str, nn.Parameter]
    tx: ClippedAdamW

    @classmethod
    def create(cls, lora: Dict[str, nn.Parameter], tx: ClippedAdamW) -> "PSOTrainState":
        return cls(step=0, lora=lora, tx=tx)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer step on the LoRA parameters, in place."""
        self.tx.step(self.lora, grads)
        self.step += 1
