"""Train state, optimizers and learning-rate schedules.

Counterpart of the JAX package's ``train/train_state.py``. The trainable
set is the LoRA adapter (``*.lora.down.weight`` / ``*.lora.up.weight`` and
DoRA's ``*.lora.magnitude``, fp32; :func:`lora_parameters`, every other
weight frozen with ``requires_grad=False``) or, under full finetuning,
every weight of the UNet (:func:`all_parameters`).

``make_optimizer`` is optax's ``chain(clip_by_global_norm, adamw)`` over
one group of parameters or several (each with its own learning rate,
weight decay and schedule), every one over flat buffers
(``flat_optim.FlatOptimizer``: gradients scaled by ``max_norm / norm``
only when ``norm >= max_norm``):

- by default ``flat_optim.FlatAdamW`` with fp32 moments;
- ``state_dtype="bfloat16"``: the first moment stored in bf16, optax's
  ``adamw(mu_dtype=bfloat16)``;
- ``use_8bit``: the block-quantized int8-moment AdamW
  (``quantized_adam.Adam8bit``);
- ``per_tensor``: ``foreach_adamw.ForeachAdamW``, the same AdamW on each
  tensor in place, for the whole UNet (no flat copies of its 2.57 G
  elements), or with ``use_8bit`` ``quantized_adam.ForeachAdam8bit``.

``prodigy.Prodigy`` is the DreamBooth CLI's other optimizer. Every one
updates the LoRA parameters in place and has ``state_dict`` /
``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn

from .flat_optim import FlatAdamW, FlatOptimizer
from .foreach_adamw import ForeachAdamW, global_norm
from .quantized_adam import Adam8bit, ForeachAdam8bit

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


def all_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """Every parameter of the module by name, trainable (full finetuning)."""
    return {name: p.requires_grad_(True) for name, p in module.named_parameters()}


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


def param_groups(params: Union[Mapping[str, nn.Parameter], Sequence[dict]],
                 learning_rate: float, weight_decay: float) -> List[dict]:
    """``{name: parameter}`` (one group) or ``[{"params": {...}, "lr": ...,
    "weight_decay": ..., "schedule": ...}, ...]`` -> groups with every key
    set (a group without ``lr`` / ``weight_decay`` takes the given ones; a
    group's ``schedule``, the factor of its learning rate, defaults to
    the optimizer's)."""
    groups = [{"params": params}] if isinstance(params, Mapping) else list(params)
    return [{"params": dict(g["params"]), "lr": g.get("lr", learning_rate),
             "weight_decay": g.get("weight_decay", weight_decay),
             "schedule": g.get("schedule")} for g in groups]


def make_optimizer(params: Union[Mapping[str, nn.Parameter], Sequence[dict]],
                   learning_rate: float = 1e-5, beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 1e-6, max_grad_norm: float = 1.0,
                   state_dtype: Optional[str] = None,
                   schedule: Optional[Callable[[int], float]] = None,
                   use_8bit: bool = False, per_tensor: bool = False):
    """AdamW with global-norm clipping (reference hyperparameters) over
    ``params`` (see :func:`param_groups`). ``schedule`` is a factor from
    :func:`make_lr_schedule`. ``use_8bit`` (first) picks the 8-bit AdamW,
    ``state_dtype="bfloat16"`` bf16 first moments; otherwise fp32 moments.
    ``per_tensor`` updates the tensors in place a chunk at a time
    (``ForeachAdamW``, ``ForeachAdam8bit``: for the whole UNet) instead of
    through flat buffers of all of them."""
    groups = param_groups(params, learning_rate, weight_decay)
    betas = (beta1, beta2)
    if use_8bit:
        return (ForeachAdam8bit if per_tensor else Adam8bit)(groups, betas, eps, max_grad_norm,
                                                             schedule)
    if state_dtype in (None, "", "float32", torch.float32):
        mu_dtype = torch.float32
    elif state_dtype in ("bfloat16", torch.bfloat16):
        mu_dtype = torch.bfloat16
    else:
        raise ValueError(f"optimizer state dtype {state_dtype!r}: use '' (fp32) or 'bfloat16'")
    cls = ForeachAdamW if per_tensor else FlatAdamW
    return cls(groups, betas, eps, max_grad_norm, schedule, mu_dtype=mu_dtype)


@dataclasses.dataclass
class PSOTrainState:
    """Update count, the trainable parameters by name (the LoRA adapter, or
    every UNet weight under full finetuning: the JAX package's ``lora``
    field either way) and their optimizer."""

    step: int
    lora: Dict[str, nn.Parameter]
    tx: Union[FlatOptimizer, ForeachAdamW, ForeachAdam8bit]

    @classmethod
    def create(cls, lora: Dict[str, nn.Parameter], tx) -> "PSOTrainState":
        return cls(step=0, lora=lora, tx=tx)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer step on the trainable parameters, in place."""
        self.tx.step(self.lora, grads)
        self.step += 1
