"""Train-state checkpoints with resume: ``<base>/checkpoint-<step>/state.pt``
holds the update count, the trained tensors by name under ``lora`` (the
LoRA adapter, or every UNet weight under full finetuning, as the JAX train
state's ``lora`` field), the optimizer's ``state_dict`` and an extra dict
(the epoch), written with ``torch.save``. The counterpart of the JAX
package's ``checkpoints/orbax_io.py``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

_STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), f"checkpoint-{step}")


def _steps(base_dir: str) -> list[int]:
    if not os.path.isdir(base_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"checkpoint-(\d+)", n) for n in os.listdir(base_dir)) if m)


def save_train_state(base_dir: str, step: int, state, extra: Optional[dict] = None) -> str:
    """Write ``<base>/checkpoint-<step>/state.pt`` (to a temporary name
    first, then renamed). Returns the checkpoint directory."""
    path = _ckpt_dir(base_dir, step)
    os.makedirs(path, exist_ok=True)
    blob = {
        "step": int(state.step),
        "lora": {k: v.detach().cpu() for k, v in state.lora.items()},
        "optimizer": state.tx.state_dict(),
        "extra": dict(extra or {}),
    }
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    return path


def restore_train_state(path: str, state) -> dict:
    """Load a checkpoint directory into the live ``state`` (trained tensors in
    place, optimizer state, step). Returns the saved extra dict."""
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    missing = set(state.lora) ^ set(blob["lora"])
    if missing:
        raise KeyError(f"checkpoint and state disagree on the trained tensors' names "
                       f"(a LoRA state and a whole-UNet one?): {sorted(missing)[:5]}")
    with torch.no_grad():
        for k, p in state.lora.items():
            p.copy_(blob["lora"][k])
    state.tx.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return blob["extra"]


def prune_checkpoints(base_dir: str, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` checkpoint-<step> dirs. Returns
    the removed paths."""
    if keep <= 0:
        return []
    removed = []
    for step in _steps(base_dir)[:-keep]:
        path = _ckpt_dir(base_dir, step)
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def latest_checkpoint(base_dir: str) -> Optional[str]:
    """Newest ``checkpoint-<n>`` under ``base_dir``, or ``base_dir`` itself
    when it is one."""
    if re.search(r"checkpoint-\d+$", base_dir.rstrip("/")):
        return base_dir
    steps = _steps(base_dir)
    return _ckpt_dir(base_dir, steps[-1]) if steps else None
