"""The UNet's LoRA adapter in diffusers' safetensors layout.

Counterpart of the JAX package's ``checkpoints/lora_safetensors.py::
export_lora_safetensors``: the file ``pytorch_lora_weights.safetensors``
that diffusers' ``load_lora_weights`` reads, with keys
``unet.<module>.lora.down.weight`` (rank, in) and
``unet.<module>.lora.up.weight`` (out, rank), fp32. The port's LoRA
parameters already carry diffusers' module names and its (out, in)
layout, so the export is their names with the ``unet.`` prefix.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .safetensors_io import save_file

LORA_FILE = "pytorch_lora_weights.safetensors"


def export_lora_safetensors(unet: nn.Module, path: Optional[str] = None
                            ) -> Dict[str, torch.Tensor]:
    """``unet``'s LoRA parameters -> {diffusers key: contiguous fp32 CPU
    tensor}, also written to ``path`` when given."""
    out = {"unet." + name: p.detach().to("cpu", torch.float32, copy=True).contiguous()
           for name, p in unet.named_parameters() if ".lora." in name}
    if not out:
        raise ValueError("the module has no LoRA parameters")
    if path is not None:
        save_file(out, path)
    return out
