"""The UNet's LoRA adapter in diffusers' safetensors layout, out and back in.

Counterpart of the JAX package's ``checkpoints/lora_safetensors.py::
export_lora_safetensors`` and ``import_lora_safetensors``: the file
``pytorch_lora_weights.safetensors`` that diffusers' ``load_lora_weights``
reads, with keys ``unet.<module>.lora.down.weight`` (rank, in) and
``unet.<module>.lora.up.weight`` (out, rank), fp32. The port's LoRA
parameters already carry diffusers' module names and its (out, in)
layout, so the export is their names with the ``unet.`` prefix. The import
also takes peft's raw keys, ``unet.<module>.lora_A.weight`` (down) and
``lora_B.weight`` (up).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn as nn

from .safetensors_io import load_file, save_file

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


_PEFT = {"down.weight": "lora_A.weight", "up.weight": "lora_B.weight"}  # raw peft names


def import_lora_safetensors(source: Union[str, Mapping[str, torch.Tensor]], unet: nn.Module,
                            prefix: str = "unet.") -> nn.Module:
    """Copy a diffusers-layout LoRA (a safetensors path or a state dict) into
    ``unet``'s adapter, in its dtype and on its device; returns ``unet``.

    Every LoRA parameter of ``unet`` must find its tensor, under the
    diffusers or the raw peft key, with its shape: a site missing from the
    file raises ``KeyError`` and a wrong shape ``ValueError``, as the JAX
    package's import does."""
    sd = load_file(source) if isinstance(source, str) else dict(source)
    lora = {name: p for name, p in unet.named_parameters() if ".lora." in name}
    if not lora:
        raise ValueError("the module has no LoRA parameters")
    with torch.no_grad():
        for name, p in lora.items():
            site, leaf = name.split(".lora.")
            base = prefix + site
            key = next((k for k in (f"{base}.lora.{leaf}", f"{base}.{_PEFT[leaf]}") if k in sd),
                       None)
            if key is None:
                raise KeyError(f"no lora tensor for {base} ({leaf})")
            if tuple(sd[key].shape) != tuple(p.shape):
                raise ValueError(f"lora shape mismatch at {key}: {tuple(sd[key].shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(sd[key])
    return unet
