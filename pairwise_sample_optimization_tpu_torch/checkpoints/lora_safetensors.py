"""LoRA (and DoRA) adapters in diffusers' and kohya-ss's safetensors
layouts, out and back in.

Counterpart of the JAX package's ``checkpoints/lora_safetensors.py``:

- ``export_sdxl_lora_safetensors``: the file ``pytorch_lora_weights.
  safetensors`` that diffusers' ``load_lora_weights`` reads, one file for
  the UNet and the two text encoders (prefixes ``unet.``,
  ``text_encoder.``, ``text_encoder_2.``), with keys
  ``<prefix><module>.lora.down.weight`` (rank, in),
  ``<prefix><module>.lora.up.weight`` (out, rank) and, for DoRA,
  ``<prefix><module>.lora_magnitude_vector`` (out,), fp32. The port's
  modules carry diffusers' and HF's names and the (out, in) layout, so the
  export is their parameter names with the prefix (the magnitude renamed).
  ``export_lora_safetensors`` is the UNet-only file;
- ``export_kohya_lora_safetensors`` (``--output_kohya_format``): the same
  tensors under ``lora_unet_`` / ``lora_te1_`` / ``lora_te2_`` with the
  module's dots turned into ``_``, ``.lora_down.weight`` /
  ``.lora_up.weight``, a 0-d fp32 ``.alpha`` equal to the rank and
  ``.dora_scale`` for magnitudes;
- ``import_lora_safetensors``: the diffusers keys or peft's raw ones
  (``lora_A.weight`` down, ``lora_B.weight`` up,
  ``lora_magnitude_vector.weight``) into a module's adapter.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn as nn

from .safetensors_io import load_file, save_file

LORA_FILE = "pytorch_lora_weights.safetensors"
KOHYA_FILE = "pytorch_lora_weights_kohya.safetensors"
PREFIXES = {"unet": "unet.", "te1": "text_encoder.", "te2": "text_encoder_2."}
_KOHYA_PREFIXES = {"unet.": "lora_unet_", "text_encoder.": "lora_te1_",
                   "text_encoder_2.": "lora_te2_"}
_DIFFUSERS = {"down.weight": "lora.down.weight", "up.weight": "lora.up.weight",
              "magnitude": "lora_magnitude_vector"}
_PEFT = {"down.weight": "lora_A.weight", "up.weight": "lora_B.weight",
         "magnitude": "lora_magnitude_vector.weight"}  # raw peft names
_KOHYA = {"lora.down.weight": "lora_down.weight", "lora.up.weight": "lora_up.weight",
          "lora_magnitude_vector": "dora_scale"}


def _adapter(module) -> Dict[str, nn.Parameter]:
    """The adapter's tensors by name: a module's, or a mapping of them."""
    items = module.items() if isinstance(module, Mapping) else module.named_parameters()
    lora = {name: p for name, p in items if ".lora." in name}
    if not lora:
        raise ValueError("the module has no LoRA parameters")
    return lora


def export_sdxl_lora_safetensors(modules: Mapping[str, nn.Module], path: Optional[str] = None
                                 ) -> Dict[str, torch.Tensor]:
    """``{"unet": ..., "te1": ..., "te2": ...}`` (any of them; a missing or
    None one is left out; each a module or its ``{parameter name: tensor}``,
    such as the whole tensors ``parallel.tp.whole_tensors`` gathers) ->
    {diffusers key: contiguous fp32 CPU tensor}, also written to ``path``
    when given."""
    out = {}
    for which, module in modules.items():
        if module is None:
            continue
        prefix = PREFIXES[which]
        for name, p in _adapter(module).items():
            site, leaf = name.split(".lora.")
            out[f"{prefix}{site}.{_DIFFUSERS[leaf]}"] = p.detach().to(
                "cpu", torch.float32, copy=True).contiguous()
    if path is not None:
        save_file(out, path)
    return out


def export_lora_safetensors(unet, path: Optional[str] = None
                            ) -> Dict[str, torch.Tensor]:
    """The UNet's adapter alone (keys ``unet.<module>.lora...``)."""
    return export_sdxl_lora_safetensors({"unet": unet}, path)


def export_kohya_lora_safetensors(modules: Mapping[str, nn.Module], path: Optional[str] = None
                                  ) -> Dict[str, torch.Tensor]:
    """The diffusers export's tensors in kohya-ss's layout (see the module
    docstring), also written to ``path`` when given."""
    out = {}
    for key, v in export_sdxl_lora_safetensors(modules).items():
        dpfx = next(p for p in sorted(_KOHYA_PREFIXES, key=len, reverse=True)
                    if key.startswith(p))
        rest = key[len(dpfx):]
        dsuf = next(s for s in _KOHYA if rest.endswith("." + s))
        site = _KOHYA_PREFIXES[dpfx] + rest[:-len(dsuf) - 1].replace(".", "_")
        out[f"{site}.{_KOHYA[dsuf]}"] = v
        if dsuf == "lora.down.weight":
            out[f"{site}.alpha"] = torch.tensor(float(v.shape[0]), dtype=torch.float32)
    if path is not None:
        save_file(out, path)
    return out


def import_lora_safetensors(source: Union[str, Mapping[str, torch.Tensor]], module: nn.Module,
                            prefix: str = "unet.") -> nn.Module:
    """Copy a diffusers-layout adapter (a safetensors path or a state dict)
    into ``module``'s (the UNet by default; ``prefix="text_encoder."`` or
    ``"text_encoder_2."`` for a text encoder), in its dtype and on its
    device; returns ``module``.

    Every adapter parameter of ``module`` (DoRA magnitudes too) must find
    its tensor, under the diffusers or the raw peft key, with its shape: a
    site missing from the file raises ``KeyError`` and a wrong shape
    ``ValueError``, as the JAX package's import does."""
    sd = load_file(source) if isinstance(source, str) else dict(source)
    with torch.no_grad():
        for name, p in _adapter(module).items():
            site, leaf = name.split(".lora.")
            base = prefix + site
            key = next((k for k in (f"{base}.{_DIFFUSERS[leaf]}", f"{base}.{_PEFT[leaf]}")
                        if k in sd), None)
            if key is None:
                raise KeyError(f"no lora tensor for {base} ({leaf})")
            if tuple(sd[key].shape) != tuple(p.shape):
                raise ValueError(f"lora shape mismatch at {key}: {tuple(sd[key].shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(sd[key])
    return module
