"""Released scorer weights that ship with the port.

Counterpart of the JAX package's ``checkpoints/scorer_loaders.py::
load_aesthetic_mlp``: the LAION aesthetic predictor's MLP
(``sac+logos+ava1-l14-linearMSE.pth``, a bare ``nn.Sequential`` state dict
with keys ``layers.{0,2,4,6,7}.{weight,bias}``). The port's
``AestheticMLP`` has those keys, so the file loads without a name map.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch


def load_aesthetic_mlp(path_or_sd: Union[str, Mapping[str, torch.Tensor]], mlp):
    """Load the released aesthetic-MLP weights (a ``.pth`` path, read with
    ``torch.load(weights_only=True)``, or a state dict) into ``mlp``
    (``rewards.aesthetic.AestheticMLP``), strictly; returns ``mlp``."""
    sd = (torch.load(path_or_sd, map_location="cpu", weights_only=True)
          if isinstance(path_or_sd, str) else path_or_sd)
    mlp.load_state_dict(sd, strict=True)
    return mlp
