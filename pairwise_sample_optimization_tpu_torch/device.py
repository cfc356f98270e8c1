"""Device resolution shared by every entry point."""

from __future__ import annotations

import os

import torch

from .parallel.multihost import local_rank


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks.
    Under a launcher that sets ``LOCAL_RANK`` (torchrun), ``"cuda"`` is the
    process's own card, ``cuda:LOCAL_RANK``.

    Raises when a CUDA device is asked for and none is available: the port
    never drops to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", local_rank())
    return dev
