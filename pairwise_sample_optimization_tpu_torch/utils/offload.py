"""Frozen weights parked in host memory while the device needs the room.

The online runner's ``offload_aux_during_update`` moves the VAE, the
scorer and both text encoders off the card for the update and back after
it; the eval's ``--offload_scorers`` keeps every scorer on the host but for
its own scoring calls. The counterpart of the JAX package's
``move_to_memory_kind(..., "pinned_host")``.
"""

from __future__ import annotations

import itertools
from typing import Iterable

import torch
import torch.nn as nn


class HostOffload:
    """Moves every parameter and buffer of ``modules`` to host memory
    (pinned, for fast copies back) and back to its device.

    The weights are frozen, so a tensor's host copy is written by its first
    move and kept: a later move to the host only drops the device copy, and
    a move back copies the host one up again. The tensors stay the same
    objects (their ``.data`` is swapped), so whatever holds the modules
    holds them still; once the device copies are dropped nothing refers to
    them, and their memory is free. Tensors already on the CPU stay where
    they are: there the moves are no-ops."""

    def __init__(self, modules: Iterable[nn.Module]):
        self.modules = [m for m in modules if m is not None]
        self.host = {}  # id(tensor) -> its host copy
        self.device = {}  # id(tensor) -> its device

    def _tensors(self):
        seen = set()
        for m in self.modules:
            for t in itertools.chain(m.parameters(), m.buffers()):
                if id(t) not in seen:
                    seen.add(id(t))
                    yield t

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._tensors())

    @torch.no_grad()
    def to_host(self) -> None:
        for t in self._tensors():
            if t.device.type == "cpu":
                continue
            host = self.host.get(id(t))
            if host is None:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                self.host[id(t)] = host
            self.device[id(t)] = t.device
            t.data = host

    @torch.no_grad()
    def to_device(self) -> None:
        for t in self._tensors():
            dev = self.device.pop(id(t), None)
            if dev is not None:
                t.data = t.data.to(dev, non_blocking=True)
