"""Wall time per named phase (sample / train). A phase on a CUDA device
ends with ``torch.cuda.synchronize()``, so its time covers the device work
it queued. ``totals`` sums each phase's times, ``last`` holds its latest."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last[name] = time.perf_counter() - t0
            self.totals[name] += self.last[name]
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}_s": self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.last.clear()
