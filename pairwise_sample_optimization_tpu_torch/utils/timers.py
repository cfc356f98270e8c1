"""Wall time per named phase (sample / train). A phase on a CUDA device
ends with ``torch.cuda.synchronize()``, so its time covers the device work
it queued. ``totals`` sums each phase's times, ``last`` holds its latest.

``profile_to`` traces a block with ``torch.profiler`` into a Chrome trace
file, as the JAX package's ``profile_to`` traces one with ``jax.profiler``."""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def profile_to(log_dir: Optional[str], device: Optional[torch.device] = None,
               name: str = "trace"):
    """Trace this block when ``log_dir`` is set: the host's operators and,
    on a CUDA ``device``, the card's kernels and copies, written to
    ``<log_dir>/<name>.json`` (Chrome trace format) when the block ends."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
