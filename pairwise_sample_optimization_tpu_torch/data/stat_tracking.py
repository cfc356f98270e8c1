"""Per-prompt reward statistics -> advantages.

The port's copy of the JAX package's ``data/stat_tracking.py`` (the
reference's DDPO-heritage utility): keep the most recent ``buffer_size``
rewards of each prompt; normalize a batch's rewards by the mean and std of
their prompt's buffer after it took them; a prompt with fewer than
``min_count`` rewards falls back to the batch's own statistics; each std
gets a ``+1e-6`` floor. Statistics are float64; advantages come back in
the caller's dtype. No PSO loss reads it (pairwise preference replaces
advantages); ``configs/sdxl_turbo_dpo.py`` carries its knobs.
"""

from __future__ import annotations

import numpy as np


class _RingBuffer:
    """Fixed-capacity float64 ring holding the most recent values."""

    __slots__ = ("data", "head", "count")

    def __init__(self, capacity: int):
        self.data = np.empty(capacity, dtype=np.float64)
        self.head = 0  # next write slot
        self.count = 0  # values ever written

    def extend(self, values: np.ndarray) -> None:
        cap = self.data.shape[0]
        n = values.shape[0]
        if n >= cap:  # only the newest cap values survive; the phase restarts at 0
            self.data[:] = values[-cap:]
            self.head = 0
        else:
            self.data[(self.head + np.arange(n)) % cap] = values
            self.head = (self.head + n) % cap
        self.count += n

    def valid(self) -> np.ndarray:
        return self.data[: len(self)]

    def __len__(self) -> int:
        return min(self.count, self.data.shape[0])


class PerPromptStatTracker:
    def __init__(self, buffer_size: int = 16, min_count: int = 16):
        self.buffer_size = buffer_size
        self.min_count = min_count
        self.stats: dict[str, _RingBuffer] = {}

    def update(self, prompts, rewards) -> np.ndarray:
        """Each reward's advantage, in the dtype ``rewards`` came in."""
        prompts = np.asarray(prompts)
        rewards_in = np.asarray(rewards)
        rewards = rewards_in.astype(np.float64)
        batch_mean = rewards.mean()
        batch_std = rewards.std() + 1e-6
        advantages = np.empty_like(rewards_in)
        for prompt in np.unique(prompts):
            mask = prompts == prompt
            ring = self.stats.get(prompt)
            if ring is None:
                ring = self.stats[prompt] = _RingBuffer(self.buffer_size)
            ring.extend(rewards[mask])
            if len(ring) < self.min_count:
                mean, std = batch_mean, batch_std
            else:
                window = ring.valid()
                mean, std = window.mean(), window.std() + 1e-6
            advantages[mask] = (rewards[mask] - mean) / std
        return advantages

    def get_stats(self):
        return {k: {"mean": float(v.valid().mean()), "std": float(v.valid().std()),
                    "count": len(v)} for k, v in self.stats.items()}
