"""Throughput from host-sync points (port of vqa_tpu/train/profiling.py's
``SyncedRateTracker``).

PyTorch returns from a CUDA step before the card has run it, so a host
clock read right after dispatch measures the enqueue. The tracker is marked
only where a device value was just fetched (the loss, read at each log
interval) and derives steps per second from the (step, time) deltas
between those points.
"""

from __future__ import annotations

import time


class SyncedRateTracker:
    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._last: tuple[int, float] | None = None
        self._rate = 0.0

    def mark(self, step: int) -> None:
        """Call immediately after fetching a device value at ``step``."""
        now = time.perf_counter()
        if self._last is not None:
            dsteps = step - self._last[0]
            dt = now - self._last[1]
            if dsteps > 0 and dt > 0:
                self._rate = dsteps / dt
        self._last = (step, now)

    @property
    def steps_per_sec(self) -> float:
        return self._rate

    @property
    def qa_pairs_per_sec(self) -> float:
        return self._rate * self.batch_size

    def summary(self) -> str:
        return (f"{self.steps_per_sec:.2f} steps/s | "
                f"{self.qa_pairs_per_sec:.0f} QA-pairs/s")
