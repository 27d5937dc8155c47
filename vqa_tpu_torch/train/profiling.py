"""Throughput and traces of the training loop (port of
vqa_tpu/train/profiling.py).

:class:`SyncedRateTracker`: PyTorch returns from a CUDA step before the card
has run it, so a host clock read right after dispatch measures the enqueue.
The tracker is marked only where a device value was just fetched (the loss,
read at each log interval) and derives steps per second from the (step,
time) deltas between those points.

:class:`ProfileWindow`: ``--profile_steps N``, a ``torch.profiler`` trace of
N train steps from the first step >= 3 (warm-up excluded), written into the
run directory as a Chrome trace (the host's operations and, on the card,
its kernels and copies): the counterpart of vqa_tpu's ``profile_trace``
around the same window (vqa_tpu/main.py:658-695).
"""

from __future__ import annotations

import os
import time

import torch

PROFILE_START_STEP = 3


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


class ProfileWindow:
    """A trace of ``steps`` train steps; call :meth:`before_step` at the top
    of every step and :meth:`close` when the loop ends. Each returns the
    trace's path when it has just written it, else None."""

    def __init__(self, log_dir: str, steps: int):
        self.log_dir = log_dir
        self.steps = steps
        self._prof = None
        self._span = None
        self.done = steps <= 0

    def before_step(self, step: int) -> str | None:
        if self.done:
            return None
        if self._prof is None:
            if step >= PROFILE_START_STEP:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.start()
                self._span = (step, step + self.steps)
            return None
        return self.close() if step >= self._span[1] else None

    def close(self) -> str | None:
        if self.done or self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.done = True
        path = os.path.join(self.log_dir, f"profile_steps_{self._span[0] + 1}-"
                                          f"{self._span[1]}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        return path
