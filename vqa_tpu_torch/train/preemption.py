"""SIGTERM -> checkpoint at the next step boundary (port of
vqa_tpu/train/preemption.py).

Preemptible capacity delivers SIGTERM with a grace window before the kill.
The train loop polls :attr:`PreemptionGuard.triggered` once per step, writes
a full checkpoint (the same artifact as ``--save_interval`` saves) and
exits cleanly, so ``--model_ckpt latest`` resumes exactly through the
loader's intra-epoch resume (``DataLoader.set_epoch(..., skip_batches)``).

- First SIGTERM: set the flag; the loop saves and exits at the next step
  boundary, and skips the epoch-end validation if that comes first.
- Second SIGTERM: restore the default disposition and re-raise, so a
  supervisor can still kill the process if the save hangs.
- The handler acts only in the process that installed it (a forked child
  that inherited it dies as by default).
"""

from __future__ import annotations

import os
import signal


class PreemptionGuard:
    """Polls ``triggered`` once per train step; see the module docstring."""

    def __init__(self):
        self.triggered = False
        self._pid = os.getpid()
        self._prev = None

    def install(self) -> "PreemptionGuard":
        self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        return self

    def uninstall(self) -> None:
        if self._prev is not None and os.getpid() == self._pid:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None

    def _on_sigterm(self, signum, frame):
        if os.getpid() != self._pid or self.triggered:
            # a forked child, or the second SIGTERM: die as by default
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        self.triggered = True
