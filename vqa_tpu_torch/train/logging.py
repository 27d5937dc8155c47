"""Experiment logging: train_log.txt + TensorBoard + stdout (port of
vqa_tpu/train/logging.py).

The reference's three channels, tags and paths (reference main.py:119-122,
242-246, 354-385): scalars ``Train/Loss``, ``Val/Accuracy``, ``Val/Loss``
keyed by step; ``train_log.txt`` opened for append with the full flag dump;
the same console format strings and wall-clock ETA estimator
(main.py:249-255).
"""

from __future__ import annotations

import os
from time import time


def print_and_log(msg: str, log_file) -> None:
    if log_file is not None:
        log_file.write(msg + "\n")
        log_file.flush()
    print(msg)


def setup_logs_file(args_dict: dict, log_dir: str, file_name: str = "train_log.txt",
                    script_name: str = "main.py"):
    """Open train_log.txt (append) and record the run's flags."""
    log_file = open(os.path.join(log_dir, file_name), "a+")
    log_file.write(f"python3 {script_name}\n")
    for key, value in args_dict.items():
        log_file.write(f"--{key} {value}\n")
    log_file.write("\n\n")
    log_file.flush()
    return log_file


class _NullWriter:
    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def make_summary_writer(log_dir: str):
    """TensorBoard writer (tensorboardX, as the reference uses), or a no-op
    writer when tensorboardX is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(log_dir)


class ETAEstimator:
    """Elapsed/remaining-hours estimate (reference math, main.py:249-255),
    measured from ``start_step`` so a resumed run's rate is its own."""

    def __init__(self, steps_per_epoch: int, n_epochs: int, start_step: int = 0):
        self.start = time()
        self.steps_per_epoch = steps_per_epoch
        self.n_epochs = n_epochs
        self.start_step = start_step

    def __call__(self, curr_step: int) -> tuple[float, float]:
        elapsed = (time() - self.start) / 3600.0
        done = max(curr_step - self.start_step, 1)
        remaining_steps = max(
            self.steps_per_epoch * self.n_epochs - (curr_step - self.start_step), 0)
        return elapsed, (elapsed / done) * remaining_steps
