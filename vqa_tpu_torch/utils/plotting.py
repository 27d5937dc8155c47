"""Sanity plotting of (image, question, answer) batches (port of
vqa_tpu/utils/plotting.py).

The reference's ``plot_data`` debug helper (utils.py:252-279; its call site
is commented out at main.py:136-138): it renders samples from a loader so a
human can check the pipeline's wiring. It takes the port's dict batches
(``data.pipeline.DataLoader``: uint8 NHWC images as a numpy array or a
pinned CPU tensor, token ids, labels) and can save to files (matplotlib's
``Agg`` backend) instead of ``plt.show()``.
"""

from __future__ import annotations

import os

import numpy as np


def plot_data(dataloader, idx2word: dict, idx2label: dict, num_plots: int = 4,
              save_dir: str | None = None, seed: int = 0):
    """Render ``num_plots`` random samples, one a batch; returns the figures."""
    import matplotlib
    if save_dir is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    figures = []
    for batch in dataloader:
        idx = int(rng.integers(len(batch["label"])))
        img = np.asarray(batch["image"][idx])
        ques = np.asarray(batch["question"][idx])
        label = int(batch["label"][idx])

        ques_str = " ".join(idx2word[int(w)] for w in ques if int(w) != 0)
        fig, ax = plt.subplots()
        ax.imshow(img if img.dtype == np.uint8 else np.clip(img, 0, 1))
        ax.text(0, 0, ques_str, bbox=dict(fill=True, facecolor="white",
                                          edgecolor="red", linewidth=2))
        ax.text(0.95 * img.shape[1], 0.95 * img.shape[0], idx2label[label],
                bbox=dict(fill=True, facecolor="white", edgecolor="blue",
                          linewidth=2), ha="right")
        ax.set_axis_off()
        figures.append(fig)

        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            fig.savefig(os.path.join(save_dir, f"sample_{len(figures) - 1}.png"))
            plt.close(fig)
        else:  # pragma: no cover - interactive path
            plt.show()
        if len(figures) >= num_plots:
            break
    return figures
