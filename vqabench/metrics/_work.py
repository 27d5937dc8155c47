"""The work a step needs, counted from a configuration's shapes, and the
H100's published peaks (SXM, dense, at its 700 W limit).

Frozen with the benchmark: a change to the program's kernels does not
change what these count. ``vgg_int8_work`` is a copy of the port's rule
for kernels A and B; each model family's reference module
(``reference/<model>.py``) counts the products of its head
(``head_flops``), so a new family brings its own count.
"""

from __future__ import annotations

from ..reference.weights import model_module

HBM_BPS, INT8_OPS, BF16_FLOPS = 3.35e12, 1979e12, 989e12
VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


def vgg_int8_work(batch: int, image_size: int) -> dict:
    """Kernel A's and B's (operations, bytes) a forward of the int8 VGG with
    the fused stem and hand-offs: A reads the quantized x and writes conv1's
    int8 input; B reads its int8 input and writes int8 (the hand-off) or,
    at conv7, bf16."""
    chans = [v for v in VGG11_CFG if v != "M"]
    pools = [i + 1 < len(VGG11_CFG) and VGG11_CFG[i + 1] == "M"
             for i, v in enumerate(VGG11_CFG) if v != "M"]
    h, c = image_size, 3
    work = {"A": [0.0, 0.0], "B": [0.0, 0.0]}
    for i, (o, pool) in enumerate(zip(chans, pools)):
        ho = h // 2 if pool else h
        ops = 2.0 * batch * h * h * c * o * 9
        out_bytes = batch * ho * ho * o * (2 if i == len(chans) - 1 else 1)
        moved = batch * h * h * c + 9 * c * o + 12 * o + out_bytes
        key = "A" if i == 0 else "B"
        work[key][0] += ops
        work[key][1] += moved
        h, c = ho, o
    return {k: tuple(v) for k, v in work.items()}


def ideal_seconds(cfg: dict, batch: int, train: bool) -> float:
    """The least time a step could take at the peaks: the tower's convs at
    the int8 rate, the head's products at the bf16 rate, and in training the
    trained head's backward at twice its forward."""
    work = vgg_int8_work(batch, cfg["image_size"])
    frozen, trained = model_module(cfg["model"]).head_flops(cfg, batch)
    bf16 = frozen + trained * (3 if train else 1)
    return (work["A"][0] + work["B"][0]) / INT8_OPS + bf16 / BF16_FLOPS
