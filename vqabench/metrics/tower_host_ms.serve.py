"""Median host ms of a serving batch's tower (the program's span vqa.model.tower),
outside the traced batches."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.model.tower")
