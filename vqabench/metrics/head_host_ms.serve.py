"""Median host ms of a serving batch's head (the program's span vqa.model.head),
outside the traced batches."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.model.head")
