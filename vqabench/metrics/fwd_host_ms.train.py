"""Median host ms of a train step's forward: the model and the loss (the program's span
vqa.train.forward), outside the traced steps."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.train.forward")
