"""Median host ms of a train step's Adam step (the program's span
vqa.train.optimizer), outside the traced steps."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.train.optimizer")
