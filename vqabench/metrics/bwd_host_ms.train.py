"""Median host ms of a train step's backward (the program's span vqa.train.backward),
outside the traced steps."""

from vqabench.metrics import _spans


def read(ctx):
    return _spans.host_ms(ctx, "vqa.train.backward")
